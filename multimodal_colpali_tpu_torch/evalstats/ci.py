"""Confidence-interval primitives (scipy-backed; no statsmodels dependency).

Counterpart of ``multimodal_colpali_tpu/evalstats/ci.py``.

Behavior parity with the reference's CI helpers (functions.py:1993-2022):
Agresti-Coull interval for proportions, two-sided t interval for means with
optional non-negative clipping, and the ``"mean\\n[lo, up]"`` cell format.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import pandas as pd
from scipy import stats


def agresti_coull_interval(count: float, nobs: float, alpha: float = 0.05) -> Tuple[float, float]:
    """Agresti-Coull CI: p~ = (x + z^2/2) / (n + z^2), p~ +/- z*sqrt(p~(1-p~)/(n+z^2))."""
    if nobs <= 0:
        return (np.nan, np.nan)
    z = stats.norm.ppf(1 - alpha / 2)
    n_tilde = nobs + z * z
    p_tilde = (count + z * z / 2.0) / n_tilde
    half = z * math.sqrt(max(p_tilde * (1 - p_tilde) / n_tilde, 0.0))
    return (p_tilde - half, p_tilde + half)


def proportion_ci(series: pd.Series) -> Tuple[float, float]:
    count = series.sum()
    nobs = series.count()
    if nobs == 0:
        return (np.nan, np.nan)
    return agresti_coull_interval(float(count), float(nobs))


def mean_confidence_interval(series: pd.Series, non_negative: bool = False,
                             alpha: float = 0.05) -> Tuple[float, float]:
    """Two-sided t CI of the mean (matches DescrStatsW.tconfint_mean)."""
    x = series.dropna().to_numpy(dtype=float)
    if x.size < 2:
        return (np.nan, np.nan)
    mean = x.mean()
    sem = x.std(ddof=1) / math.sqrt(x.size)
    tcrit = stats.t.ppf(1 - alpha / 2, df=x.size - 1)
    lo, up = mean - tcrit * sem, mean + tcrit * sem
    if non_negative:
        lo = max(0.0, lo)
    return (lo, up)


def format_ci_cell(mean_val, low_val, upp_val, decimals: int = 3) -> str:
    if pd.isna(mean_val) or pd.isna(low_val) or pd.isna(upp_val):
        return "N/A"
    low_val = max(0, low_val)
    fmt = f"{{:.{decimals}f}}"
    return f"{fmt.format(mean_val)}\n[{fmt.format(low_val)}, {fmt.format(upp_val)}]"
