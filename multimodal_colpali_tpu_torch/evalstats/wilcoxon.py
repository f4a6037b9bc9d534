"""Paired Wilcoxon signed-rank tests across augmentation strategies.

Counterpart of ``multimodal_colpali_tpu/evalstats/wilcoxon.py``.

Python port of the capability in the reference's R script
(02a_stat_test.R:1-96): per generator model, compare each pair of RAG
augmentations over the same MCQ items (paired by Question_nr), with optional
Bonferroni correction.
"""

from __future__ import annotations

import itertools
from typing import List, Optional

import numpy as np
import pandas as pd
from scipy import stats


def paired_wilcoxon_table(
    df: pd.DataFrame,
    model_col: str = "Model",
    group_col: str = "Model_ret",
    item_col: str = "Question_nr",
    value_col: str = "Cor_answer",
    bonferroni: bool = True,
) -> pd.DataFrame:
    """For each model, Wilcoxon signed-rank over every augmentation pair.

    Items are paired on ``item_col`` (mean over iterations first, so repeated
    runs collapse to one paired value per question, as the R script does with
    its per-question aggregation).
    """
    rows: List[dict] = []
    for model, sub in df.groupby(model_col, observed=True):
        per_item = (
            sub.groupby([group_col, item_col], observed=True)[value_col]
            .mean()
            .unstack(level=0)
        )
        groups = [g for g in per_item.columns]
        pairs = list(itertools.combinations(groups, 2))
        n_tests = max(len(pairs), 1)
        for a, b in pairs:
            paired = per_item[[a, b]].dropna()
            x, y = paired[a].to_numpy(), paired[b].to_numpy()
            if len(x) == 0 or np.allclose(x, y):
                stat, p = np.nan, 1.0
            else:
                try:
                    # Match R's wilcox.test(paired=TRUE, exact=FALSE): the
                    # normal approximation WITH continuity correction
                    # (02a_stat_test.R:70-89). scipy's defaults (exact test
                    # for small n, no correction) would deviate.
                    stat, p = stats.wilcoxon(
                        x, y, zero_method="wilcox", correction=True,
                        method="approx",
                    )
                except ValueError:
                    stat, p = np.nan, 1.0
            rows.append({
                model_col: model,
                "group_a": a,
                "group_b": b,
                "n_items": len(x),
                "mean_a": float(np.mean(x)) if len(x) else np.nan,
                "mean_b": float(np.mean(y)) if len(y) else np.nan,
                "statistic": stat,
                "p_value": p,
                "p_bonferroni": min(p * n_tests, 1.0) if bonferroni else p,
                "significant_0.05": (min(p * n_tests, 1.0) if bonferroni else p) < 0.05,
            })
    return pd.DataFrame(rows)
