"""Tabular IO with Excel->CSV fallback (counterpart of
``multimodal_colpali_tpu/utils/io.py``; pandas, so not for the GPU host).

The reference reads/writes .xlsx benchmark and result files, which need
openpyxl: read_table accepts .xlsx (if an engine exists) or .csv with
the same stem; write_table writes .xlsx when possible, else the same path
with .csv and a notice. Driver CLIs stay byte-compatible when the engine is
present.
"""

from __future__ import annotations

import os
from pathlib import Path

import pandas as pd


def _excel_available() -> bool:
    try:
        import openpyxl  # noqa: F401
        return True
    except ImportError:
        return False


def read_table(path: str) -> pd.DataFrame:
    p = Path(path)
    if p.suffix.lower() in (".xlsx", ".xls"):
        if p.exists() and _excel_available():
            return pd.read_excel(p)
        csv_alt = p.with_suffix(".csv")
        if csv_alt.exists():
            return pd.read_csv(csv_alt)
        if p.exists():
            raise RuntimeError(
                f"{p} is Excel but no Excel engine is installed and {csv_alt} does not exist"
            )
        raise FileNotFoundError(path)
    return pd.read_csv(p)


def write_table(df: pd.DataFrame, path: str, index: bool = False) -> str:
    """Write df; returns the actual path used."""
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    if p.suffix.lower() in (".xlsx", ".xls") and _excel_available():
        df.to_excel(p, index=index)
        return str(p)
    out = p.with_suffix(".csv")
    df.to_csv(out, index=index)
    if p.suffix.lower() in (".xlsx", ".xls"):
        print(f"[io] no Excel engine; wrote {out} instead of {p}")
    return str(out)
