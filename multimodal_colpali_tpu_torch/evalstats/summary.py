"""Evaluation aggregation: per-question metrics, two-stage CI summaries.

Counterpart of ``multimodal_colpali_tpu/evalstats/summary.py``.

Behavior parity with the reference's analysis stack
(functions.py:1957-2428): throughput/cost/P@k column derivation,
``merge_data`` iteration counting, ``create_summary_table`` (per-question ->
per-group), ``run_analysis`` (per-iteration -> across iterations), and
``run_ci_summary`` returning (per_iteration_display, summary_table,
merged_df) with the formatted ``"mean\\n[lo, up]"`` cells.
"""

from __future__ import annotations

import ast
import glob
from typing import Dict, List, Optional, Sequence

import numpy as np
import pandas as pd

from multimodal_colpali_tpu_torch.config import DEFAULT_PRICE_DICT, DEFAULT_PRICES_GPT  # noqa: F401
from multimodal_colpali_tpu_torch.evalstats.ci import (
    format_ci_cell,
    mean_confidence_interval,
    proportion_ci,
)


def get_metric_descriptions(top_k: int) -> Dict[str, str]:
    precision_label = f"P@{top_k}"
    return {
        "Cor_answer": "Average correctness rate per question",
        "Elapsed": "Average wall-clock time per question (seconds)",
        "Total_tokens": "Average total tokens consumed per question",
        precision_label: f"Precision@{top_k}: share of retrieved documents containing the reference paper",
        "Throughput": "Average tokens processed per second",
        "Cost": "USD spent per iteration/run",
        "Price-per-cost": "Cents spent per correct answer",
    }


METRIC_DESCRIPTIONS = get_metric_descriptions(5)


# -- per-row metric derivations ---------------------------------------------

def calculate_throughput(df: pd.DataFrame) -> pd.Series:
    return df["Total_tokens"] / df["Elapsed"]


def calculate_precision_at_k(row: pd.Series, top_k: int = 10) -> float:
    """Share of retrieved refs whose ``{paper}_pg_{page}`` prefix matches the
    gold Paper_id (reference functions.py:2119-2137)."""
    paper_id_val = str(row["Paper_id"])
    if not paper_id_val.startswith("Paper"):
        return np.nan
    paper_id = paper_id_val.lower()
    context_papers = row["Context_papers"]
    if pd.isna(context_papers) or not isinstance(context_papers, str) or not context_papers.startswith("["):
        return 0
    try:
        refs = ast.literal_eval(context_papers)
    except (ValueError, SyntaxError):
        return 0
    hits = sum(1 for el in refs if paper_id == str(el).split("_pg_")[0].lower())
    return hits / top_k


def calculate_is_paper_id_in_context(row: pd.Series, top_k: int = 10) -> float:
    return calculate_precision_at_k(row, top_k=top_k)


def calculate_cost(df: pd.DataFrame, price_dict: Dict[str, float]) -> pd.Series:
    def one(row):
        price = price_dict.get(row["Model"])
        return (row["Total_tokens"] / 1_000_000) * price if price is not None else np.nan
    return df.apply(one, axis=1)


calculate_latency = calculate_throughput  # reference alias (functions.py:2115)
calculate_price = calculate_cost          # reference alias (functions.py:2152)


# -- merging ------------------------------------------------------------------

def merge_data(path: str) -> pd.DataFrame:
    """Concat eval CSVs; per (Model, Model_ret) pair, files are numbered as
    Iterations in glob order (reference functions.py:2227-2247)."""
    dfs = []
    counts: Dict[tuple, int] = {}
    for f in glob.glob(path + "*.csv"):
        df = pd.read_csv(f)
        if df.empty:
            continue
        combo = (df["Model"].iloc[0], df["Model_ret"].iloc[0])
        counts[combo] = counts.get(combo, 0) + 1
        df["Iteration"] = counts[combo]
        dfs.append(df)
    if not dfs:
        return pd.DataFrame()
    return pd.concat(dfs, ignore_index=True)


def _order_categorical(df: pd.DataFrame, col: str, order: Optional[Sequence[str]]) -> None:
    if col not in df.columns:
        return
    cats = list(order) if order else sorted(df[col].unique())
    df[col] = pd.Categorical(df[col], categories=cats, ordered=True)


# -- two-step summaries ---------------------------------------------------------

def create_summary_table(
    df: pd.DataFrame,
    group_by: List[str],
    analysis_vars: Dict[str, str],
    price_dict: Optional[Dict[str, float]] = None,
    return_numeric: bool = False,
) -> pd.DataFrame:
    """Per-question then per-group aggregation with CI columns
    (reference functions.py:2157-2225)."""
    work = df.copy()
    for var in analysis_vars:
        if var not in work.columns:
            if var == "Latency":
                work["Latency"] = calculate_latency(work)
            elif var == "is_paper_id_in_context":
                work["is_paper_id_in_context"] = work.apply(
                    calculate_is_paper_id_in_context, axis=1
                )
            elif var == "Price" and price_dict:
                work["Price"] = calculate_price(work, price_dict)

    per_q_cols = group_by + ["Question_nr"]
    vars_list = list(analysis_vars)
    per_q = (
        work[list(dict.fromkeys(per_q_cols + vars_list))]
        .groupby(per_q_cols, observed=True)
        .agg({v: "mean" for v in vars_list})
        .reset_index()
    )

    agg_funcs = {}
    for var, agg_type in analysis_vars.items():
        non_neg = var in ("Latency", "Price")
        agg_funcs[f"mean_{var}"] = (var, "mean")
        if agg_type == "proportion":
            agg_funcs[f"ci_{var}"] = (var, proportion_ci)
        else:
            agg_funcs[f"ci_{var}"] = (
                var, lambda s, nn=non_neg: mean_confidence_interval(s, non_negative=nn)
            )
    out = per_q.groupby(group_by, observed=True).agg(**agg_funcs)

    for var in vars_list:
        out[f"ci_low_{var}"], out[f"ci_upp_{var}"] = zip(*out[f"ci_{var}"])
    if return_numeric:
        return out.drop(columns=[f"ci_{v}" for v in vars_list])

    for var in vars_list:
        out[var] = (
            out[f"mean_{var}"].round(3).astype(str)
            + " [" + out[f"ci_low_{var}"].round(3).astype(str)
            + "-" + out[f"ci_upp_{var}"].round(3).astype(str) + "]"
        )
        out = out.drop(columns=[f"mean_{var}", f"ci_{var}", f"ci_low_{var}", f"ci_upp_{var}"])
    return out


def run_analysis(path, group_by_cols, analysis_vars_dict, price_dict):
    """Two-stage iteration analysis (reference functions.py:2249-2303)."""
    merged = merge_data(path)
    if merged.empty:
        print("No data found in path:", path)
        return pd.DataFrame(), pd.DataFrame()
    _order_categorical(merged, "Model", None)
    _order_categorical(merged, "Model_ret", None)

    stage1 = create_summary_table(
        merged, group_by_cols + ["Iteration"], analysis_vars_dict, price_dict,
        return_numeric=True,
    )

    agg_funcs = {}
    for var in analysis_vars_dict:
        non_neg = var in ("Latency", "Price")
        agg_funcs[f"mean_{var}"] = (f"mean_{var}", "mean")
        agg_funcs[f"ci_{var}"] = (
            f"mean_{var}", lambda s, nn=non_neg: mean_confidence_interval(s, non_negative=nn)
        )
    stage2 = stage1.groupby(group_by_cols, observed=True).agg(**agg_funcs)
    for var in analysis_vars_dict:
        stage2[f"ci_low_{var}"], stage2[f"ci_upp_{var}"] = zip(*stage2[f"ci_{var}"])
        stage2[var] = (
            stage2[f"mean_{var}"].round(3).astype(str)
            + " [" + stage2[f"ci_low_{var}"].round(3).astype(str)
            + "-" + stage2[f"ci_upp_{var}"].round(3).astype(str) + "]"
        )
        stage2 = stage2.drop(columns=[f"mean_{var}", f"ci_{var}", f"ci_low_{var}", f"ci_upp_{var}"])

    stage1_fmt = stage1.copy()
    for var in analysis_vars_dict:
        stage1_fmt[var] = (
            stage1[f"mean_{var}"].round(3).astype(str)
            + " [" + stage1[f"ci_low_{var}"].round(3).astype(str)
            + "-" + stage1[f"ci_upp_{var}"].round(3).astype(str) + "]"
        )
        stage1_fmt = stage1_fmt.drop(columns=[f"mean_{var}", f"ci_low_{var}", f"ci_upp_{var}"])
    return stage1_fmt, stage2


# -- headline CI summary --------------------------------------------------------

def build_ci_metric_specs(precision_label: str) -> List[dict]:
    return [
        dict(display="Cor_answer", source_col="mean_cor_answer",
             mean_col="mean_cor_answer", ci_col="ci_cor_answer",
             ci_func=proportion_ci, decimals=3),
        dict(display="Elapsed", source_col="mean_elapsed",
             mean_col="mean_elapsed", ci_col="ci_elapsed",
             ci_func=mean_confidence_interval, decimals=2),
        dict(display="Total_tokens", source_col="mean_tokens",
             mean_col="mean_tokens", ci_col="ci_tokens",
             ci_func=mean_confidence_interval, decimals=1),
        dict(display=precision_label, source_col="mean_precision",
             mean_col="mean_precision", ci_col="ci_precision",
             ci_func=mean_confidence_interval, decimals=3),
        dict(display="Throughput", source_col="mean_throughput",
             mean_col="mean_throughput", ci_col="ci_mean_throughput",
             ci_func=lambda s: mean_confidence_interval(s, non_negative=True),
             decimals=1),
        dict(display="Cost", source_col="sum_cost",
             mean_col="mean_sum_cost", ci_col="ci_mean_sum_cost",
             ci_func=lambda s: mean_confidence_interval(s, non_negative=True),
             decimals=2),
        dict(display="Price-per-cost", source_col="price_per_cost",
             mean_col="mean_price_per_cost", ci_col="ci_mean_price_per_cost",
             ci_func=lambda s: mean_confidence_interval(s, non_negative=True),
             decimals=2),
    ]


def run_ci_summary(
    path: str,
    group_by_cols: List[str],
    price_dict: Optional[Dict[str, float]] = None,
    top_k: int = 10,
    model_order: Optional[Sequence[str]] = None,
    retriever_order: Optional[Sequence[str]] = None,
    dataframe: Optional[pd.DataFrame] = None,
    precision_label: Optional[str] = None,
):
    """(per_iteration_display, summary_table, merged_df) - reference
    functions.py:2305-2427."""
    price_dict = price_dict or DEFAULT_PRICE_DICT
    if not group_by_cols:
        raise ValueError("group_by_cols must contain at least one column.")
    precision_label = precision_label or f"P@{top_k}"
    specs = build_ci_metric_specs(precision_label)

    merged = dataframe.copy() if dataframe is not None else merge_data(path)
    if merged.empty:
        return pd.DataFrame(), pd.DataFrame(), merged
    if "Iteration" not in merged.columns:
        raise ValueError("Merged evaluations must include an 'Iteration' column.")

    _order_categorical(merged, "Model", model_order)
    _order_categorical(merged, "Model_ret", retriever_order)

    merged["Throughput"] = calculate_throughput(merged)
    merged["Cost"] = calculate_cost(merged, price_dict)
    merged[precision_label] = merged.apply(
        lambda row: calculate_precision_at_k(row, top_k=top_k), axis=1
    )

    iter_cols = list(dict.fromkeys(group_by_cols + ["Iteration"]))
    per_iter = merged.groupby(iter_cols, observed=True).agg(
        mean_cor_answer=("Cor_answer", "mean"),
        mean_elapsed=("Elapsed", "mean"),
        mean_tokens=("Total_tokens", "mean"),
        mean_precision=(precision_label, "mean"),
        mean_throughput=("Throughput", "mean"),
        sum_cost=("Cost", "sum"),
        sum_cor_answ=("Cor_answer", "sum"),
    )
    per_iter["price_per_cost"] = np.where(
        per_iter["sum_cor_answ"] > 0,
        per_iter["sum_cost"] * 100 / per_iter["sum_cor_answ"],
        np.nan,
    )
    per_iter = per_iter.reset_index()

    agg_funcs = {}
    for spec in specs:
        agg_funcs[spec["mean_col"]] = (spec["source_col"], "mean")
        agg_funcs[spec["ci_col"]] = (spec["source_col"], spec["ci_func"])
    table = per_iter.groupby(group_by_cols, observed=True).agg(**agg_funcs).reset_index()

    for spec in specs:
        lo_col, up_col = f"ci_low_{spec['display']}", f"ci_upp_{spec['display']}"
        if table.empty:
            table[lo_col] = np.nan
            table[up_col] = np.nan
            table[spec["display"]] = pd.Series(dtype=object)
        else:
            bounds = table[spec["ci_col"]].apply(
                lambda v: v if isinstance(v, tuple) and len(v) == 2 else (np.nan, np.nan)
            )
            table[lo_col] = bounds.apply(lambda v: v[0])
            table[up_col] = bounds.apply(lambda v: v[1])
            table[spec["display"]] = table.apply(
                lambda row, m=spec["mean_col"], lo=lo_col, up=up_col,
                dec=spec["decimals"]: format_ci_cell(row[m], row[lo], row[up], decimals=dec),
                axis=1,
            )
        table = table.drop(columns=[
            c for c in (spec["ci_col"], spec["mean_col"], lo_col, up_col)
            if c in table.columns
        ])

    per_iter_display = per_iter.rename(columns={
        "mean_cor_answer": "Cor_answer",
        "mean_elapsed": "Elapsed",
        "mean_tokens": "Total_tokens",
        "mean_precision": precision_label,
        "mean_throughput": "Throughput",
        "sum_cost": "Cost",
        "sum_cor_answ": "Correct_answers",
        "price_per_cost": "Price-per-cost",
    })
    return per_iter_display, table, merged
