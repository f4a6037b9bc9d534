"""Aggregate Experiment-02 CSVs: accuracy + gold-paper hit-rate summaries.

Behavior parity with the reference aggregator (06_experiment02_eval.py:17-167):
same hit-rate definition (``is_paper_id_in_context``), same difficulty-pivot
``mean (SD=std)`` cells, Excel workbook (or CSVs) with the same sheets.

Counterpart of ``drivers/06_experiment02_eval.py``:
``python -m multimodal_colpali_tpu_torch.drivers.experiment02_eval``.
"""

from __future__ import annotations

import argparse
import ast
import glob
from pathlib import Path

import numpy as np
import pandas as pd

from multimodal_colpali_tpu_torch.utils.io import write_table


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Aggregate Experiment 02 evaluation CSVs.")
    p.add_argument("--results_dir", default="results/evals")
    p.add_argument("--output", default="results/summary.xlsx")
    p.add_argument("--models", nargs="+", default=["gpt-5", "gpt-5-mini", "gpt-5-nano"])
    p.add_argument("--retrievers", nargs="+", default=[
        "vidore/colpali-v1.3-merged",
        "vidore/colqwen2.5-v0.2",
        "ahmed-masry/ColFlor",
    ])
    return p.parse_args(argv)


def load_results(results_dir: str) -> pd.DataFrame:
    frames = []
    for f in sorted(glob.glob(str(Path(results_dir) / "eval_*.csv"))):
        df = pd.read_csv(f)
        if not df.empty:
            frames.append(df)
    if not frames:
        raise SystemExit(f"no eval CSVs found in {results_dir}")
    return pd.concat(frames, ignore_index=True)


def parse_context_presence(row: pd.Series) -> float:
    """1.0 if the gold paper appears among retrieved refs
    (reference 06:72-91)."""
    paper_id_str = str(row.get("Paper_id", ""))
    if not paper_id_str.lower().startswith("paper"):
        return np.nan
    context = row.get("Context_papers")
    if not isinstance(context, str) or not context.startswith("["):
        return 0.0
    try:
        context_list = ast.literal_eval(context)
    except (ValueError, SyntaxError):
        return 0.0
    seed = paper_id_str.lower()
    return 1.0 if any(str(i).split("_pg_")[0].lower() == seed for i in context_list) else 0.0


def _sd_cell(mean: pd.Series, std: pd.Series) -> pd.Series:
    return mean.astype(str) + " (SD=" + std.astype(str) + ")"


def build_summary_table(df: pd.DataFrame, models, retrievers):
    df = df.copy()
    df["Model"] = pd.Categorical(df["Model"], categories=models, ordered=True)
    df["Model_ret"] = pd.Categorical(df["Model_ret"], categories=retrievers, ordered=True)
    df["Difficulty"] = pd.Categorical(df["Difficulty"],
                                      categories=["Easy", "Medium", "Hard"], ordered=True)
    df["is_paper_id_in_context"] = df.apply(parse_context_presence, axis=1)

    agg = df.groupby(["Model", "Model_ret", "Difficulty"], observed=True).agg(
        mean_cor=("Cor_answer", "mean"), std_cor=("Cor_answer", "std"),
        mean_hit=("is_paper_id_in_context", "mean"),
        std_hit=("is_paper_id_in_context", "std"),
    ).round(3)
    agg["Cor_answer"] = _sd_cell(agg["mean_cor"], agg["std_cor"])
    agg["is_paper_id_in_context"] = _sd_cell(agg["mean_hit"], agg["std_hit"])
    diff_summary = agg[["Cor_answer", "is_paper_id_in_context"]].unstack("Difficulty")
    diff_summary.columns = [f"{m}_{d}" for m, d in diff_summary.columns]

    simple = df.groupby(["Model", "Model_ret"], observed=True).agg(
        mean_cor=("Cor_answer", "mean"), std_cor=("Cor_answer", "std"),
        mean_hit=("is_paper_id_in_context", "mean"),
        std_hit=("is_paper_id_in_context", "std"),
    ).round(3)
    simple["Cor_answer_summary"] = _sd_cell(simple["mean_cor"], simple["std_cor"])
    simple["is_paper_id_in_context_summary"] = _sd_cell(simple["mean_hit"], simple["std_hit"])

    final = diff_summary.merge(
        simple[["Cor_answer_summary", "is_paper_id_in_context_summary"]],
        left_index=True, right_index=True,
    )
    return final, df


def main(argv=None) -> None:
    args = parse_args(argv)
    df = load_results(args.results_dir)
    summary, enriched = build_summary_table(df, args.models, args.retrievers)
    out = write_table(summary.reset_index(), args.output)
    full_out = write_table(enriched, str(Path(args.output).with_name("summary_full.xlsx")))
    print(f"[done] Summary saved to {out}")
    print(f"[done] Enriched rows saved to {full_out}")


if __name__ == "__main__":
    main()
