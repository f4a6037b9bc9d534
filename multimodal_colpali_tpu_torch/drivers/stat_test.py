"""Paired Wilcoxon signed-rank tests across RAG augmentations.

Python CLI equivalent of the reference's R script (02a_stat_test.R:1-96):
per generator model, compare every augmentation pair over the same MCQ items
with Bonferroni correction. Input: the merged evaluation table produced by
driver 04 (eval_full_results) or a directory of exp-02 CSVs.

Counterpart of ``drivers/02a_stat_test.py``:
``python -m multimodal_colpali_tpu_torch.drivers.stat_test``.
"""

from __future__ import annotations

import argparse
from pathlib import Path

from multimodal_colpali_tpu_torch.evalstats import merge_data, paired_wilcoxon_table
from multimodal_colpali_tpu_torch.utils.io import read_table, write_table


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Paired Wilcoxon tests across augmentations.")
    p.add_argument("--input", required=True,
                   help="Merged eval table (csv/xlsx) or a directory of eval CSVs.")
    p.add_argument("--output", default="results/stat_tests.xlsx")
    p.add_argument("--model-col", default="Model")
    p.add_argument("--group-col", default="Model_ret",
                   help="Augmentation column (e.g. Model_ret or vd_name).")
    p.add_argument("--item-col", default="Question_nr")
    p.add_argument("--value-col", default="Cor_answer")
    p.add_argument("--no-bonferroni", action="store_true")
    return p.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    path = Path(args.input)
    df = merge_data(str(path) + "/") if path.is_dir() else read_table(str(path))
    if df.empty:
        raise SystemExit(f"no data found at {args.input}")
    table = paired_wilcoxon_table(
        df, model_col=args.model_col, group_col=args.group_col,
        item_col=args.item_col, value_col=args.value_col,
        bonferroni=not args.no_bonferroni,
    )
    out = write_table(table, args.output)
    print(table.to_string(index=False))
    print(f"[done] Wilcoxon table saved to {out}")


if __name__ == "__main__":
    main()
