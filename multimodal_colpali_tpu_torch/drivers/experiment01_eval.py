"""Experiment-01 aggregator: merge eval pickles, score, pivot, majority-vote.

Output-schema parity with the reference aggregator
(reference 04_experiment01_eval.py:20-193). The compat surface — and only
it — is kept identical: the filename regex fields, the merged-frame column
set and order, ``Cor_answer = answer == Correct``, the Easy/Medium/Hard
difficulty pivot, the ``>= ceil(n/2)`` majority vote, and the three output
tables (Excel when an engine exists, CSV fallback otherwise, via utils.io).

Behavioral deviation (intentional fix): the vd_name group in the filename
regex is non-greedy. The reference's greedy ``.+`` swallows the ``_no`` of
``no_perm`` ("colpali_no_perm" -> vd_name "colpali_no"), which NaNs the
vd_name categorical downstream and silently drops every non-permuted run
from the summaries.

Counterpart of ``drivers/04_experiment01_eval.py``:
``python -m multimodal_colpali_tpu_torch.drivers.experiment01_eval``.
"""

from __future__ import annotations

import argparse
import pickle
import re
from pathlib import Path
from typing import Iterator, Optional, Tuple

import numpy as np
import pandas as pd

from multimodal_colpali_tpu_torch.utils.io import read_table, write_table

RUN_STEM = re.compile(
    r"eval_(?P<model_short>[^_]+)_(?P<vd_name>.+?)_(?P<perm_flag>perm|no_perm)"
    r"_benchmark_(?P<timestamp>\d{8}-\d{6})$"
)
RAG_MODE_ORDER = ["no_RAG", "text_RAG", "mm_RAG", "colpali"]
DIFFICULTY_ORDER = ["Easy", "Medium", "Hard"]
RUN_KEY = ["model_short", "model", "vd_name", "permuted_answers"]


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Summarise Experiment 01 evaluation pickles.")
    p.add_argument("--eval-dir", default="results/eval")
    p.add_argument("--benchmark-path", default="./data/Glycans_q_a_v5.xlsx")
    p.add_argument("--summary-path", default="results/eval_results.xlsx")
    p.add_argument("--majority-path", default="results/eval_maj_results.xlsx")
    p.add_argument("--full-path", default="results/eval_full_results.xlsx")
    return p.parse_args(argv)


def iter_runs(eval_dir: Path) -> Iterator[Tuple[Path, re.Match]]:
    """Yield (path, parsed-stem match) for every recognizable run pickle."""
    for path in sorted(eval_dir.glob("eval_*.pkl")):
        m = RUN_STEM.match(path.stem.removesuffix("_perm_q"))
        if m is None:
            print(f"[04] ignoring unrecognized filename: {path.name}")
            continue
        yield path, m


def load_runs(eval_dir: Path) -> pd.DataFrame:
    """One long frame of per-question rows across every run pickle.

    Run-level fields ride along as repeated columns; the column names and
    order are the artifact contract consumed downstream.
    """
    frames = []
    for path, m in iter_runs(eval_dir):
        with path.open("rb") as fh:
            run = pickle.load(fh)
        frame = pd.DataFrame(run["evaluation"]).assign(
            model=run.get("model"),
            model_short=m["model_short"],
            vd_name=m["vd_name"],
            elapsed_time=run.get("elapsed_time"),
            run_timestamp=run.get("timestamp", m["timestamp"]),
            file_timestamp=m["timestamp"],
            permuted_answers=run.get("permuted_answers",
                                     m["perm_flag"] == "perm"),
            filepath=str(path),
        )
        frames.append(frame)
    if not frames:
        raise SystemExit(f"no eval pickles found in {eval_dir}")
    return pd.concat(frames, ignore_index=True)


def score_against_benchmark(runs: pd.DataFrame, benchmark: pd.DataFrame) -> pd.DataFrame:
    scored = runs.merge(
        benchmark[["Question_nr", "Correct", "Difficulty"]],
        on="Question_nr", how="left",
    )
    scored["Cor_answer"] = (scored["answer"] == scored["Correct"]).astype(int)
    scored["Difficulty"] = pd.Categorical(
        scored["Difficulty"], categories=DIFFICULTY_ORDER, ordered=True)
    scored["vd_name"] = pd.Categorical(
        scored["vd_name"], categories=RAG_MODE_ORDER, ordered=True)
    return scored


def accuracy_by_difficulty(scored: pd.DataFrame) -> pd.DataFrame:
    pivot = pd.pivot_table(
        scored, values="Cor_answer", index=RUN_KEY,
        columns="Difficulty", aggfunc="mean", observed=True,
    )
    return pivot.reindex(columns=DIFFICULTY_ORDER)


def majority_vote_accuracy(scored: pd.DataFrame) -> pd.DataFrame:
    """Per question: correct in >= ceil(n/2) of its repeats; then the mean
    of that vote per run configuration."""
    votes = (
        scored.groupby(RUN_KEY + ["Question_nr", "Difficulty"], observed=True)
        ["Cor_answer"].agg(["sum", "count"]).reset_index()
    )
    votes["Maj_vote"] = (votes["sum"] >= np.ceil(votes["count"] / 2)).astype(int)
    return (
        votes.groupby(RUN_KEY, observed=True)["Maj_vote"].mean().reset_index()
    )


def main(argv=None) -> None:
    args = parse_args(argv)
    scored = score_against_benchmark(
        load_runs(Path(args.eval_dir)), read_table(args.benchmark_path))

    full = write_table(
        scored.sort_values(["model_short", "vd_name", "permuted_answers",
                            "Question_nr"]),
        args.full_path)
    summary = write_table(accuracy_by_difficulty(scored).reset_index(),
                          args.summary_path)
    majority = write_table(majority_vote_accuracy(scored), args.majority_path)

    print(f"[04] per-difficulty accuracy -> {summary}")
    print(f"[04] majority-vote accuracy -> {majority}")
    print(f"[04] full merged evaluations -> {full}")


if __name__ == "__main__":
    main()
