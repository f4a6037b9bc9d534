"""Experiment-01 sweep: every RAG mode x answer permutation x repeat.

Counterpart of ``drivers/03_experiment01_run.py`` (reference
03_experiment01_run.py:39-96): the same flags, the same run matrix (four
modes a repeat, permuted legs first) and output stubs
``results/eval/eval_{short}_{mode}_{perm}_benchmark``. Each leg is a
subprocess of the port's ``experiment01``
(``python -m multimodal_colpali_tpu_torch.drivers.experiment01``); the
sweep reports every leg's exit code and exits non-zero if any leg failed.
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import List, Optional

EVAL_MODULE = "multimodal_colpali_tpu_torch.drivers.experiment01"
PACKAGE_ROOT = str(Path(__file__).resolve().parents[2])
RESULTS_DIR = Path("./results/eval")


@dataclasses.dataclass(frozen=True)
class RunSpec:
    """One leg of the sweep: a (mode, permutation, repeat) combination."""

    mode: str          # filename label: no_RAG / text_RAG / mm_RAG / colpali
    vector_db: str     # collection the eval driver queries ("" = no retrieval)
    eval_type: str     # retrieval engine selector passed to --type
    permute: bool
    repeat: int        # 1-based

    @property
    def perm_label(self) -> str:
        return "perm" if self.permute else "no_perm"

    def output_stub(self, model_short: str) -> Path:
        # the evaluation driver's FILE_PATTERN reads this name
        return RESULTS_DIR / f"eval_{model_short}_{self.mode}_{self.perm_label}_benchmark"


def build_matrix(args: argparse.Namespace) -> List[RunSpec]:
    """The sweep, permutation-major, then repeat, then mode."""
    modes = (
        ("no_RAG", "", ""),
        ("text_RAG", args.vd_text_name, "mm_RAG"),
        ("mm_RAG", args.vd_mm_name, "mm_RAG"),
        ("colpali", args.vd_colpali_name, "colpali"),
    )
    return [
        RunSpec(mode=m, vector_db=db, eval_type=ty, permute=perm, repeat=rep)
        for perm, rep, (m, db, ty) in itertools.product(
            (True, False), range(1, args.repeats + 1), modes)
    ]


def invoke(spec: RunSpec, args: argparse.Namespace) -> int:
    cmd = [
        sys.executable, "-m", EVAL_MODULE,
        "--vllm_port", args.vllm_port,
        "--model_name", args.model_name,
        "--filepath_output", str(spec.output_stub(args.model_name_short)),
        "--vector_db", spec.vector_db,
        "--type", spec.eval_type,
        "--top_k", str(args.top_k),
    ]
    for flag, value in (
        ("--qa_path", args.qa_path),
        ("--base-url", args.base_url),
        ("--storage-path", args.storage_path),
        ("--retriever", args.retriever),
        ("--text-encoder-config", args.text_encoder_config),
        ("--device", args.device),
    ):
        if value:
            cmd += [flag, value]
    if spec.permute:
        cmd += ["--perm_quest", "Yes"]
    path = os.environ.get("PYTHONPATH")
    env = {**os.environ, "PYTHONPATH": PACKAGE_ROOT + (os.pathsep + path if path else "")}
    return subprocess.call(cmd, env=env)


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        description="Sweep experiment 01 over RAG modes, permutations and repeats.")
    p.add_argument("--vllm_port", required=True, type=str)
    p.add_argument("--model_name", required=True, type=str)
    p.add_argument("--model_name_short", required=True, type=str)
    p.add_argument("--vd_mm_name", required=True, type=str)
    p.add_argument("--vd_colpali_name", required=True, type=str)
    p.add_argument("--vd_text_name", required=True, type=str)
    p.add_argument("--repeats", required=True, type=int)
    p.add_argument("--top_k", default=5, type=int)
    p.add_argument("--qa_path", default=None, help="Forwarded to the eval driver.")
    p.add_argument("--base-url", default=None, help="Forwarded to the eval driver.")
    p.add_argument("--storage-path", default=None, help="Forwarded to the eval driver.")
    p.add_argument("--retriever", default=None, help="Forwarded to the eval driver.")
    p.add_argument("--text-encoder-config", default=None,
                   help="Forwarded to the eval driver.")
    p.add_argument("--device", default=None, help="Forwarded to the eval driver.")
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> None:
    args = parse_args(argv)
    RESULTS_DIR.mkdir(parents=True, exist_ok=True)
    matrix = build_matrix(args)

    sweep_t0 = time.time()
    failures: List[RunSpec] = []
    for n, spec in enumerate(matrix, 1):
        print(f"[03] leg {n}/{len(matrix)}: mode={spec.mode} "
              f"db={spec.vector_db or '-'} perm={spec.perm_label} "
              f"repeat={spec.repeat}/{args.repeats} "
              f"(model {args.model_name} @ port {args.vllm_port}, top_k={args.top_k})",
              flush=True)
        leg_t0 = time.time()
        rc = invoke(spec, args)
        status = "ok" if rc == 0 else f"FAILED rc={rc}"
        print(f"[03] leg {n}/{len(matrix)} {status} in {time.time() - leg_t0:.1f}s",
              flush=True)
        if rc != 0:
            failures.append(spec)

    print(f"[03] sweep done: {len(matrix) - len(failures)}/{len(matrix)} legs ok "
          f"in {time.time() - sweep_t0:.1f}s")
    if failures:
        for spec in failures:
            print(f"[03]   failed: {spec}")
        sys.exit(1)


if __name__ == "__main__":
    main()
