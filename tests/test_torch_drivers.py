"""The port's evaluation entry points (``multimodal_colpali_tpu_torch.drivers``)
against the JAX package's drivers 02a, 04 and 06, loaded in-process: both read
the same seeded result files and their CSV tables must be byte-identical
(no Excel engine here, so both write CSV)."""

import importlib.util
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pandas as pd
import pytest

from multimodal_colpali_tpu_torch.drivers import experiment01_eval, experiment02_eval, stat_test

REPO = Path(__file__).resolve().parent.parent
DRIVERS = REPO / "drivers"
MODELS = ["gpt-5", "gpt-5-mini", "gpt-5-nano"]
RETRIEVERS = ["vidore/colpali-v1.3-merged", "vidore/colqwen2.5-v0.2", "ahmed-masry/ColFlor"]


def load_driver(name):
    spec = importlib.util.spec_from_file_location(f"jax_driver_{name}", DRIVERS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_jax(name, argv, monkeypatch):
    mod = load_driver(name)
    monkeypatch.setattr(sys, "argv", [f"{name}.py", *argv])
    mod.main()


def same_files(a: Path, b: Path):
    names = sorted(p.name for p in a.iterdir())
    assert names == sorted(p.name for p in b.iterdir())
    assert names
    for n in names:
        assert (a / n).read_bytes() == (b / n).read_bytes(), n


def benchmark(n_q, seed):
    rng = np.random.default_rng(seed)
    return pd.DataFrame({
        "Question_nr": np.arange(1, n_q + 1),
        "Paper_id": [f"Paper{i:02d}" for i in rng.integers(1, 9, n_q)],
        "question": [f"q{i}" for i in range(n_q)],
        "A": "a", "B": "b", "C": "c", "D": "d",
        "Correct": rng.choice(list("ABCD"), n_q),
        "Difficulty": rng.choice(["Easy", "Medium", "Hard"], n_q),
    })


def exp01_pickles(root: Path, seed, n_q=12):
    """Driver 03's run pickles: every mode, both perm settings, two repeats,
    two generators; a ``_perm_q`` stem, a run without its own timestamp and a
    file the regex refuses."""
    rng = np.random.default_rng(seed)
    root.mkdir(parents=True)
    k = 0
    for short in ("gpt5", "gemma3"):
        for mode in ("no_RAG", "text_RAG", "mm_RAG", "colpali"):
            for perm in ("perm", "no_perm"):
                for rep in range(2):
                    k += 1
                    ts = f"202608{10 + rep:02d}-12{k:02d}00"
                    rows = [{"Question_nr": q, "answer": str(rng.choice(list("ABCD"))),
                             "model_answer": str(rng.choice(list("ABCD"))), "repeat": rep}
                            for q in range(1, n_q + 1) if rng.random() > 0.1]
                    run = {"model": f"model-{short}", "evaluation": rows,
                           "elapsed_time": float(rng.uniform(10, 90)),
                           "permuted_answers": perm == "perm"}
                    if k % 5:
                        run["timestamp"] = ts
                    suffix = "_perm_q" if k % 7 == 0 else ""
                    name = f"eval_{short}_{mode}_{perm}_benchmark_{ts}{suffix}.pkl"
                    (root / name).write_bytes(pickle.dumps(run))
    (root / "eval_notes.pkl").write_bytes(pickle.dumps({}))


def exp02_csvs(root: Path, seed, n_q=15, iterations=3):
    rng = np.random.default_rng(seed)
    root.mkdir(parents=True)
    for model in MODELS:
        for ret in RETRIEVERS:
            for it in range(iterations):
                paper = [f"Paper{i:02d}" for i in rng.integers(1, 6, n_q)]
                context = [str([f"Paper{j:02d}_pg_{j + 1}" for j in rng.integers(1, 6, 5)])
                           for _ in range(n_q)]
                paper[0], context[1], context[2] = "unknown", "not a list", "['Paper0"
                pd.DataFrame({
                    "Question_nr": np.arange(1, n_q + 1), "Paper_id": paper,
                    "Model": model, "Model_ret": ret,
                    "Answer": rng.choice(list("ABCD"), n_q), "Context_papers": context,
                    "Cor_answer": rng.integers(0, 2, n_q),
                    "Elapsed": rng.uniform(1, 9, n_q), "Total_tokens": rng.integers(500, 4000, n_q),
                    "Difficulty": rng.choice(["Easy", "Medium", "Hard"], n_q),
                }).to_csv(root / f"eval_{ret.split('/')[-1]}_{model}_{it}.csv", index=False)
    pd.DataFrame(columns=["Model"]).to_csv(root / "eval_empty.csv", index=False)


@pytest.mark.parametrize("seed", [0, 1])
def test_experiment01_eval_tables_equal_jax(tmp_path, monkeypatch, seed):
    exp01_pickles(tmp_path / "eval", seed)
    benchmark(12, seed).to_csv(tmp_path / "bench.csv", index=False)
    for name, run in (("jax", lambda argv: run_jax("04_experiment01_eval", argv, monkeypatch)),
                      ("port", experiment01_eval.main)):
        out = tmp_path / name
        run(["--eval-dir", str(tmp_path / "eval"),
             "--benchmark-path", str(tmp_path / "bench.xlsx"),
             "--summary-path", str(out / "eval_results.xlsx"),
             "--majority-path", str(out / "eval_maj_results.xlsx"),
             "--full-path", str(out / "eval_full_results.xlsx")])
    same_files(tmp_path / "jax", tmp_path / "port")
    full = pd.read_csv(tmp_path / "port" / "eval_full_results.csv")
    # the non-greedy vd_name keeps every no_perm run (04:10-15)
    assert set(full["vd_name"]) == {"no_RAG", "text_RAG", "mm_RAG", "colpali"}
    assert set(full["permuted_answers"]) == {True, False}


def test_experiment01_eval_refuses_an_empty_directory(tmp_path):
    (tmp_path / "eval").mkdir()
    benchmark(3, 0).to_csv(tmp_path / "bench.csv", index=False)
    with pytest.raises(SystemExit, match="no eval pickles"):
        experiment01_eval.main(["--eval-dir", str(tmp_path / "eval"),
                                "--benchmark-path", str(tmp_path / "bench.csv")])


@pytest.mark.parametrize("seed", [0, 1])
def test_experiment02_eval_tables_equal_jax(tmp_path, monkeypatch, seed):
    exp02_csvs(tmp_path / "evals", seed)
    flags = [] if seed == 0 else ["--models", "gpt-5-nano", "gpt-5",
                                   "--retrievers", *RETRIEVERS[::-1]]
    for name, run in (("jax", lambda argv: run_jax("06_experiment02_eval", argv, monkeypatch)),
                      ("port", experiment02_eval.main)):
        run(["--results_dir", str(tmp_path / "evals"),
             "--output", str(tmp_path / name / "summary.xlsx"), *flags])
    same_files(tmp_path / "jax", tmp_path / "port")
    summary = pd.read_csv(tmp_path / "port" / "summary.csv")
    assert "(SD=" in str(summary["Cor_answer_summary"].iloc[0])


@pytest.mark.parametrize("form", ["directory", "merged_table", "no_bonferroni_vd_name"])
def test_stat_test_tables_equal_jax(tmp_path, monkeypatch, form):
    exp02_csvs(tmp_path / "evals", 3)
    if form == "directory":
        flags = ["--input", str(tmp_path / "evals")]
    else:
        exp01_pickles(tmp_path / "eval", 3)
        benchmark(12, 3).to_csv(tmp_path / "bench.csv", index=False)
        experiment01_eval.main(["--eval-dir", str(tmp_path / "eval"),
                                "--benchmark-path", str(tmp_path / "bench.csv"),
                                "--summary-path", str(tmp_path / "s.csv"),
                                "--majority-path", str(tmp_path / "m.csv"),
                                "--full-path", str(tmp_path / "full.xlsx")])
        flags = ["--input", str(tmp_path / "full.xlsx"), "--model-col", "model_short",
                 "--group-col", "vd_name"]
        if form == "no_bonferroni_vd_name":
            flags += ["--no-bonferroni", "--item-col", "Question_nr", "--value-col",
                      "Cor_answer"]
    for name, run in (("jax", lambda argv: run_jax("02a_stat_test", argv, monkeypatch)),
                      ("port", stat_test.main)):
        run([*flags, "--output", str(tmp_path / name / "stat_tests.xlsx")])
    same_files(tmp_path / "jax", tmp_path / "port")
    table = pd.read_csv(tmp_path / "port" / "stat_tests.csv")
    assert len(table) and {"group_a", "group_b", "p_value", "p_bonferroni"} <= set(table.columns)


def test_entry_points_run_as_modules(tmp_path):
    exp02_csvs(tmp_path / "evals", 0, iterations=2)
    for module, argv in (("stat_test", ["--input", str(tmp_path / "evals"),
                                        "--output", str(tmp_path / "st.xlsx")]),
                         ("experiment02_eval", ["--results_dir", str(tmp_path / "evals"),
                                                "--output", str(tmp_path / "sum.xlsx")])):
        r = subprocess.run([sys.executable, "-m",
                            f"multimodal_colpali_tpu_torch.drivers.{module}", *argv],
                           cwd=REPO, capture_output=True, text=True, timeout=300)
        assert r.returncode == 0, r.stderr[-2000:]
        assert "[done]" in r.stdout
    assert (tmp_path / "st.csv").exists() and (tmp_path / "sum.csv").exists()
    assert (tmp_path / "summary_full.csv").exists()
