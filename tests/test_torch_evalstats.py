"""The port's ``evalstats`` against the JAX package's, on the CPU: every
function on the fixtures of ``tests/test_evalstats.py`` and on seeded random
evaluation frames, frames exactly equal (``check_exact``)."""

import math

import numpy as np
import pandas as pd
import pytest

import multimodal_colpali_tpu.evalstats as jstats
import multimodal_colpali_tpu_torch.evalstats as tstats
from multimodal_colpali_tpu import config as jconfig
from multimodal_colpali_tpu_torch import config as tconfig

SEEDS = [0, 1, 2]


def eval_csvs(tmp_path, seed, n_iters=3, n_q=20,
              combos=(("gpt-5", "colpali"), ("gpt-5", "colflor"))):
    """``tests/test_evalstats.py``'s evaluation CSVs at seed 0 and the default
    combos; other seeds add odd paper ids and context cells."""
    rng = np.random.default_rng(seed)
    for model, ret in combos:
        for it in range(n_iters):
            paper = [f"Paper{i:02d}" for i in rng.integers(0, 5, n_q)]
            context = ["['Paper01_pg_1','Paper02_pg_2']"] * n_q
            if seed:
                paper[0], paper[1] = "nan", "doc7"
                context[2], context[3] = "not-a-list", "['Paper0"
                context[4] = str([f"{p}_pg_{k}" for k, p in enumerate(rng.choice(paper, 5))])
            df = pd.DataFrame({
                "Question_nr": np.arange(1, n_q + 1),
                "Paper_id": paper,
                "Model": model,
                "Model_ret": ret,
                "Answer": rng.choice(list("ABCD"), n_q),
                "Context_papers": context,
                "Cor_answer": rng.integers(0, 2, n_q),
                "Elapsed": rng.uniform(5, 20, n_q),
                "Total_tokens": rng.integers(1000, 9000, n_q),
                "Difficulty": rng.choice(["Easy", "Medium", "Hard"], n_q),
            })
            df.to_csv(tmp_path / f"eval_{ret}_{model}_{it}.csv", index=False)
    return str(tmp_path) + "/"


def combos_for(seed):
    if seed == 0:
        return (("gpt-5", "colpali"), ("gpt-5", "colflor"))
    return (("gpt-5", "colpali"), ("gpt-5-mini", "colpali"), ("gpt-5-nano", "colflor"),
            ("local", "colflor"))


def assert_same(a, b):
    if isinstance(a, pd.DataFrame):
        pd.testing.assert_frame_equal(a, b, check_exact=True)
    elif isinstance(a, pd.Series):
        pd.testing.assert_series_equal(a, b, check_exact=True)
    elif isinstance(a, tuple):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert_same(x, y)
    elif isinstance(a, float) and math.isnan(a):
        assert isinstance(b, float) and math.isnan(b)
    else:
        assert type(a) is type(b) and a == b, (a, b)


def test_public_names_and_config_equal_jax():
    names = [n for n in dir(jstats) if not n.startswith("_") and n not in
             ("ci", "summary", "wilcoxon")]
    assert names == [n for n in dir(tstats) if not n.startswith("_") and n not in
                     ("ci", "summary", "wilcoxon")]
    assert tstats.METRIC_DESCRIPTIONS == jstats.METRIC_DESCRIPTIONS
    for k in (1, 5, 10):
        assert tstats.get_metric_descriptions(k) == jstats.get_metric_descriptions(k)
    for name in ("EMBED_MODEL_ID", "EMB_DIM", "VECTOR_SIZE", "COLPALI_MAX_PAGE_TOKENS",
                 "DEFAULT_TOP_K", "DEFAULT_MODELS", "DEFAULT_PRICES_GPT", "DEFAULT_PRICE_DICT"):
        assert getattr(tconfig, name) == getattr(jconfig, name), name
    assert tstats.summary.DEFAULT_PRICE_DICT is tconfig.DEFAULT_PRICE_DICT


def test_load_models_config_equal_jax(tmp_path):
    assert tconfig.load_models_config(None) == jconfig.load_models_config(None)
    assert tconfig.load_models_config(str(tmp_path / "missing.json")) == \
        jconfig.load_models_config(str(tmp_path / "missing.json"))
    path = tmp_path / "models.json"
    path.write_text('[{"model_name": "m", "model_short": "s", "port": 1}]')
    assert tconfig.load_models_config(str(path)) == jconfig.load_models_config(str(path))
    fresh = tconfig.load_models_config(None)
    fresh[0]["port"] = 0
    assert tconfig.DEFAULT_MODELS[0]["port"] == 8006      # a copy, not the registry


@pytest.mark.parametrize("seed", SEEDS)
def test_ci_primitives_equal_jax(seed):
    rng = np.random.default_rng(seed)
    cases = [(81, 263), (0, 10), (10, 10), (0, 0), (3.0, 7.0)] + [
        (int(rng.integers(0, 50)), int(rng.integers(50, 120))) for _ in range(5)]
    for count, nobs in cases:
        for alpha in (0.05, 0.1):
            assert_same(tstats.agresti_coull_interval(count, nobs, alpha),
                        jstats.agresti_coull_interval(count, nobs, alpha))
    series = [pd.Series([], dtype=float), pd.Series([1.0]), pd.Series([1.0, 2.0, 3.0, 4.0, 5.0]),
              pd.Series([0.1, 0.2, 0.15]), pd.Series([1.0, np.nan, 3.0]),
              pd.Series(rng.integers(0, 2, 40)), pd.Series(rng.normal(0.05, 1, 30))]
    for s in series:
        assert_same(tstats.proportion_ci(s), jstats.proportion_ci(s))
        for nn in (False, True):
            assert_same(tstats.mean_confidence_interval(s, non_negative=nn),
                        jstats.mean_confidence_interval(s, non_negative=nn))
    for args in [(0.8284, 0.2110, 1.0), (np.nan, 0, 1), (0.5, -0.2, 0.9),
                 *[tuple(rng.uniform(-0.5, 2, 3)) for _ in range(5)]]:
        for dec in (1, 2, 3):
            assert tstats.format_ci_cell(*args, decimals=dec) == \
                jstats.format_ci_cell(*args, decimals=dec)


@pytest.mark.parametrize("seed", SEEDS)
def test_row_metrics_equal_jax(tmp_path, seed):
    merged = jstats.merge_data(eval_csvs(tmp_path, seed, combos=combos_for(seed)))
    fixture = [pd.Series({"Paper_id": "Paper03", "Context_papers":
                          "['paper03_pg_2', 'paper07_pg_1', 'Paper03_pg_9', 'x_pg_1', 'y_pg_2']"}),
               pd.Series({"Paper_id": "nan", "Context_papers": "[]"}),
               pd.Series({"Paper_id": "Paper03", "Context_papers": "not-a-list"}),
               pd.Series({"Paper_id": "Paper03", "Context_papers": np.nan})]
    rows = fixture + [r for _, r in merged.iterrows()]
    for row in rows:
        for k in (5, 10):
            assert_same(tstats.calculate_precision_at_k(row, top_k=k),
                        jstats.calculate_precision_at_k(row, top_k=k))
            assert_same(tstats.calculate_is_paper_id_in_context(row, top_k=k),
                        jstats.calculate_is_paper_id_in_context(row, top_k=k))
    prices = [{"gpt-5": 10, "gpt-5-nano": 0.4}, jconfig.DEFAULT_PRICE_DICT]
    for price in prices:
        assert_same(tstats.calculate_cost(merged, price), jstats.calculate_cost(merged, price))
        assert_same(tstats.calculate_price(merged, price), jstats.calculate_price(merged, price))
    assert_same(tstats.calculate_throughput(merged), jstats.calculate_throughput(merged))
    assert_same(tstats.calculate_latency(merged), jstats.calculate_latency(merged))


@pytest.mark.parametrize("seed", SEEDS)
def test_merge_and_summary_tables_equal_jax(tmp_path, seed):
    path = eval_csvs(tmp_path, seed, combos=combos_for(seed))
    (tmp_path / "empty.csv").write_text("Model,Model_ret\n")
    merged = tstats.merge_data(path)
    assert_same(merged, jstats.merge_data(path))
    assert_same(tstats.merge_data(str(tmp_path / "none") + "/"),
                jstats.merge_data(str(tmp_path / "none") + "/"))
    specs = [{"Cor_answer": "proportion"},
             {"Cor_answer": "proportion", "Elapsed": "mean", "Latency": "mean",
              "is_paper_id_in_context": "mean", "Price": "mean"}]
    price = {"gpt-5": 10, "gpt-5-mini": 2}
    for spec in specs:
        for numeric in (False, True):
            for group in (["Model", "Model_ret"], ["Model_ret"]):
                assert_same(
                    tstats.create_summary_table(merged, group, spec, price, numeric),
                    jstats.create_summary_table(merged, group, spec, price, numeric))
        assert_same(tstats.run_analysis(path, ["Model", "Model_ret"], spec, price),
                    jstats.run_analysis(path, ["Model", "Model_ret"], spec, price))
    assert_same(tstats.run_analysis(str(tmp_path / "none") + "/", ["Model"], specs[0], price),
                jstats.run_analysis(str(tmp_path / "none") + "/", ["Model"], specs[0], price))


@pytest.mark.parametrize("seed", SEEDS)
def test_run_ci_summary_equal_jax(tmp_path, seed):
    path = eval_csvs(tmp_path, seed, combos=combos_for(seed))
    calls = [dict(group_by_cols=["Model", "Model_ret"], price_dict={"gpt-5": 10}, top_k=5),
             dict(group_by_cols=["Model", "Model_ret"]),
             dict(group_by_cols=["Model_ret"], top_k=3, precision_label="hit@3",
                  retriever_order=["colflor", "colpali"]),
             dict(group_by_cols=["Model", "Model_ret"], model_order=sorted(
                 {m for m, _ in combos_for(seed)}, reverse=True),
                  dataframe=jstats.merge_data(path).iloc[: 40 * (seed + 1)])]
    for kw in calls:
        got, want = tstats.run_ci_summary(path, **kw), jstats.run_ci_summary(path, **kw)
        assert len(got) == 3
        for g, w in zip(got, want):
            assert_same(g, w)
    assert_same(tstats.run_ci_summary(str(tmp_path / "none") + "/", ["Model"]),
                jstats.run_ci_summary(str(tmp_path / "none") + "/", ["Model"]))
    for mod in (tstats, jstats):
        with pytest.raises(ValueError, match="group_by_cols"):
            mod.run_ci_summary(path, [])
        with pytest.raises(ValueError, match="Iteration"):
            mod.run_ci_summary(path, ["Model"], dataframe=pd.DataFrame({"Model": ["m"]}))
    tspecs, jspecs = (m.build_ci_metric_specs("P@5") for m in (tstats, jstats))
    assert [{k: v for k, v in s.items() if k != "ci_func"} for s in tspecs] == \
        [{k: v for k, v in s.items() if k != "ci_func"} for s in jspecs]
    s = pd.Series(np.random.default_rng(seed).normal(0.2, 1, 12))
    for t, j in zip(tspecs, jspecs):
        assert_same(t["ci_func"](s), j["ci_func"](s))


def wilcoxon_frames(seed):
    """``tests/test_evalstats.py``'s paired frame and its R golden, then seeded
    frames with several models, repeats, ties and missing pairs."""
    rng = np.random.default_rng(seed)
    rows = []
    for q in range(60):
        base = rng.integers(0, 2)
        rows.append({"Model": "m", "Model_ret": "weak", "Question_nr": q, "Cor_answer": base})
        rows.append({"Model": "m", "Model_ret": "strong", "Question_nr": q,
                     "Cor_answer": 1 if base or rng.random() < 0.5 else 0})
    x = [1, 1, 0, 1, 0, 1, 1, 0, 1, 1]
    y = [0, 1, 1, 1, 0, 0, 1, 0, 0, 1]
    golden = [{"Model": "m", "Model_ret": r, "Question_nr": i, "Cor_answer": v}
              for i, (a, b) in enumerate(zip(x, y)) for r, v in (("colpali", a), ("no_RAG", b))]
    rand = []
    for model in ("gpt-5", "gpt-5-mini"):
        for ret in ("no_RAG", "text_RAG", "mm_RAG", "colpali"):
            for q in range(int(rng.integers(8, 30))):
                for it in range(3):
                    rand.append({"Model": model, "Model_ret": ret, "Question_nr": q,
                                 "Iteration": it, "Cor_answer": int(rng.random() < 0.6)})
    same = [{"Model": "z", "Model_ret": r, "Question_nr": q, "Cor_answer": 1}
            for q in range(5) for r in ("a", "b")]
    return [pd.DataFrame(rows), pd.DataFrame(golden), pd.DataFrame(rand), pd.DataFrame(same)]


@pytest.mark.parametrize("seed", SEEDS)
def test_paired_wilcoxon_equal_jax(seed):
    for df in wilcoxon_frames(seed):
        for bonf in (True, False):
            assert_same(tstats.paired_wilcoxon_table(df, bonferroni=bonf),
                        jstats.paired_wilcoxon_table(df, bonferroni=bonf))
    golden = tstats.paired_wilcoxon_table(wilcoxon_frames(seed)[1])
    assert golden["p_value"].iloc[0] == pytest.approx(0.4237107971667934)
    df = wilcoxon_frames(seed)[2].rename(columns={"Model_ret": "vd_name"})
    assert_same(tstats.paired_wilcoxon_table(df, group_col="vd_name", value_col="Cor_answer"),
                jstats.paired_wilcoxon_table(df, group_col="vd_name", value_col="Cor_answer"))
