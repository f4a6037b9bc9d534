"""The port's experiment drivers (``drivers/experiment01``, ``experiment01_run``,
``experiment02``) against the JAX package's drivers 02, 03 and 05.

The workspace is tests/test_drivers_e2e.py's (two sample PDFs, its question
table, tests/fake_openai.py), with tiny-colpali and tiny-colqwen2.5
checkpoints written by chip_smoke's writer, which both packages load through
``COLPALI_TPU_CKPT_DIR``, and the collections built by the port's
``create_context``. The JAX drivers run in this process. The fake server's
answer depends on each request's images (their count, and for driver 05's
JPEGs their bytes), so a lost or altered image changes the artifacts.
Pickles must be equal in value and type apart from ``elapsed_time`` and
``timestamp``; CSVs byte for byte.
"""

from __future__ import annotations

import base64
import hashlib
import importlib.util
import json
import os
import pickle
import subprocess
import sys
import warnings
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch

from multimodal_colpali_tpu.ingest.pdfwrite import make_sample_pdf
from multimodal_colpali_tpu_torch.drivers import (
    create_context, experiment01, experiment01_run, experiment02)
from tests.fake_openai import FakeOpenAIServer

REPO = Path(__file__).resolve().parent.parent
DRIVERS = REPO / "drivers"
SUBPROCESS_CALL = subprocess.call


def _jax_driver(name):
    spec = importlib.util.spec_from_file_location(f"jax_driver_{name}", DRIVERS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod   # dataclasses resolve cls.__module__
    spec.loader.exec_module(mod)
    return mod


def _answer(req):
    """A letter from the request's images: their count, and the bytes of
    JPEG ones (equal in both packages); JSON when a schema is asked for."""
    parts = [p for m in req.get("messages", []) for p in (m.get("content") or [])
             if isinstance(p, dict)]
    n = sum(p.get("type") == "image_url" for p in parts)
    h = n
    for p in parts:
        url = (p.get("image_url") or {}).get("url", "")
        if url.startswith("data:image/jpeg"):
            h += int(hashlib.sha256(base64.b64decode(url.split(",")[1])).hexdigest(), 16) % 7
    letter = "ABCD"[h % 4]
    return json.dumps({"answer": letter}) if req.get("response_format") else letter


def _text_of(req):
    """A request with each image part's data URL cut to its media type."""
    def part(p):
        if isinstance(p, dict) and p.get("type") == "image_url":
            return p["image_url"]["url"].split(";")[0]
        return p

    msgs = [{**m, "content": [part(p) for p in m["content"]]} for m in req["messages"]]
    return json.dumps({**req, "messages": msgs}, sort_keys=True)


@pytest.fixture(scope="module")
def ws(tmp_path_factory):
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from multimodal_colpali_tpu_torch.models.registry import RETRIEVER_CONFIGS

    ws = tmp_path_factory.mktemp("exp")
    papers = ws / "papers"
    papers.mkdir()
    for i, name in enumerate(["Paper01", "Paper02"]):
        make_sample_pdf(str(papers / f"{name}.pdf"), n_pages=2, lines_per_page=5, seed=i)
    pd.DataFrame({
        "Question_nr": [1, 2, 3],
        "Paper_id": ["Paper01", "Paper02", "Paper01"],
        "Nr_data_suppl": [0, 0, 0],
        "doi": ["d1", "d2", "d1"],
        "title": ["t1", "t2", "t1"],
        "question": ["What binds selectins?", "What is page two about?", "Name a glycan."],
        "A": ["sialyl-Lewis-x", "glycans", "chitin"],
        "B": ["starch", "metals", "sialic acid"],
        "C": ["iron", "planets", "iron"],
        "D": ["nothing", "nothing", "starch"],
        "Correct": ["A", "A", "B"],
        "Difficulty": ["Easy", "Medium", "Hard"],
    }).to_csv(ws / "benchmark.csv", index=False)
    (ws / "models.json").write_text(json.dumps([{
        "model_name": "fake-gemma", "model_short": "gemma3", "port": 1,
        "text_vd": "RAG_TEXT", "mm_vd": "RAG_MM_gemma3",
        "late_inter": "tiny-colpali", "late_inter_short": "colpali"}]))
    for name, tensors, norm in (
            ("tiny-colpali", smoke.colpali_hf_tensors(RETRIEVER_CONFIGS["tiny-colpali"]()),
             smoke.colpali_norm),
            ("tiny-colqwen2.5", smoke.colqwen_hf_tensors(RETRIEVER_CONFIGS["tiny-colqwen2.5"]()),
             smoke.colqwen_norm)):
        (ws / "ckpt" / name).mkdir(parents=True)
        smoke.write_checkpoint(torch, tensors, str(ws / "ckpt" / name), seed=5, shards=1,
                               device="cpu", norm=norm)
    os.environ["COLPALI_TPU_CKPT_DIR"] = str(ws / "ckpt")
    try:
        create_context.main(["--papers-dir", str(papers), "--models-config",
                             str(ws / "models.json"), "--prompts-path", "",
                             "--text-encoder-config", "tiny", "--skip-summaries",
                             "--vd-dir", str(ws / "vd"), "--device", "cpu"])
    finally:
        del os.environ["COLPALI_TPU_CKPT_DIR"]
    return ws


@pytest.fixture
def fake(ws, monkeypatch):
    monkeypatch.setenv("COLPALI_TPU_CKPT_DIR", str(ws / "ckpt"))
    monkeypatch.setenv("OPENAI_API_KEY", "test-key")
    monkeypatch.delenv("OPENAI_BASE_URL", raising=False)
    with FakeOpenAIServer(_answer) as srv:
        yield srv


def _strip(blob):
    out = dict(blob)
    assert isinstance(out.pop("elapsed_time"), float)
    assert isinstance(out.pop("timestamp"), str)
    return out


def _same(a, b, path="$"):
    """Equal in value and type, recursively."""
    assert type(a) is type(b), f"{path}: {type(a).__name__} != {type(b).__name__}"
    if isinstance(a, dict):
        assert list(a) == list(b), path
        for k in a:
            _same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}[{i}]")
    else:
        assert a == b, f"{path}: {a!r} != {b!r}"


# (label, --type, --vector_db, --perm_quest)
MODES = [("no_RAG", "", "", "No"), ("colpali", "colpali", "colpali", "Yes"),
         ("text_RAG", "mm_RAG", "RAG_TEXT", "No"), ("mm_RAG", "mm_RAG", "RAG_MM_gemma3", "Yes")]


@pytest.mark.parametrize("label,typ,vdb,perm", MODES)
def test_experiment01_pickle_equals_driver_02(ws, fake, monkeypatch, label, typ, vdb, perm):
    common = ["--vllm_port", "1", "--model_name", "gpt-5", "--vector_db", vdb, "--type", typ,
              "--perm_quest", perm, "--qa_path", str(ws / "benchmark.csv"),
              "--storage-path", str(ws / "vd" / "storage"), "--retriever", "tiny-colpali",
              "--text-encoder-config", "tiny", "--base-url", fake.base_url, "--seed", "0",
              "--top_k", "3"]
    jdir, tdir = ws / "r01" / f"jax_{label}", ws / "r01" / f"port_{label}"
    monkeypatch.setattr(sys, "argv", ["02_experiment01.py", *common,
                                      "--filepath_output", str(jdir / "eval")])
    _jax_driver("02_experiment01").main()
    n_jax = len(fake.requests)
    experiment01.main([*common, "--filepath_output", str(tdir / "eval"), "--device", "cpu"])
    (jp,), (tp,) = list(jdir.glob("*.pkl")), list(tdir.glob("*.pkl"))
    suffix = "_perm_q.pkl" if perm == "Yes" else ".pkl"
    assert jp.name.endswith(suffix) and tp.name.endswith(suffix)
    assert len(tp.name) == len(jp.name)          # eval_{%Y%m%d-%H%M%S}[_perm_q].pkl
    want, got = _strip(pickle.load(open(jp, "rb"))), _strip(pickle.load(open(tp, "rb")))
    _same(got, want)
    reqs = fake.requests
    assert len(reqs) == 2 * n_jax == 6
    # the same prompts, image for image (they arrive in any order)
    assert sorted(map(_text_of, reqs[:n_jax])) == sorted(map(_text_of, reqs[n_jax:]))
    if typ == "colpali":
        assert all(len(r["context_refs"]) == 3 for r in got["evaluation"])


def test_experiment01_run_legs_match_driver_03(ws, tmp_path, monkeypatch):
    """The same legs with the same flags, each a subprocess of the port's
    experiment01; a failed leg makes the sweep exit 1; one leg runs for real."""
    monkeypatch.chdir(tmp_path)
    argv = ["--vllm_port", "1", "--model_name", "gpt-5", "--model_name_short", "gpt5",
            "--vd_mm_name", "RAG_MM_gemma3", "--vd_colpali_name", "colpali",
            "--vd_text_name", "RAG_TEXT", "--repeats", "2", "--top_k", "3",
            "--qa_path", str(ws / "benchmark.csv"), "--storage-path", str(ws / "vd" / "storage"),
            "--retriever", "tiny-colpali", "--text-encoder-config", "tiny"]
    j = _jax_driver("03_experiment01_run")
    calls = {"jax": [], "port": []}
    monkeypatch.setattr(j.subprocess, "call", lambda cmd: calls["jax"].append(cmd) or 0)
    monkeypatch.setattr(sys, "argv", ["03_experiment01_run.py", *argv])
    j.main()
    monkeypatch.setattr(experiment01_run.subprocess, "call",
                        lambda cmd, env: calls["port"].append(cmd) or 0)
    experiment01_run.main([*argv, "--device", "cpu"])
    assert len(calls["jax"]) == len(calls["port"]) == 16
    for jc, tc in zip(calls["jax"], calls["port"]):
        assert jc[1].endswith("02_experiment01.py")
        assert tc[1:3] == ["-m", "multimodal_colpali_tpu_torch.drivers.experiment01"]
        want = jc[2:]
        at = want.index("--perm_quest") if "--perm_quest" in want else len(want)
        assert tc[3:] == want[:at] + ["--device", "cpu"] + want[at:]
    monkeypatch.setattr(experiment01_run.subprocess, "call",
                        lambda cmd, env: 3 if "colpali" in cmd else 0)
    with pytest.raises(SystemExit) as e:
        experiment01_run.main([*argv, "--device", "cpu"])
    assert e.value.code == 1
    # one leg for real: a subprocess of the port's driver writes its pickle
    monkeypatch.setattr(experiment01_run.subprocess, "call", SUBPROCESS_CALL)
    spec = experiment01_run.build_matrix(experiment01_run.parse_args(argv))[0]
    args = experiment01_run.parse_args([*argv, "--device", "cpu", "--base-url",
                                        "http://127.0.0.1:9/v1"])
    with FakeOpenAIServer(_answer) as srv:
        args.base_url = srv.base_url
        assert experiment01_run.invoke(spec, args) == 0
    (pkl,) = (tmp_path / "results" / "eval").glob("*.pkl")
    assert pkl.name.startswith("eval_gpt5_no_RAG_perm_benchmark_")


def _cos(a, b):
    a = a / np.linalg.norm(a, axis=-1, keepdims=True)
    b = b / np.linalg.norm(b, axis=-1, keepdims=True)
    return (a * b).sum(-1)


def _written(d):
    """A results directory's CSVs in the order they were written."""
    return sorted(Path(d).glob("*.csv"), key=lambda p: p.stat().st_mtime_ns)


def _run05(pkg, monkeypatch, common, out, cache, retrievers, context=True):
    argv = [*common, "--retrievers", *retrievers, "--results_dir", str(out),
            "--cache_dir", str(cache)] + (["--context"] if context else [])
    if pkg == "port":
        experiment02.main([*argv, "--device", "cpu"])
    else:
        monkeypatch.setattr(sys, "argv", ["05_experiment02.py", *argv])
        _jax_driver("05_experiment02").main()
    return _written(out)


# the port's MaxSim scores of tiny-colpali's pages (its query embeddings
# against its cache) must lie within one bf16 step (2^-8 of the value) of
# JAX's (JAX's against JAX's cache); the pages of a query score within
# about 1% of each other, so that much noise can reorder them
SCORE_RTOL = 2.0 ** -8


def _maxsim(queries, cache):
    return np.array([[float((np.asarray(q, np.float32) @ np.asarray(e["embedding"]).T)
                            .max(1).sum()) for e in cache] for q in queries])


def _colpali_rows_equal_up_to_ties(r, jcsv, tcsv, port_requests):
    """tiny-colpali's rows of experiment 02: each package's pages are its own
    top 3 by MaxSim, the two packages' scores agree within ``SCORE_RTOL``,
    so a page where they differ ties with JAX's within twice that; a row
    with JAX's pages is JAX's row byte for byte; every row's Answer and
    Cor_answer follow from the request the port sent, whose images are the
    pages it names, as JAX's driver would send them."""
    import ast

    from multimodal_colpali_tpu.ingest import convert_pdf_dir_to_images
    from multimodal_colpali_tpu.models import load_retriever as jax_load_retriever
    from multimodal_colpali_tpu_torch.models import load_retriever

    jlines, tlines = jcsv.read_text().splitlines(), tcsv.read_text().splitlines()
    assert len(jlines) == len(tlines) == 4 and tlines[0] == jlines[0]
    jrows, trows = pd.read_csv(jcsv), pd.read_csv(tcsv)
    jdrv = _jax_driver("05_experiment02")
    retrieval, prompts = jdrv.build_query_prompts(jrows)
    jcache = pickle.load(open(r / "jax_cache" / "tiny-colpali_pdf_emb.pkl", "rb"))
    tcache = pickle.load(open(r / "port_cache" / "tiny-colpali_pdf_emb.pkl", "rb"))
    names = [f"{e['file_name'].split('.')[0]}_pg_{e['page_id']}" for e in jcache]
    sj = _maxsim(jax_load_retriever("tiny-colpali").embed_queries(retrieval), jcache)
    sp = _maxsim(load_retriever("tiny-colpali", device="cpu").embed_queries(retrieval), tcache)
    np.testing.assert_allclose(sp, sj, rtol=SCORE_RTOL, atol=0)
    pages = convert_pdf_dir_to_images(str(r.parent / "papers"))
    sent = {req["messages"][0]["content"][0]["text"]: req for req in port_requests}
    assert sorted(sent) == sorted(prompts)
    swapped = 0
    for i, (jrow, trow) in enumerate(zip(jrows.itertuples(), trows.itertuples())):
        jrefs, trefs = ast.literal_eval(jrow.Context_papers), ast.literal_eval(trow.Context_papers)
        assert trefs == [names[k] for k in np.argsort(-sp[i], kind="stable")[:3]], f"row {i}"
        assert jrefs == [names[k] for k in np.argsort(-sj[i], kind="stable")[:3]], f"row {i}"
        req = sent[prompts[i]]
        want = ([{"type": "text", "text": prompts[i]},
                 {"type": "text", "text": "Context information:"}]
                + jdrv._image_parts([pages[f"{ref.rsplit('_pg_', 1)[0]}.pdf"]
                                     [int(ref.rsplit("_pg_", 1)[1])] for ref in trefs]))
        assert req["messages"][0]["content"] == want, f"row {i}: the images sent"
        assert trow.Answer == json.loads(_answer(req))["answer"]
        assert trow.Cor_answer == int(trow.Answer == trow.Correct)
        if trefs == jrefs:
            assert tlines[i + 1] == jlines[i + 1], f"row {i}"
            continue
        for a, b in zip(trefs, jrefs):
            ja, jb = sj[i, names.index(a)], sj[i, names.index(b)]
            assert abs(ja - jb) <= 2 * SCORE_RTOL * abs(jb), f"row {i}: {a} {ja}, {b} {jb}"
            swapped += a != b
    print(f"tiny-colpali: {swapped} page(s) swapped within ties; the packages' scores "
          f"{float(np.abs(sp / sj - 1).max()):.2e} apart")


def test_experiment02_csvs_equal_driver_05(ws, fake, monkeypatch):
    """Each package embeds the corpus into its own cache; the caches agree
    per token (cosine > 0.99) and each package reads the other's.
    tiny-colqwen2.5's CSVs are byte-identical from either cache, with and
    without --context. tiny-colpali's four random-weight pages score within
    bf16 noise of each other (the JAX and the port query embeddings differ
    by it), so its page order may differ: there
    ``_colpali_rows_equal_up_to_ties`` holds each row."""
    common = ["--qa_path", str(ws / "benchmark.csv"), "--pdf_dir", str(ws / "papers"),
              "--models", "gpt-5", "--iterations", "1", "--top_k", "3",
              "--base-url", fake.base_url, "--seed", "0"]
    both = ["tiny-colpali", "tiny-colqwen2.5"]
    r = ws / "r02"
    jcsv = _run05("jax", monkeypatch, common, r / "jax", r / "jax_cache", both)
    n0 = len(fake.requests)
    tcsv = _run05("port", monkeypatch, common, r / "port", r / "port_cache", both)
    assert len(jcsv) == len(tcsv) == 2
    assert all(p.name.startswith("eval_tiny_gpt-5_") and len(p.name) in (34, 36)
               for p in jcsv + tcsv)
    assert tcsv[1].read_bytes() == jcsv[1].read_bytes()      # tiny-colqwen2.5
    _colpali_rows_equal_up_to_ties(r, jcsv[0], tcsv[0], fake.requests[n0: n0 + 3])
    for name in both:
        jc = pickle.load(open(r / "jax_cache" / f"{name}_pdf_emb.pkl", "rb"))
        tc = pickle.load(open(r / "port_cache" / f"{name}_pdf_emb.pkl", "rb"))
        assert len(jc) == len(tc) == 4
        for a, b in zip(jc, tc):
            assert list(a) == list(b) == ["embedding", "doc_id", "page_id", "file_name"]
            assert [type(a[k]) for k in a] == [type(b[k]) for k in b]
            assert b["embedding"].dtype == np.float32
            assert b["embedding"].shape == a["embedding"].shape
            assert (a["doc_id"], a["page_id"], a["file_name"]) == \
                (b["doc_id"], b["page_id"], b["file_name"])
            assert _cos(a["embedding"], b["embedding"]).min() > 0.99
    # the port on JAX's cache, JAX on the port's
    (got,) = _run05("port", monkeypatch, common, r / "port_on_jax", r / "jax_cache",
                    ["tiny-colqwen2.5"])
    assert got.read_bytes() == jcsv[1].read_bytes()
    (got,) = _run05("jax", monkeypatch, common, r / "jax_on_port", r / "port_cache",
                    ["tiny-colqwen2.5"])
    assert got.read_bytes() == tcsv[1].read_bytes()
    # without --context
    (want,) = _run05("jax", monkeypatch, common, r / "jax_plain", r / "jax_cache",
                     ["tiny-colpali"], context=False)
    (got,) = _run05("port", monkeypatch, common, r / "port_plain", r / "jax_cache",
                    ["tiny-colpali"], context=False)
    assert got.read_bytes() == want.read_bytes()
    assert "[]" in got.read_text()


def test_local_run_against_the_port_s_server(ws, monkeypatch):
    """experiment01 (colpali) and experiment02 --context against the port's
    own server on tiny-colpali: every image of every request decoded, every
    answer one of A-D."""
    from multimodal_colpali_tpu_torch.generation.server import GenerationServer
    from multimodal_colpali_tpu_torch.serve import build, parse_args

    monkeypatch.setenv("COLPALI_TPU_CKPT_DIR", str(ws / "ckpt"))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        engine, tok, mm, pre = build(parse_args(["--model", "tiny-colpali", "--device", "cpu",
                                                 "--dtype", "float32"]))
    out = ws / "local"
    with GenerationServer(engine, tok, "tiny-colpali", mm_engine=mm, image_preprocessor=pre,
                          max_new_tokens=4) as srv:
        experiment01.main(["--vllm_port", "1", "--model_name", "gpt-local", "--type", "colpali",
                           "--vector_db", "colpali", "--qa_path", str(ws / "benchmark.csv"),
                           "--storage-path", str(ws / "vd" / "storage"), "--retriever",
                           "tiny-colpali", "--base-url", srv.base_url, "--seed", "1",
                           "--top_k", "2", "--filepath_output", str(out / "e1"),
                           "--device", "cpu"])
        experiment02.main(["--qa_path", str(ws / "benchmark.csv"), "--pdf_dir", str(ws / "papers"),
                           "--models", "gpt-local", "--retrievers", "tiny-colpali",
                           "--iterations", "1", "--top_k", "3", "--context", "--base-url",
                           srv.base_url, "--results_dir", str(out / "e2"), "--cache_dir",
                           str(out / "cache"), "--device", "cpu"])
        stats = srv.stats()
    (pkl,) = out.glob("e1_*.pkl")
    assert {r["answer"] for r in pickle.load(open(pkl, "rb"))["evaluation"]} <= set("ABCD")
    (csv,) = (out / "e2").glob("*.csv")
    assert set(pd.read_csv(csv)["Answer"]) <= set("ABCD")
    assert stats["images_skipped"] == 0
    assert stats["images_per_request"] == {"2": 3, "3": 3}


GUARD = """
import importlib.abc, sys
class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in ("jax", "PIL", "pandas", "aiohttp"):
            raise ImportError("refused: " + name)
sys.meta_path.insert(0, Refuse())
import runpy
sys.argv = [sys.argv[1]] + sys.argv[2:]
runpy.run_module(sys.argv[0], run_name="__main__")
"""


def test_drivers_import_no_jax_pillow_pandas_or_aiohttp(ws, tmp_path):
    env = dict(os.environ, COLPALI_TPU_CKPT_DIR=str(ws / "ckpt"),
               PYTHONPATH=f"{REPO}:{os.environ.get('PYTHONPATH', '')}")
    with FakeOpenAIServer(_answer) as srv:
        for argv in (
                ["multimodal_colpali_tpu_torch.drivers.experiment01", "--vllm_port", "1",
                 "--model_name", "gpt-5", "--type", "colpali", "--vector_db", "colpali",
                 "--qa_path", str(ws / "benchmark.xlsx"), "--storage-path",
                 str(ws / "vd" / "storage"), "--retriever", "tiny-colpali", "--base-url",
                 srv.base_url, "--filepath_output", str(tmp_path / "e"), "--device", "cpu"],
                ["multimodal_colpali_tpu_torch.drivers.experiment02", "--qa_path",
                 str(ws / "benchmark.csv"), "--pdf_dir", str(ws / "papers"), "--models", "gpt-5",
                 "--retrievers", "tiny-colpali", "--iterations", "1", "--context",
                 "--base-url", srv.base_url, "--results_dir", str(tmp_path / "r"),
                 "--cache_dir", str(tmp_path / "c"), "--device", "cpu"]):
            r = subprocess.run([sys.executable, "-c", GUARD, *argv], env=env,
                               capture_output=True, text=True, timeout=300)
            assert r.returncode == 0, r.stderr[-3000:]
    assert list(tmp_path.glob("e_*.pkl")) and list((tmp_path / "r").glob("*.csv"))


def test_cet_timestamps_follow_the_eu_rule_without_tzdata():
    """``pd.Timestamp("now", tz="CET")``'s zone: zoneinfo's CET, and where a
    machine has no time-zone data the EU summer-time rule, equal to it at
    every instant tried (both switches of each year included)."""
    import datetime
    from zoneinfo import ZoneInfo

    t = datetime.datetime(2019, 1, 1, tzinfo=datetime.timezone.utc)
    while t.year < 2031:
        for probe in (t, t + datetime.timedelta(minutes=59)):
            want = probe.astimezone(ZoneInfo("CET")).strftime("%Y%m%d-%H%M%S")
            assert experiment01.cet_time(probe).strftime("%Y%m%d-%H%M%S") == want
            assert experiment01.cet_time(probe, tzdata=False).strftime("%Y%m%d-%H%M%S") == want
        t += datetime.timedelta(hours=5, minutes=17)
    assert pd.Timestamp("2024-03-31 01:30", tz="UTC").tz_convert("CET").strftime("%H") == \
        experiment01.cet_time(datetime.datetime(2024, 3, 31, 1, 30,
                                                tzinfo=datetime.timezone.utc), False).strftime("%H")
