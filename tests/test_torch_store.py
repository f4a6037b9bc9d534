"""The port's store and retrieval API against the JAX package, on the CPU.

One corpus goes into the JAX store and the port's store; queries, filters,
deletes, scrolls and persistence must agree (same ids, scores within a
stated tolerance). ``retrieve_colpali`` and ``score_results`` run through
both packages with the same tiny ColPali weights.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from multimodal_colpali_tpu import api as japi
from multimodal_colpali_tpu import store as js
from multimodal_colpali_tpu.models import registry as JR
from multimodal_colpali_tpu.models.colpali import ColPaliModel as JColPali
from multimodal_colpali_tpu.models.configs import ColPaliModelConfig as JCfg
from multimodal_colpali_tpu.models.processing import ColPaliProcessor as JProcessor
from multimodal_colpali_tpu_torch import api as tapi
from multimodal_colpali_tpu_torch import store as ts
from multimodal_colpali_tpu_torch.models import load_retriever

torch.set_num_threads(1)

DIM, MAX_TOKENS, N_POINTS = 16, 10, 13  # 13 pages: the device copy pads to 16
# the same bf16 corpus on both sides; only the order of fp32 sums differs
SCORE_ATOL = 1e-4


def _points(mod, seed=0, ids=None):
    rng = np.random.default_rng(seed)
    pts = []
    for i in range(N_POINTS):
        n = int(rng.integers(1, MAX_TOKENS + 3))  # some are cut to max_tokens
        vec = rng.standard_normal((n, DIM)).astype(np.float32)
        payload = {"index": i, "username": ["alice", "bob", "carol"][i % 3],
                   "meta": {"page": i % 4}}
        pts.append(mod.PointStruct(id=i if ids is None else ids[i], vector=vec,
                                   payload=payload))
    return pts


def _filters(mod):
    return {
        "none": None,
        "alice": mod.Filter(must=[mod.FieldCondition(
            key="username", match=mod.MatchValue(value="alice"))]),
        "not_bob": mod.Filter(must_not=[mod.FieldCondition(
            key="username", match=mod.MatchValue(value="bob"))]),
        "nested_any": mod.Filter(must=[mod.FieldCondition(
            key="meta.page", match=mod.MatchAny(any=[0, 3]))]),
        "nobody": mod.Filter(must=[mod.FieldCondition(
            key="username", match=mod.MatchValue(value="dave"))]),
    }


def _pair(dtype="bfloat16"):
    jstore = js.MultiVectorStore("c", dim=DIM, max_tokens=MAX_TOKENS,
                                 dtype=getattr(jnp, dtype))
    tstore = ts.MultiVectorStore("c", dim=DIM, max_tokens=MAX_TOKENS,
                                 dtype=getattr(torch, dtype))
    jstore.upsert(_points(js))
    tstore.upsert(_points(ts))
    return jstore, tstore


def _same_response(got, want, atol=SCORE_ATOL):
    assert [p.id for p in got.points] == [p.id for p in want.points]
    assert [p.payload for p in got.points] == [p.payload for p in want.points]
    np.testing.assert_allclose([p.score for p in got.points],
                               [p.score for p in want.points], rtol=0, atol=atol)


def _query(seed, n=5):
    return np.random.default_rng(100 + seed).standard_normal((n, DIM)).astype(np.float32)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("flt", ["none", "alice", "not_bob", "nested_any", "nobody"])
@pytest.mark.parametrize("limit", [3, 20])
def test_query_matches_jax_store(dtype, flt, limit):
    jstore, tstore = _pair(dtype)
    q = _query(limit)
    want = jstore.query(q, limit=limit, query_filter=_filters(js)[flt])
    got = tstore.query(q, limit=limit, query_filter=_filters(ts)[flt])
    _same_response(got, want)
    if flt == "nobody":
        assert got.points == []


def test_query_ignores_quantization_params_on_exact_store():
    jstore, tstore = _pair()
    q = _query(1)
    sp = ts.SearchParams(quantization=ts.QuantizationSearchParams(ignore=False))
    want = jstore.query(q, limit=4)
    _same_response(tstore.query(q, limit=4, search_params=sp), want)


def test_self_query_ranks_itself_first():
    _, tstore = _pair("float32")
    pts = _points(ts)
    n = min(len(pts[4].vector), MAX_TOKENS)
    res = tstore.query(pts[4].vector[:n], limit=3, with_vectors=True)
    assert res.points[0].id == 4
    assert res.points[0].score == pytest.approx(n, rel=1e-5)
    assert len(res.points[0].vector) == n


def test_device_copy_pads_pages_to_multiple_of_8():
    _, tstore = _pair()
    d, dl = tstore._ensure_device()
    assert d.shape == (16, MAX_TOKENS, DIM) and d.dtype == torch.bfloat16
    assert dl.tolist()[N_POINTS:] == [0, 0, 0]
    assert not d[N_POINTS:].any()


def test_delete_overwrite_scroll_count_match_jax():
    jstore, tstore = _pair()
    for s, mod in ((jstore, js), (tstore, ts)):
        s.delete(ids=[1, 5, 99])
        s.delete(flt=_filters(mod)["alice"])
        s.upsert([mod.PointStruct(id=2, vector=_query(7, 3), payload={"new": True})])
    assert len(tstore) == len(jstore) == 6
    assert tstore.count() == jstore.count()
    assert tstore.count(_filters(ts)["not_bob"]) == jstore.count(_filters(js)["not_bob"])
    q = _query(3)
    _same_response(tstore.query(q, limit=10), jstore.query(q, limit=10))
    for offset in (0, 3, 6):
        tr, tn = tstore.scroll(limit=3, offset=offset, with_vectors=True)
        jr, jn = jstore.scroll(limit=3, offset=offset, with_vectors=True)
        assert tn == jn
        assert [(r.id, r.payload) for r in tr] == [(r.id, r.payload) for r in jr]
        for a, b in zip(tr, jr):
            np.testing.assert_array_equal(np.asarray(a.vector), np.asarray(b.vector))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_store_saved_by_jax_loads_in_port(tmp_path, dtype):
    ids = [f"page-{i}" for i in range(N_POINTS)]
    jstore = js.MultiVectorStore("c", dim=DIM, max_tokens=MAX_TOKENS,
                                 dtype=getattr(jnp, dtype))
    jstore.upsert(_points(js, ids=ids))
    jstore.save(str(tmp_path / "c"))
    tstore = ts.MultiVectorStore.load(str(tmp_path / "c"))
    assert tstore.dtype == getattr(torch, dtype) and len(tstore) == N_POINTS
    for flt in ("none", "not_bob"):
        q = _query(5)
        _same_response(tstore.query(q, limit=6, query_filter=_filters(ts)[flt]),
                       jstore.query(q, limit=6, query_filter=_filters(js)[flt]))


def test_client_saved_by_port_loads_in_jax(tmp_path):
    tclient = ts.VectorClient(path=str(tmp_path))
    tapi.ensure_colpali_collection(tclient, "pages", vector_size=DIM, max_tokens=MAX_TOKENS)
    tclient.upsert("pages", _points(ts))
    tclient.save()
    jclient = js.VectorClient(path=str(tmp_path))
    reloaded = ts.VectorClient(path=str(tmp_path))
    q = _query(9)
    want = jclient.query_points("pages", q, limit=5)
    _same_response(tclient.query_points("pages", q, limit=5), want)
    _same_response(reloaded.query_points("pages", q, limit=5), want)
    assert reloaded.count("pages").count == N_POINTS
    assert [c.name for c in reloaded.get_collections().collections] == ["pages"]
    reloaded.delete_collection("pages")
    assert not (tmp_path / "pages").exists()


def test_client_delete_selectors():
    client = ts.VectorClient()
    tapi.ensure_colpali_collection(client, "c", vector_size=DIM, max_tokens=MAX_TOKENS)
    client.upsert("c", _points(ts))
    client.delete("c", ts.PointIdsList(points=[0, 1]))
    client.delete("c", [2])
    client.delete("c", ts.FilterSelector(filter=_filters(ts)["alice"]))
    client.delete("c", _filters(ts)["nested_any"])
    left = {r.payload["index"] for r in client.scroll("c", limit=100)[0]}
    want = {i for i in range(3, N_POINTS) if i % 3 != 0 and i % 4 not in (0, 3)}
    assert left == want


@pytest.mark.parametrize("kwargs", [dict(quantized=True), dict(prefilter="pooled"),
                                    dict(on_disk=True), dict(mesh=object())])
def test_unported_store_modes_raise(kwargs):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ts.MultiVectorStore("c", dim=DIM, **kwargs)


def test_dense_collections_raise():
    client = ts.VectorClient()
    with pytest.raises(NotImplementedError, match="dense"):
        client.create_collection("d", ts.VectorParams(size=DIM))


def test_upsert_rejects_bad_shapes_and_missing_collections():
    client = ts.VectorClient()
    tapi.ensure_colpali_collection(client, "c", vector_size=DIM)
    bad = ts.PointStruct(id=0, vector=np.zeros((3, DIM + 1), np.float32))
    with pytest.raises(ValueError):
        tapi.upsert_to_qdrant(client, "c", [bad])
    with pytest.raises(KeyError):
        tapi.upsert_to_qdrant(client, "missing", _points(ts)[:1])


# -- retrieval API with the same tiny weights ---------------------------------------

@pytest.fixture(scope="module")
def retrievers():
    with np.load(Path(__file__).resolve().parent.parent / "goldens" /
                 "tiny-colpali_params.npz") as z:
        flat = {k: z[k] for k in z.files}
    nested = {}
    for key, val in flat.items():
        *parents, leaf = key.split("/")
        node = nested
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(val)
    cfg = JCfg.tiny()
    jr = JR.Retriever(name="tiny-colpali", model=JColPali(cfg), params=nested,
                      processor=JProcessor(cfg), dtype=jnp.float32)
    tr = load_retriever("tiny-colpali", dtype=torch.float32, params=flat)
    return jr, tr


def _corpus(n=10):
    rng = np.random.default_rng(21)
    return [rng.integers(0, 256, (28, 28, 3), dtype=np.uint8) for _ in range(n)]


QUERIES = ["what binds selectins", "glycan structures", "binding affinity tables"]


def _index(mod, api, retriever, pages):
    client = mod.VectorClient()
    api.ensure_colpali_collection(client, "pages", vector_size=8)
    half = len(pages) // 2
    for start, user in ((0, "alice"), (half, "bob")):
        dataset = [{"image": pages[i], "filename": f"doc{i // 3}.pdf", "page_no": i % 3}
                   for i in range(start, start + half)]
        api.colpali_qdrant(dataset, ["x/doc0.pdf"], ["10.1/doc0"], retriever,
                           retriever.processor, client, "pages", batch_size=4, username=user)
    return client


@pytest.mark.parametrize("username", ["", "alice"])
def test_retrieve_colpali_matches_jax(retrievers, username):
    jr, tr = retrievers
    pages = _corpus()
    jclient, tclient = _index(js, japi, jr, pages), _index(ts, tapi, tr, pages)
    for query in QUERIES:
        want = japi.retrieve_colpali(query, jr.processor, jr, jclient, username, "pages", 4)
        got = tapi.retrieve_colpali(query, tr.processor, tr, tclient, username, "pages", 4)
        key = ("document_name", "page_no", "username", "document_link", "type")
        assert [[p.payload[k] for k in key] for p in got.points] == \
            [[p.payload[k] for k in key] for p in want.points]
        # bf16 store: the same fp32 embeddings may round to neighbouring bf16 values
        np.testing.assert_allclose([p.score for p in got.points],
                                   [p.score for p in want.points], rtol=0, atol=2e-2)
        if username:
            assert all(p.payload["username"] == username for p in got.points)


def test_score_results_matches_jax(retrievers):
    jr, tr = retrievers
    pages = _corpus()
    embs = tr.embed_images(pages)
    dataset = [{"embedding": e, "doc_id": i // 3, "page_id": i % 3,
                "file_name": f"doc{i // 3}.pdf"} for i, e in enumerate(embs)]
    images = {f"doc{j}.pdf": pages[3 * j: 3 * j + 3] for j in range(4)}
    want = japi.score_results(QUERIES, jr.processor, jr, dataset, images, 5)
    got = tapi.score_results(QUERIES, tr.processor, tr, dataset, images, 5)
    for g, w in zip(got, want):
        assert [(r["doc_id"], r["page_id"], r["file_name"]) for r in g] == \
            [(r["doc_id"], r["page_id"], r["file_name"]) for r in w]
        assert all(r["image"] is images[r["file_name"]][r["page_id"]] for r in g)
        np.testing.assert_allclose([r["score"] for r in g], [r["score"] for r in w],
                                   rtol=0, atol=SCORE_ATOL)


def test_score_multi_vector_matches_jax(retrievers):
    jr, tr = retrievers
    embs = tr.embed_images(_corpus(4))
    qs = tr.embed_queries(QUERIES)
    np.testing.assert_allclose(tr.processor.score_multi_vector(qs, embs),
                               jr.processor.score_multi_vector(qs, embs),
                               rtol=0, atol=SCORE_ATOL)
