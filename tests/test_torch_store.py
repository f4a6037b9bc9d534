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


def _same_response(got, want, atol=SCORE_ATOL, rtol=0.0):
    assert [p.id for p in got.points] == [p.id for p in want.points]
    assert [p.payload for p in got.points] == [p.payload for p in want.points]
    np.testing.assert_allclose([p.score for p in got.points],
                               [p.score for p in want.points], rtol=rtol, atol=atol)


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
    tclient = ts.VectorClient(path=str(tmp_path), device="cpu")
    tapi.ensure_colpali_collection(tclient, "pages", vector_size=DIM, max_tokens=MAX_TOKENS)
    tclient.upsert("pages", _points(ts))
    tclient.save()
    jclient = js.VectorClient(path=str(tmp_path))
    reloaded = ts.VectorClient(path=str(tmp_path), device="cpu")
    q = _query(9)
    want = jclient.query_points("pages", q, limit=5)
    _same_response(tclient.query_points("pages", q, limit=5), want)
    _same_response(reloaded.query_points("pages", q, limit=5), want)
    assert reloaded.count("pages").count == N_POINTS
    assert [c.name for c in reloaded.get_collections().collections] == ["pages"]
    reloaded.delete_collection("pages")
    assert not (tmp_path / "pages").exists()


def test_client_delete_selectors():
    client = ts.VectorClient(device="cpu")
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
                                    dict(on_disk=True), {}])
def test_unported_store_modes_raise(kwargs, tmp_path):
    """Every mode shards its page axis over a mesh now (here a one-rank gloo
    mesh, the card's world size) and answers as the mesh-less store does;
    what raises is JAX's refusal of on_disk with a mesh (multivector.py:
    140-142)."""
    import parallel_worker

    with parallel_worker.one_rank_mesh(tmp_path) as mesh:
        if kwargs.get("on_disk"):
            with pytest.raises(ValueError, match="mutually exclusive"):
                ts.MultiVectorStore("c", dim=DIM, mesh=mesh, device="cpu", **kwargs)
            return
        got, want = (ts.MultiVectorStore("c", dim=DIM, max_tokens=MAX_TOKENS, mesh=m,
                                         device="cpu", **kwargs) for m in (mesh, None))
        for store in (got, want):
            store.upsert(_points(ts))
        q = np.random.default_rng(9).standard_normal((3, DIM)).astype(np.float32)
        a, b = got.query(q, limit=6).points, want.query(q, limit=6).points
        assert [p.id for p in a] == [p.id for p in b] and len(a) == 6
        assert [p.score for p in a] == [p.score for p in b]


def test_dense_collections_raise(tmp_path):
    """Dense collections are ported: the client makes one, and what raises is
    what raises in JAX's (a vector of another size). A client over a mesh
    (one gloo rank) makes a sharded dense collection that answers as the
    mesh-less one."""
    import parallel_worker

    client = ts.VectorClient(device="cpu")
    client.create_collection("d", ts.VectorParams(size=DIM))
    assert isinstance(client._get("d"), ts.DenseVectorStore)
    with pytest.raises(ValueError, match="expected dim"):
        client.upsert("d", [ts.PointStruct(id=0, vector=np.zeros(DIM + 1, np.float32))])
    vecs = np.random.default_rng(8).standard_normal((11, DIM)).astype(np.float32)
    with parallel_worker.one_rank_mesh(tmp_path) as mesh:
        sharded = ts.VectorClient(device="cpu", mesh=mesh)
        sharded.create_collection("d", ts.VectorParams(size=DIM))
        assert sharded._get("d").mesh is mesh
        for c in (client, sharded):
            c.upsert("d", [ts.PointStruct(id=i, vector=v) for i, v in enumerate(vecs)])
        a = sharded.query_points("d", vecs[3], limit=4).points
        b = client.query_points("d", vecs[3], limit=4).points
        assert [(p.id, p.score) for p in a] == [(p.id, p.score) for p in b]


def test_upsert_rejects_bad_shapes_and_missing_collections():
    client = ts.VectorClient(device="cpu")
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
    tr = load_retriever("tiny-colpali", device="cpu", dtype=torch.float32, params=flat)
    return jr, tr


def _corpus(n=10):
    rng = np.random.default_rng(21)
    return [rng.integers(0, 256, (28, 28, 3), dtype=np.uint8) for _ in range(n)]


QUERIES = ["what binds selectins", "glycan structures", "binding affinity tables"]


def _index(mod, api, retriever, pages):
    client = mod.VectorClient(device="cpu") if mod is ts else mod.VectorClient()
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
    np.testing.assert_allclose(tr.processor.score_multi_vector(qs, embs, device="cpu"),
                               jr.processor.score_multi_vector(qs, embs),
                               rtol=0, atol=SCORE_ATOL)


# -- quantized, pooled and on_disk modes -------------------------------------------------

MODES = {
    "int8": dict(quantized=True),
    "pooled": dict(quantized=True, prefilter="pooled"),
    "pooled4": dict(quantized=True, prefilter="pooled", pooled_centroids=4),
    "on_disk": dict(on_disk=True),
}
# one corpus through both packages; only the order of float32 sums differs
MODE_RTOL, MODE_ATOL = 1e-5, 1e-6


def _mode_pair(mode, dtype="bfloat16"):
    jstore = js.MultiVectorStore("c", dim=DIM, max_tokens=MAX_TOKENS,
                                 dtype=getattr(jnp, dtype), **MODES[mode])
    tstore = ts.MultiVectorStore("c", dim=DIM, max_tokens=MAX_TOKENS,
                                 dtype=getattr(torch, dtype), **MODES[mode])
    jstore.upsert(_points(js))
    tstore.upsert(_points(ts))
    return jstore, tstore


def _search(mod, kind):
    quant = {"default": None,
             "rescore_off": mod.QuantizationSearchParams(rescore=False),
             "all_candidates": mod.QuantizationSearchParams(oversampling=4.0),
             "ignore": mod.QuantizationSearchParams(ignore=True)}[kind]
    return None if quant is None else mod.SearchParams(quantization=quant)


def _same_mode_response(got, want):
    _same_response(got, want, atol=MODE_ATOL, rtol=MODE_RTOL)


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("search", ["default", "rescore_off", "all_candidates", "ignore"])
@pytest.mark.parametrize("flt", ["none", "alice", "nobody"])
def test_store_modes_match_jax_store(mode, search, flt):
    jstore, tstore = _mode_pair(mode)
    assert (tstore.quantized, tstore.prefilter, tstore.on_disk) == \
        (jstore.quantized, jstore.prefilter, jstore.on_disk)
    for limit in (3, 5):
        q = _query(10 + limit)
        want = jstore.query(q, limit=limit, query_filter=_filters(js)[flt],
                            search_params=_search(js, search))
        got = tstore.query(q, limit=limit, query_filter=_filters(ts)[flt],
                           search_params=_search(ts, search))
        _same_mode_response(got, want)
        if flt == "alice":
            assert all(p.payload["username"] == "alice" for p in got.points)
        if flt == "nobody":
            assert got.points == []


@pytest.mark.parametrize("mode", ["int8", "pooled", "on_disk"])
def test_store_modes_in_float32_match_jax_store(mode):
    jstore, tstore = _mode_pair(mode, "float32")
    q = _query(21)
    _same_mode_response(tstore.query(q, limit=4), jstore.query(q, limit=4))


def test_int8_rescore_gives_the_exact_scan_with_every_page_a_candidate():
    """With oversampling covering the corpus the int8 prefilter's rescore is
    the exact scan, page for page (multivector.py:410-416)."""
    _, tstore = _mode_pair("int8")
    _, exact = _pair()
    q = _query(30)
    sp = ts.SearchParams(quantization=ts.QuantizationSearchParams(oversampling=16 / 5))
    got, want = tstore.query(q, limit=5, search_params=sp), exact.query(q, limit=5)
    assert [p.id for p in got.points] == [p.id for p in want.points]
    assert [p.score for p in got.points] == [p.score for p in want.points]


def test_quantized_device_cache_follows_mutations():
    jstore, tstore = _mode_pair("int8")
    q = _query(31)
    tstore.query(q, limit=3)
    assert tstore._device_cache_int8 is not None
    for s, mod in ((jstore, js), (tstore, ts)):
        s.delete(ids=[0, 4])
        s.upsert([mod.PointStruct(id=2, vector=_query(32, 4), payload={"new": True})])
    assert tstore._device_cache is None and tstore._device_cache_int8 is None
    _same_mode_response(tstore.query(q, limit=5), jstore.query(q, limit=5))


@pytest.mark.parametrize("mode", list(MODES))
def test_jax_saved_store_loads_in_port_in_its_mode(tmp_path, mode):
    jstore, _ = _mode_pair(mode)
    jstore.save(str(tmp_path / "c"))
    tstore = ts.MultiVectorStore.load(str(tmp_path / "c"))
    for attr in ("quantized", "prefilter", "pooled_centroids", "on_disk"):
        assert getattr(tstore, attr) == getattr(jstore, attr), attr
    assert isinstance(tstore._vectors, np.memmap) == (mode == "on_disk")
    for flt in ("none", "not_bob"):
        for limit in (3, 6):  # 6 x 2 candidates: the concurrent memmap gather
            q = _query(40 + limit)
            _same_mode_response(tstore.query(q, limit=limit, query_filter=_filters(ts)[flt]),
                                jstore.query(q, limit=limit, query_filter=_filters(js)[flt]))


@pytest.mark.parametrize("mode", list(MODES))
def test_port_saved_store_loads_in_jax_in_its_mode(tmp_path, mode):
    jstore, tstore = _mode_pair(mode)
    tstore.save(str(tmp_path / "c"))
    names = sorted(p.name for p in (tmp_path / "c").iterdir())
    assert names == (["lens.npy", "meta.json", "vectors.npy"] if mode == "on_disk"
                     else ["meta.json", "vectors.npz"])
    loaded = js.MultiVectorStore.load(str(tmp_path / "c"))
    for attr in ("quantized", "prefilter", "pooled_centroids", "on_disk"):
        assert getattr(loaded, attr) == getattr(jstore, attr), attr
    q = _query(50)
    _same_mode_response(tstore.query(q, limit=6), loaded.query(q, limit=6))


def test_on_disk_store_saves_over_its_own_memmap(tmp_path):
    jstore, tstore = _mode_pair("on_disk")
    tstore.save(str(tmp_path / "c"))
    again = ts.MultiVectorStore.load(str(tmp_path / "c"))
    again.save(str(tmp_path / "c"))  # the destination is the memmap being read
    reloaded = ts.MultiVectorStore.load(str(tmp_path / "c"))
    np.testing.assert_array_equal(np.asarray(reloaded._vectors), tstore._vectors)
    reloaded.upsert([ts.PointStruct(id=99, vector=_query(51, 3), payload={"late": True})])
    jstore.upsert([js.PointStruct(id=99, vector=_query(51, 3), payload={"late": True})])
    assert not isinstance(reloaded._vectors, np.memmap)
    q = _query(52)
    _same_mode_response(reloaded.query(q, limit=6), jstore.query(q, limit=6))


def test_gather_rows_reads_memmap_rows_and_views(tmp_path):
    from multimodal_colpali_tpu_torch.store.multivector import _gather_rows

    arr = np.random.default_rng(3).standard_normal((40, 5, 4)).astype(np.float32)
    np.save(tmp_path / "v.npy", arr)
    mm = np.load(tmp_path / "v.npy", mmap_mode="r")
    idx = np.asarray([39, 0, 7, 7, 12, 3, 25, 1, 30])
    np.testing.assert_array_equal(_gather_rows(mm, idx), arr[idx])
    view = mm[10:]  # shares the parent's offset: must not be read by offset
    np.testing.assert_array_equal(_gather_rows(view, idx[idx < 30]), arr[10:][idx[idx < 30]])
    np.testing.assert_array_equal(_gather_rows(arr, idx), arr[idx])


def test_client_creates_quantized_and_on_disk_collections(tmp_path):
    jclient, tclient = js.VectorClient(path=str(tmp_path / "j")), \
        ts.VectorClient(path=str(tmp_path / "t"), device="cpu")
    for client, api, mod in ((jclient, japi, js), (tclient, tapi, ts)):
        api.ensure_colpali_collection(client, "q8", vector_size=DIM, max_tokens=MAX_TOKENS,
                                      quantized=True)
        api.ensure_colpali_collection(client, "disk", vector_size=DIM, max_tokens=MAX_TOKENS,
                                      on_disk=True)
        client.create_collection("pool", mod.VectorParams(
            size=DIM, multivector_config=mod.MultiVectorConfig()), quantized=True,
            prefilter="pooled", max_tokens=MAX_TOKENS)
        for name in ("q8", "disk", "pool"):
            client.upsert(name, _points(mod))
        client.save()
    reopened = ts.VectorClient(path=str(tmp_path / "t"), device="cpu")
    for name, (quantized, prefilter, on_disk) in {"q8": (True, "int8", False),
                                                  "disk": (True, "pooled", True),
                                                  "pool": (True, "pooled", False)}.items():
        store = reopened._get(name)
        assert (store.quantized, store.prefilter, store.on_disk) == (quantized, prefilter, on_disk)
        q = _query(60)
        want = jclient.query_points(name, q, limit=6)
        _same_mode_response(tclient.query_points(name, q, limit=6), want)
        _same_mode_response(reopened.query_points(name, q, limit=6), want)
