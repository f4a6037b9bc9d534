"""The port's dense RAG side against the JAX package, on the CPU: the dense
store, the client's dense branch and its files, the reference-shaped API
(``qdrant_process``, ``TpuVectorStore``, the prompt functions, the multi-user
management, the snapshots), the message formatters, the answer parser, the
documents and the prompts.

The same numpy-seeded inputs go through both packages. The API tests embed
with one numpy embedding object shared by both (``HashEmbeddings``), so the
stores see the same vectors and every difference is the port's; the
self-retrieval test of JAX's ``tests/test_api.py`` runs with the tiny bge
encoder of each package.
"""

import base64
import hashlib
import io
import os
import pickle
import tempfile
import warnings

import numpy as np
import pytest
import torch
from PIL import Image

import jax.numpy as jnp
from multimodal_colpali_tpu import api as japi
from multimodal_colpali_tpu import documents as jdocs
from multimodal_colpali_tpu import prompts as jprompts
from multimodal_colpali_tpu import store as js
from multimodal_colpali_tpu.generation import client as jclient
from multimodal_colpali_tpu.generation import messages as jmsg
from multimodal_colpali_tpu.generation import parse as jparse
from multimodal_colpali_tpu.models.configs import BertConfig as JBertConfig
from multimodal_colpali_tpu.models.text_encoder import BgeEmbeddings as JBge
from multimodal_colpali_tpu_torch import api as tapi
from multimodal_colpali_tpu_torch import documents as tdocs
from multimodal_colpali_tpu_torch import prompts as tprompts
from multimodal_colpali_tpu_torch import store as ts
from multimodal_colpali_tpu_torch.generation import messages as tmsg
from multimodal_colpali_tpu_torch.generation import parse as tparse
from multimodal_colpali_tpu_torch.models.configs import BertConfig
from multimodal_colpali_tpu_torch.models.text_encoder import BgeEmbeddings as TBge
from multimodal_colpali_tpu_torch.store.dense import scores_f32

torch.set_num_threads(1)

DIM, N = 24, 29          # 29 rows: the device copy pads to 32
SCORE_RTOL = 1e-5


def _vectors(seed=0, n=N, dim=DIM):
    return np.random.default_rng(seed).standard_normal((n, dim)).astype(np.float32)


def _payload(i):
    return {"i": i, "username": ["alice", "bob", "carol"][i % 3],
            "meta": {"page": i % 4, "tag": "x" if i % 5 else "y"}}


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


def _pair(distance="COSINE", ids=None, seed=0):
    vecs = _vectors(seed)
    stores = []
    for mod, kw in ((js, {}), (ts, {"device": "cpu"})):
        store = mod.DenseVectorStore("d", dim=DIM, distance=getattr(mod.Distance, distance),
                                     **kw)
        store.upsert([mod.PointStruct(id=i if ids is None else ids[i], vector=vecs[i],
                                      payload=_payload(i)) for i in range(N)])
        stores.append(store)
    return stores, vecs


def _same(jres, tres, ids=True):
    """The same points (ids unless the ids are fresh uuids on each side,
    payloads) with scores within rtol 1e-5."""
    if ids:
        assert [p.id for p in tres.points] == [p.id for p in jres.points]
    assert [p.payload for p in tres.points] == [p.payload for p in jres.points]
    np.testing.assert_allclose([p.score for p in tres.points],
                               [p.score for p in jres.points], rtol=SCORE_RTOL, atol=1e-6)


# -- the store ---------------------------------------------------------------------------

@pytest.mark.parametrize("flt", ["none", "alice", "not_bob", "nested_any", "nobody"])
@pytest.mark.parametrize("limit", [1, 5, N, 40])
@pytest.mark.parametrize("distance", ["COSINE", "DOT"])
def test_query_matches_jax(flt, limit, distance):
    """Ids, payloads and scores (rtol 1e-5) of JAX's store, every filter,
    ``limit`` up to above n (40 > 29 rows, 32 with the padding)."""
    (jstore, tstore), vecs = _pair(distance)
    rng = np.random.default_rng(1)
    for q in (vecs[7] + 0.3 * rng.standard_normal(DIM).astype(np.float32),
              rng.standard_normal(DIM).astype(np.float32) * 5):
        jres = jstore.query(q, limit=limit, query_filter=_filters(js)[flt])
        tres = tstore.query(q, limit=limit, query_filter=_filters(ts)[flt])
        _same(jres, tres)
        assert len(tres.points) <= min(limit, N)
        if flt == "nobody":
            assert tres.points == []


def test_cosine_self_similarity_and_vectors():
    (jstore, tstore), vecs = _pair()
    res = tstore.query(vecs[7], limit=3, with_vectors=True)
    assert res.points[0].id == 7 and res.points[0].score == pytest.approx(1.0, abs=2e-2)
    want = vecs[7] / np.linalg.norm(vecs[7])
    np.testing.assert_allclose(res.points[0].vector, want, rtol=1e-6)
    assert res.points[0].vector == jstore.query(vecs[7], limit=1, with_vectors=True
                                                ).points[0].vector


def test_padding_rows_never_win():
    """All-negative scores: the zero padding rows (score 0) would beat every
    real row without their mask."""
    (jstore, tstore), vecs = _pair()
    q = -vecs.sum(0)
    tres = tstore.query(q, limit=40)
    assert len(tres.points) == N and all(p.id < N for p in tres.points)
    _same(jstore.query(q, limit=40), tres)


def test_ties_break_to_the_lower_index():
    vecs = np.tile(np.eye(DIM, dtype=np.float32)[:1], (6, 1))
    vecs[2] = np.eye(DIM, dtype=np.float32)[1]
    out = []
    for mod, kw in ((js, {}), (ts, {"device": "cpu"})):
        store = mod.DenseVectorStore("t", dim=DIM, **kw)
        store.upsert([mod.PointStruct(id=f"p{i}", vector=vecs[i]) for i in range(6)])
        out.append([p.id for p in store.query(vecs[0], limit=6).points])
    assert out[1] == out[0] == ["p0", "p1", "p3", "p4", "p5", "p2"]


def test_overwrite_in_place_and_delete():
    """An upsert of a stored id overwrites its row (order kept); deletes by
    ids and by filter drop rows and re-index; scroll and count follow."""
    (jstore, tstore), vecs = _pair(ids=[f"id{i}" for i in range(N)])
    newer = _vectors(seed=5, n=3)
    for mod, store in ((js, jstore), (ts, tstore)):
        store.upsert([mod.PointStruct(id=f"id{i}", vector=newer[k], payload={"i": 100 + k,
                      "username": "zed", "meta": {"page": 9}}) for k, i in enumerate((3, 11, 20))])
        store.upsert([mod.PointStruct(id="fresh", vector=newer[0], payload={"i": -1})])
        store.delete(ids=["id0", "id5", "missing"])
        store.delete(flt=_filters(mod)["alice"])
        store.delete()
    assert len(tstore) == len(jstore)
    for q in (newer[1], vecs[4]):
        _same(jstore.query(q, limit=10), tstore.query(q, limit=10))
    assert tstore.query(newer[1], limit=1).points[0].id == "id11"
    for flt in ("none", "not_bob", "nested_any"):
        assert tstore.count(_filters(ts)[flt]) == jstore.count(_filters(js)[flt])
    got, _ = tstore.scroll(limit=100, with_vectors=True)
    want, _ = jstore.scroll(limit=100, with_vectors=True)
    assert [(r.id, r.payload, r.vector) for r in got] == [(r.id, r.payload, r.vector)
                                                          for r in want]


@pytest.mark.parametrize("flt", ["none", "not_bob", "nested_any", "nobody"])
def test_scroll_offsets_match_jax(flt):
    (jstore, tstore), _ = _pair()
    for offset, limit in ((0, 4), (4, 4), (8, 100), (0, N), (27, 5), (40, 3)):
        got, nxt = tstore.scroll(flt=_filters(ts)[flt], limit=limit, offset=offset)
        want, wnxt = jstore.scroll(flt=_filters(js)[flt], limit=limit, offset=offset)
        assert nxt == wnxt
        assert [(r.id, r.payload, r.vector) for r in got] == [(r.id, r.payload, r.vector)
                                                              for r in want]


def test_empty_store_and_bad_dim():
    store = ts.DenseVectorStore("e", dim=DIM, device="cpu")
    assert store.query(np.ones(DIM), limit=3).points == []
    assert store.scroll() == ([], None) and store.count() == 0
    with pytest.raises(ValueError, match="expected dim"):
        store.upsert([ts.PointStruct(id=0, vector=np.ones(DIM + 1))])


def test_device_copy_is_padded_bf16_and_cached():
    (_, tstore), vecs = _pair()
    tstore.query(vecs[0])
    cache = tstore._device_cache
    assert cache.dtype == torch.bfloat16 and cache.shape == (32, DIM)
    assert torch.equal(cache[N:], torch.zeros(3, DIM, dtype=torch.bfloat16))
    tstore.query(vecs[1], query_filter=_filters(ts)["alice"])
    assert tstore._device_cache is cache          # no change, no upload
    tstore.upsert([ts.PointStruct(id=0, vector=vecs[3])])
    tstore.query(vecs[1])
    assert tstore._device_cache is not cache


def test_scores_are_float32_sums_of_bf16_products():
    """The scores keep float32 (not rounded to bf16, which would merge
    near-ties)."""
    corpus = torch.from_numpy(_vectors(seed=3, n=40)).to(torch.bfloat16)
    q = torch.from_numpy(_vectors(seed=4, n=1)[0]).to(torch.bfloat16)
    got = scores_f32(corpus, q)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, corpus.double() @ q.double(), rtol=0, atol=1e-5,
                               check_dtype=False)
    assert not torch.equal(got, got.bfloat16().float())


def test_mesh_raises():
    """The rows shard over a mesh now; a mesh whose backend does not carry
    the store's device raises (a CPU store on an NCCL mesh)."""
    from multimodal_colpali_tpu_torch.parallel import Mesh

    nccl = Mesh.__new__(Mesh)
    nccl.backend = "nccl"
    with pytest.raises(ValueError, match="cpu tensor on a nccl group"):
        ts.DenseVectorStore("d", dim=DIM, mesh=nccl, device="cpu")


# -- files and the client ---------------------------------------------------------------

def _mv_points(mod, seed=6, n=5):
    rng = np.random.default_rng(seed)
    return [mod.PointStruct(id=i, vector=rng.standard_normal((4 + i, 8)).astype(np.float32),
                            payload={"username": "alice" if i % 2 else "bob"})
            for i in range(n)]


def _fill(mod, client):
    client.create_collection("RAG_TEXT", vectors_config=mod.VectorParams(size=DIM))
    client.create_collection("colpali_vd", vectors_config=mod.VectorParams(
        size=8, distance=mod.Distance.COSINE, multivector_config=mod.MultiVectorConfig()),
        max_tokens=10)
    vecs = _vectors()
    client.upsert("RAG_TEXT", [mod.PointStruct(id=f"d{i}", vector=vecs[i], payload=_payload(i))
                               for i in range(N)])
    client.upsert("colpali_vd", _mv_points(mod))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_client_files_load_in_the_other_package(writer, tmp_path):
    """A client directory holding a dense and a multivector collection,
    saved by either package, loads in the other with the same answers."""
    path = str(tmp_path / "vd")
    jclient_ = js.VectorClient(path=None if writer == "port" else path)
    tclient = ts.VectorClient(path=None if writer == "jax" else path, device="cpu")
    _fill(js, jclient_)
    _fill(ts, tclient)
    (jclient_ if writer == "jax" else tclient).save()
    with open(os.path.join(path, "RAG_TEXT", "meta.json")) as f:
        assert '"kind": "dense"' in f.read()
    reader = (ts.VectorClient(path, device="cpu") if writer == "jax"
              else js.VectorClient(path))
    mod = ts if writer == "jax" else js
    direct = tclient if writer == "jax" else jclient_
    assert {c.name for c in reader.get_collections().collections} == {"RAG_TEXT", "colpali_vd"}
    q = _vectors(seed=8, n=1)[0]
    for flt in ("none", "alice"):
        got = reader.query_points("RAG_TEXT", query=q, limit=6,
                                  query_filter=_filters(mod)[flt])
        want = direct.query_points("RAG_TEXT", query=q, limit=6,
                                   query_filter=_filters(ts if writer == "jax" else js)[flt])
        _same(want, got)
    mv = _mv_points(mod)[2].vector
    assert [p.id for p in reader.query_points("colpali_vd", query=mv, limit=3).points] == \
        [p.id for p in direct.query_points("colpali_vd", query=mv, limit=3).points]
    assert reader.count("RAG_TEXT").count == N


def test_client_dense_branch_matches_jax(tmp_path):
    """create / upsert / query_points / scroll / delete / count / save of a
    dense collection through the port's client, against JAX's client."""
    out = []
    for mod, kw in ((js, {}), (ts, {"device": "cpu"})):
        client = mod.VectorClient(path=str(tmp_path / mod.__name__), **kw)
        _fill(mod, client)
        client.delete("RAG_TEXT", mod.PointIdsList(points=["d0", "d1"]))
        client.delete("RAG_TEXT", ["d2"])
        client.delete("RAG_TEXT", mod.FilterSelector(filter=_filters(mod)["alice"]))
        client.delete("RAG_TEXT", _filters(mod)["nested_any"])
        client.save()
        again = mod.VectorClient(path=str(tmp_path / mod.__name__), **kw)
        recs, nxt = again.scroll("RAG_TEXT", scroll_filter=_filters(mod)["not_bob"], limit=3,
                                 with_vectors=True)
        res = again.query_points("RAG_TEXT", query=_vectors(seed=9, n=1)[0], limit=4)
        out.append((again.count("RAG_TEXT").count, [(r.id, r.payload, r.vector) for r in recs],
                    nxt, res))
    assert out[1][:3] == out[0][:3]
    _same(out[0][3], out[1][3])


# -- the API -----------------------------------------------------------------------------

class HashEmbeddings:
    """A deterministic numpy embedding of text (each word hashed to a seed of
    a standard normal vector, summed): the same vectors for both packages."""

    def __init__(self, dim=DIM):
        self.dim = dim
        self.device = "cpu"

    def _one(self, text):
        v = np.zeros(self.dim, np.float32)
        for w in text.lower().split() or [""]:
            seed = int.from_bytes(hashlib.sha1(w.encode()).digest()[:4], "little")
            v += np.random.default_rng(seed).standard_normal(self.dim).astype(np.float32)
        return v

    def embed_documents(self, texts, batch_size=64):
        return [self._one(t).tolist() for t in texts]

    def embed_query(self, text):
        return self._one(text).tolist()


def _meta(mod, name, typ, username="u1", img=""):
    md = mod.make_metadata(name, f"id-{name}-{typ}", document_link=f"doi:{name}", type=typ,
                           page_no=2, img_link=img)
    md["username"] = username
    return md


def _corpus(mod, img_path):
    return [
        mod.Document("glycans bind lectins", _meta(mod, "a.pdf", "text")),
        mod.Document("a figure of selectin binding", _meta(mod, "a.pdf", "image", img=img_path)),
        mod.Document("table of affinity constants", _meta(mod, "b.pdf", "table")),
        mod.Document("other user's glycans", _meta(mod, "c.pdf", "text", username="u2")),
        mod.Document("the weather is sunny", _meta(mod, "d.pdf", "text")),
        mod.Document("lectins in plants", _meta(mod, "e.pdf", "pdf_page")),
    ]


@pytest.fixture
def img_path(tmp_path):
    p = str(tmp_path / "fig.png")
    Image.fromarray(np.full((8, 8, 3), 200, np.uint8)).save(p)
    return p


@pytest.fixture
def clients(img_path):
    emb = HashEmbeddings()
    jc, tc = js.VectorClient(), ts.VectorClient(device="cpu")
    japi.TpuVectorStore.from_documents(_corpus(jdocs, img_path), emb, jc, "mm_vd", emb_dim=DIM)
    tapi.TpuVectorStore.from_documents(_corpus(tdocs, img_path), emb, tc, "mm_vd", emb_dim=DIM)
    return jc, tc, emb


def _docs_equal(got, want):
    assert [(d.page_content, d.metadata) for d, _ in got] == \
        [(d.page_content, d.metadata) for d, _ in want]
    np.testing.assert_allclose([s for _, s in got], [s for _, s in want], rtol=SCORE_RTOL)


def test_qdrant_process_payloads_match_jax(clients, capsys):
    jc, tc, emb = clients
    got, _ = tc.scroll("mm_vd", limit=100, with_vectors=True)
    want, _ = jc.scroll("mm_vd", limit=100, with_vectors=True)
    assert [(r.payload, r.vector) for r in got] == [(r.payload, r.vector) for r in want]
    assert all(isinstance(r.id, str) and len(r.id) == 36 for r in got)   # uuid4 strings
    docs = _corpus(tdocs, "")
    tapi.qdrant_process(docs[:2], tc, "mm_vd", DIM, emb)
    assert tc.count("mm_vd").count == 8
    out = capsys.readouterr().out
    assert "Processing data for colection mm_vd." in out
    assert "Processing of 2 for colection mm_vd complete." in out


@pytest.mark.parametrize("k", [1, 3, 10])
@pytest.mark.parametrize("user", [None, "u1", "u2"])
def test_similarity_search_matches_jax(clients, k, user):
    jc, tc, emb = clients
    flt = {}
    if user:
        flt = {mod: mod.Filter(must=[mod.FieldCondition(
            key="metadata.username", match=mod.MatchValue(value=user))]) for mod in (js, ts)}
    want = japi.TpuVectorStore(jc, "mm_vd", emb).similarity_search_with_score(
        "glycans bind lectins", k=k, filter=flt.get(js))
    got = tapi.TpuVectorStore(tc, "mm_vd", emb).similarity_search_with_score(
        "glycans bind lectins", k=k, filter=flt.get(ts))
    assert all(isinstance(d, tdocs.Document) for d, _ in got)
    _docs_equal(got, want)


@pytest.mark.parametrize("join", [False, True])
@pytest.mark.parametrize("kind", ["", "mm_RAG", "bogus"])
def test_prompt_prep_query_matches_jax(clients, kind, join, capsys):
    jc, tc, emb = clients
    want = japi.prompt_prep_query("what binds lectins?", "Answer: {query}", jc, "u1", "mm_vd",
                                  emb, 4, type=kind, join_context=join)
    got = tapi.prompt_prep_query("what binds lectins?", "Answer: {query}", tc, "u1", "mm_vd",
                                 emb, 4, type=kind, join_context=join)
    assert got["query"] == want["query"] and got["q_prompts"] == want["q_prompts"]
    if kind == "mm_RAG":
        _docs_equal(got["context"], want["context"])
        assert all(d.metadata["username"] == "u1" for d, _ in got["context"])
        parts = [c["type"] for p in (got["q_prompts"] if not join else [got["q_prompts"]])
                 for c in p[0]["content"]]
        assert "image_url" in parts
    else:
        assert got["context"] == want["context"] == []


def test_prompt_prep_query_colpali_matches_jax(img_path, capsys):
    """type="colpali" retrieves pages through retrieve_colpali (a stand-in
    model whose query embedding is fixed) and builds one image prompt a
    page, or one joined prompt; without a model it degrades as JAX does."""
    rng = np.random.default_rng(11)
    pages = [rng.standard_normal((5, 8)).astype(np.float32) for _ in range(6)]
    qvec = pages[4][:3] + 0.1

    class Model:
        def embed_queries(self, queries):
            return [qvec for _ in queries]

    out = []
    for mod, api, kw in ((js, japi, {}), (ts, tapi, {"device": "cpu"})):
        client = mod.VectorClient(**kw)
        api.ensure_colpali_collection(client, "cp", vector_size=8, max_tokens=8)
        client.upsert("cp", [mod.PointStruct(id=i, vector=pages[i], payload={
            "username": "u1" if i % 2 else "u2", "img_link": img_path, "page_no": i})
            for i in range(6)])
        res = [api.prompt_prep_query("glycans", "Q: {query}", client, user, "cp", None, 2,
                                     type="colpali", cp_model=Model(), cp_processor=object(),
                                     join_context=join)
               for user in ("u1", "") for join in (False, True)]
        bad = api.prompt_prep_query("q", "Q: {query}", client, "u1", "cp", None, 2,
                                    type="colpali")
        out.append((res, bad))
    for got, want in zip(out[1][0], out[0][0]):
        assert got["q_prompts"] == want["q_prompts"]
        assert [(p.id, p.payload) for p in got["context"].points] == \
            [(p.id, p.payload) for p in want["context"].points]
    assert len(out[1][0][0]["q_prompts"]) == 2
    assert out[1][0][0]["q_prompts"][0][0]["content"][1]["type"] == "image_url"
    assert out[1][1] == out[0][1] == {"query": "q", "context": [], "q_prompts": []}


@pytest.mark.parametrize("kind", ["", "mm_RAG", "colpali"])
@pytest.mark.parametrize("join", [False, True])
def test_prompt_prep_query_emb_matches_jax(clients, kind, join, capsys):
    jc, tc, emb = clients
    prompts = {"rag_summary_query": "IMG {query}", "text_summary_query": "TXT {query}"}
    qv = emb.embed_query("glycans bind lectins")
    want = japi.prompt_prep_query_emb("glycans?", prompts, jc, "u1", "mm_vd", qv, 3, kind,
                                      join_context=join)
    got = tapi.prompt_prep_query_emb("glycans?", prompts, tc, "u1", "mm_vd", qv, 3, kind,
                                     join_context=join)
    assert got["q_prompts"] == want["q_prompts"]
    if kind == "mm_RAG":
        _same(want["context"], got["context"], ids=False)
    else:
        assert got["context"] == want["context"]


@pytest.mark.parametrize("kind", ["mm_vd", "text_vd", "", "other"])
def test_prompt_prep_query1_matches_jax(clients, kind, capsys):
    jc, tc, emb = clients
    want = japi.prompt_prep_query1("glycans?", "P: {query}", "u1", "mm_vd", emb, 2, kind,
                                   qdrant_client=jc)
    got = tapi.prompt_prep_query1("glycans?", "P: {query}", "u1", "mm_vd", emb, 2, kind,
                                  qdrant_client=tc)
    assert got["q_prompts"] == want["q_prompts"]
    if kind in ("mm_vd", "text_vd"):
        _docs_equal(got["context"], want["context"])
        assert len(got["q_prompts"]) == 2
    else:
        assert got["context"] == want["context"] == []


def test_prompt_prep_query1_degrades_to_an_empty_context(clients, tmp_path, capsys):
    """A missing collection, in the client given or in one loaded from
    ``path``, gives an empty context, as the reference's does."""
    jc, tc, emb = clients
    for client, path in ((tc, ""), (None, str(tmp_path / "none"))):
        got = tapi.prompt_prep_query1("q?", "P: {query}", "u1", "nope", emb, 1, "mm_vd",
                                      qdrant_client=client, path=path)
        assert got == {"query": "q?", "context": [], "q_prompts": []}
    want = japi.prompt_prep_query1("q?", "P: {query}", "u1", "nope", emb, 1, "mm_vd",
                                   qdrant_client=jc)
    assert want == got
    assert capsys.readouterr().out.count("Error accessing qdrant vectorstore") == 3


def test_prompt_prep_query1_reads_a_saved_store(clients, tmp_path, capsys):
    jc, tc, emb = clients
    path = str(tmp_path / "vd")
    saved = ts.VectorClient(path, device="cpu")
    tapi.qdrant_process(_corpus(tdocs, ""), saved, "mm_vd", DIM, emb)
    saved.save()
    got = tapi.prompt_prep_query1("glycans?", "P: {query}", "u1", "mm_vd", emb, 2, "text_vd",
                                  path=path)
    want = tapi.prompt_prep_query1("glycans?", "P: {query}", "u1", "mm_vd", emb, 2, "text_vd",
                                   qdrant_client=saved)
    assert got["q_prompts"] == want["q_prompts"] and len(got["context"]) == 2


def test_prompt_prep_modify_orig_and_show_results(img_path, capsys):
    out = []
    for mod, api in ((jdocs, japi), (tdocs, tapi)):
        docs = _corpus(mod, img_path)
        msgs = api.prompt_prep(docs, "describe: ", "summarize: ")
        new = api.modify_orig([d.copy() for d in docs], [f"gen {i}" for i in range(6)])
        shown = api.show_results([(d, 0.5 + i) for i, d in enumerate(docs)])
        printed = capsys.readouterr().out
        out.append((msgs, [(d.page_content, d.metadata) for d in new], shown, printed))
    assert out[1] == out[0]
    assert out[1][1][1][0] == "gen 1" and out[1][1][0][0] == "glycans bind lectins"


def test_show_results_of_query_points_matches_jax(capsys):
    out = []
    for mod, api, kw in ((js, japi, {}), (ts, tapi, {"device": "cpu"})):
        client = mod.VectorClient(**kw)
        api.ensure_colpali_collection(client, "cp", vector_size=8, max_tokens=8)
        api.colpali_qdrant([{"image": None, "filename": "a.pdf", "page_no": 1,
                             "img_link": "/x.png"}], ["/p/a.pdf"], ["doi:a"],
                           type("M", (), {"embed_images": lambda self, imgs, batch_size:
                                          [np.ones((3, 8), np.float32)] * len(imgs)})(),
                           None, client, "cp")
        res = client.query_points("cp", query=np.ones((2, 8), np.float32), limit=1)
        out.append((api.show_results(res), capsys.readouterr().out.split("Indexing")[0]))
    assert out[1][0] == out[0][0] == [("image", "/x.png")]


def _paper_dir(tmp_path):
    d = tmp_path / "papers"
    d.mkdir()
    for name in ("a.pdf", "b.pdf", "notes.txt"):
        (d / name).write_bytes(b"%PDF")
    return str(d)


def test_get_vd_elements_match_jax(clients, tmp_path):
    jc, tc, emb = clients
    paper_dir = _paper_dir(tmp_path)
    got = tapi.get_vd_elements(tc, "u1", "mm_vd", paper_dir)
    assert got == japi.get_vd_elements(jc, "u1", "mm_vd", paper_dir)
    assert got[0] == ["a.pdf", "b.pdf", "c.pdf", "d.pdf", "e.pdf"]
    assert got[1] == [os.path.join(paper_dir, "a.pdf"), os.path.join(paper_dir, "b.pdf")]
    assert got[2] == ["doi:a.pdf", "doi:b.pdf", "doi:c.pdf", "doi:d.pdf", "doi:e.pdf"]


def _colpali_pair(tmp_path):
    """The same ColPali collection (flat payloads) in both packages, two users."""
    out = []
    for mod, api, kw in ((js, japi, {}), (ts, tapi, {"device": "cpu"})):
        client = mod.VectorClient(**kw)
        api.ensure_colpali_collection(client, "cp", vector_size=8, max_tokens=8)
        pts = _mv_points(mod, n=6)
        for i, p in enumerate(pts):
            p.payload = {"document_name": ["a.pdf", "b.pdf", ""][i % 3], "document_link":
                         f"doi:{i % 3}", "username": "u1" if i < 4 else "u2",
                         "img_link": str(tmp_path / f"cp{i}.png")}
        client.upsert("cp", pts)
        out.append(client)
    return out


@pytest.mark.parametrize("user", ["u1", "u2", ""])
def test_get_vd_elements_colpali_match_jax(tmp_path, user):
    jc, tc = _colpali_pair(tmp_path)
    paper_dir = _paper_dir(tmp_path)
    got = tapi.get_vd_elements_colpali(tc, user, "cp", paper_dir)
    assert got == japi.get_vd_elements_colpali(jc, user, "cp", paper_dir)


def _files(tmp_path, names):
    for n in names:
        (tmp_path / n).write_bytes(b"x")


def test_delete_papers_matches_jax(tmp_path, img_path, capsys):
    """Images, PDFs and points of one user's papers go, in a dense and a
    ColPali collection; the other user's stay."""
    states = []
    for side in ("jax", "port"):
        root = tmp_path / side
        (root / "papers").mkdir(parents=True)
        _files(root / "papers", ["a.pdf", "b.pdf"])
        _files(root, [f"cp{i}.png" for i in range(6)] + ["fig.png"])
        mod, api, docmod = ((js, japi, jdocs) if side == "jax" else (ts, tapi, tdocs))
        client = mod.VectorClient(**({} if side == "jax" else {"device": "cpu"}))
        api.qdrant_process(_corpus(docmod, str(root / "fig.png")), client, "mm_vd", DIM,
                           HashEmbeddings())
        jc, tc = _colpali_pair(root)
        cp = jc if side == "jax" else tc
        client._collections["cp"] = cp._collections["cp"]
        api.delete_papers("u1", ["mm_vd"], ["cp"], str(root), ["a.pdf", "missing.pdf"], client)
        printed = capsys.readouterr().out
        state = (sorted(os.listdir(root)), sorted(os.listdir(root / "papers")),
                 [(r.payload, r.vector) for r in client.scroll("mm_vd", limit=99,
                                                                 with_vectors=True)[0]],
                 [r.payload for r in client.scroll("cp", limit=99)[0]], printed.splitlines())
        states.append(eval(repr(state).replace(str(root), "<root>")))
    got, want = states[1], states[0]
    assert got[:4] == want[:4]
    assert [ln.split(" shows_")[0] for ln in got[4]] == [ln.split(" shows_")[0] for ln in want[4]]
    assert got[0] == ["cp1.png", "cp2.png", "cp4.png", "cp5.png", "papers"]   # a.pdf's, u1's
    assert got[1] == ["b.pdf"]


@pytest.mark.parametrize("link_map", [None, {"/old/": "/new/"}])
def test_update_vd_new_user_matches_jax(tmp_path, link_map):
    jc, tc = _colpali_pair(tmp_path)
    emb = HashEmbeddings()
    for mod, client, docmod in ((js, jc, jdocs), (ts, tc, tdocs)):
        docs = _corpus(docmod, "/old/fig.png")
        (japi if mod is js else tapi).qdrant_process(docs, client, "mm_vd", DIM, emb)
        (japi if mod is js else tapi).update_vd_new_user(client, "alice", ["mm_vd", "cp"],
                                                         img_link_map=link_map)
    for coll in ("mm_vd", "cp"):
        got = [(r.payload, r.vector) for r in tc.scroll(coll, limit=99, with_vectors=True)[0]]
        want = [(r.payload, r.vector) for r in jc.scroll(coll, limit=99, with_vectors=True)[0]]
        assert got == want
    alice = ts.Filter(must=[ts.FieldCondition(key="metadata.username",
                                              match=ts.MatchValue(value="alice"))])
    assert tc.count("mm_vd", alice).count == 6
    if link_map:
        assert any(r.payload["metadata"]["img_link"] == "/new/fig.png"
                   for r in tc.scroll("mm_vd", scroll_filter=alice, limit=99)[0])


def test_tarfile_roundtrip_and_pickle(tmp_path):
    src = tmp_path / "data"
    (src / "RAG_TEXT").mkdir(parents=True)
    (src / "RAG_TEXT" / "meta.json").write_text("{}")
    (src / "x.txt").write_text("hello")
    tar = str(tmp_path / "snap.tar.gz")
    tapi.make_tarfile(tar, str(src))
    for fn, out in ((tapi.setup_initial_vector_db, "restore"), (tapi.extract_tarfile, "x2"),
                    (japi.extract_tarfile, "x3")):
        fn(tar, str(tmp_path / out))
        assert (tmp_path / out / "data" / "x.txt").read_text() == "hello"
        assert (tmp_path / out / "data" / "RAG_TEXT" / "meta.json").read_text() == "{}"
    tapi.save_to_pickle(str(tmp_path / "a.pkl"), x=1, y=[2])
    japi.save_to_pickle(str(tmp_path / "b.pkl"), x=1, y=[2])
    assert (tmp_path / "a.pkl").read_bytes() == (tmp_path / "b.pkl").read_bytes()
    with open(tmp_path / "a.pkl", "rb") as f:
        assert pickle.load(f) == {"x": 1, "y": [2]}


@pytest.mark.parametrize("name,item", [
    ("create_document_embeddings", "item 4"), ("get_img_summary", "item 2"),
    ("process_models", "item 2"), ("models_local", "item 2"), ("models_used", "item 2")])
def test_unported_api_functions_raise(name, item):
    """None of them raises any more: item 4's ``create_document_embeddings``
    (``tests/test_torch_ingest_embed.py`` holds it against JAX's) and item
    2's client functions (``tests/test_torch_utils.py``) are ported, with
    JAX's signatures, and give JAX's output on empty inputs."""
    import asyncio
    import inspect
    import types

    fn = getattr(tapi, name)
    assert inspect.signature(fn).parameters.keys() == \
        inspect.signature(getattr(japi, name)).parameters.keys()
    if item == "item 4":
        empty_dir = tempfile.mkdtemp()
        got = fn(empty_dir, types.SimpleNamespace(device=torch.device("cpu")))
        assert got == getattr(japi, name)(empty_dir, None) == []
        return
    empty = {"get_img_summary": ([], {}, "m", 0, ""), "process_models": ([], {}, []),
             "models_local": ([],), "models_used": ([], [], "RAG_TEXT", [])}[name]
    outs = [f(*empty) for f in (fn, getattr(japi, name))]
    outs = [asyncio.run(o) if inspect.iscoroutine(o) else o for o in outs]
    assert outs[0] == outs[1]


def test_self_retrieval_with_the_bge_encoders():
    """JAX's tests/test_api.py:88-107 in both packages, with each package's
    tiny bge encoder (the same random init): the chunk queried by its own
    text comes back first at a score within 5e-2 of 1."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jbge = JBge(cfg=JBertConfig.tiny())
        tbge = TBge(cfg=BertConfig.tiny(), device="cpu")
    out = []
    for mod, api, docmod, emb, kw in ((js, japi, jdocs, jbge, {}),
                                      (ts, tapi, tdocs, tbge, {"device": "cpu"})):
        client = mod.VectorClient(**kw)
        docs = [docmod.Document("glycans bind lectins", _meta(docmod, "a.pdf", "text")),
                docmod.Document("the weather is sunny", _meta(docmod, "b.pdf", "text"))]
        store = api.TpuVectorStore.from_documents(docs, emb, client, "RAG_TEXT", emb_dim=32)
        hits = store.similarity_search_with_score("glycans bind lectins", k=1)
        assert hits[0][0].page_content == "glycans bind lectins"
        assert hits[0][0].metadata["document_name"] == "a.pdf"
        assert hits[0][1] == pytest.approx(1.0, abs=5e-2)
        out.append(hits[0][1])
    assert out[1] == pytest.approx(out[0], abs=1e-2)
    assert tbge.dtype == torch.bfloat16 and jbge.dtype == jnp.bfloat16


# -- messages, parse, documents, prompts ----------------------------------------------------

def test_message_formatters_match_jax(tmp_path):
    img = Image.fromarray(np.arange(50 * 80 * 3, dtype=np.uint8).reshape(50, 80, 3), "RGB")
    p = str(tmp_path / "i.png")
    img.save(p)
    for fn, args in [
        ("build_choice_string", (["one", "two", "three", "four"],)),
        ("build_instruction_block", ("What is X?", ["a", "b", "c", "d"])),
        ("format_msgs", ("prompt: ", [p], "ctx")), ("format_msgs", ("prompt: ", [], "")),
        ("encode_image", (p,)),
        ("encode_image_to_data_url", (str(tmp_path / "missing.png"),)),
        ("pil_image_to_data_url", (img, 32)),
        ("image_context_messages", ([img, img], 32)),
    ]:
        assert getattr(tmsg, fn)(*args) == getattr(jmsg, fn)(*args), fn
    # the port's PNGs are Up-filtered, Pillow's adaptively filtered: the
    # pixels are equal, the bytes are not (ROADMAP.md, deliberate differences)
    for fn, args in [("encode_image_to_data_url", (p, 64)),
                     ("pil_image_to_data_url", (img, 40, "PNG"))]:
        got, want = getattr(tmsg, fn)(*args), getattr(jmsg, fn)(*args)
        assert got.split(",")[0] == want.split(",")[0] == "data:image/png;base64", fn

        def pixels(url):
            return np.asarray(Image.open(io.BytesIO(base64.b64decode(url.split(",")[1]))))

        np.testing.assert_array_equal(pixels(got), pixels(want), err_msg=fn)
    assert tmsg.build_choice_string(["one", "two", "three", "four"]) == \
        "A. one\nB. two\nC. three\nD. four"


@pytest.mark.parametrize("md", [
    {"document_name": "paper.pdf", "page_no": 3, "type": "text", "img_link": ""},
    {"document_name": "p.pdf", "page_no": 1, "type": "image", "img_link": "/tmp/x.png"},
    {"file_name": "f.pdf", "page_id": 0, "type": "pdf_page"},
    {"type": "table"}, {}])
def test_context_entries_match_jax(md):
    assert tmsg.build_reference_from_metadata(md) == jmsg.build_reference_from_metadata(md)
    got = tmsg.document_to_context_entry(tdocs.Document("body text", dict(md)), 0.7)
    want = jmsg.document_to_context_entry(jdocs.Document("body text", dict(md)), 0.7)
    assert got == want


@pytest.mark.parametrize("resp,perm,want", [
    ("A", [0, 1, 2, 3], ("A", "A")),
    ("A", [2, 0, 1, 3], ("A", "C")),
    ("B", [2, 0, 1, 3], ("B", "A")),
    ('"B is right"', [0, 1, 2, 3], ("B", "B")),
    ('{"answer": "C"}', [0, 1, 2, 3], ("C", "C")),
    ("The answer is: D obviously", [0, 1, 2, 3], ("D", "D")),
    ("no letters here", [0, 1, 2, 3], ("", "")),
    (None, [0, 1, 2, 3], ("", "")),
    (jclient.ERROR_SENTINEL, [0, 1, 2, 3], ("", "")),
    ('"zzz"', [3, 2, 1, 0], ("", "")),
    ("answer: b", [3, 2, 1, 0], ("B", "C")),
])
def test_response_real_out_matches_jax(resp, perm, want):
    assert tparse.response_real_out(resp, perm) == jparse.response_real_out(resp, perm) == want
    assert tparse.identity_perm() == jparse.identity_perm() == [0, 1, 2, 3]


def test_documents_match_jax():
    assert tdocs.METADATA_KEYS == jdocs.METADATA_KEYS and tdocs.DOC_TYPES == jdocs.DOC_TYPES
    args = ("n.pdf", "id1", "doi:x", "table", "4", "r", "c", "/i.png")
    assert tdocs.make_metadata(*args) == jdocs.make_metadata(*args)
    with pytest.raises(ValueError, match="type must be one of"):
        tdocs.make_metadata("n", "i", type="video")
    for md in ({}, {"type": "x"}, jdocs.make_metadata("n", "i"),
               dict(jdocs.make_metadata("n", "i"), type="bad")):
        assert tdocs.validate_metadata(md) == jdocs.validate_metadata(md)
    d = tdocs.Document("t", {"a": 1})
    assert tdocs.Document.from_dict(d.to_dict()) == d and d.copy() is not d
    assert d.to_dict() == jdocs.Document("t", {"a": 1}).to_dict()


def test_prompts_match_jax(tmp_path):
    assert tprompts.DEFAULT_PROMPTS == jprompts.DEFAULT_PROMPTS
    tprompts.save_default_prompts(str(tmp_path / "p.pkl"))
    assert jprompts.load_prompts(str(tmp_path / "p.pkl")) == tprompts.DEFAULT_PROMPTS
    assert tprompts.load_prompts(None) == jprompts.load_prompts(None)
    assert tprompts.load_prompts(str(tmp_path / "missing.pkl")) == tprompts.DEFAULT_PROMPTS
    (tmp_path / "bad.pkl").write_bytes(b"not a pickle")
    assert tprompts.load_prompts(str(tmp_path / "bad.pkl")) == \
        jprompts.load_prompts(str(tmp_path / "bad.pkl"))
