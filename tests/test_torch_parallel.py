"""The port's multi-rank paths against the single-device port and the JAX
package, on the CPU.

Each world of 2 or 4 ranks is started once for the module: the ranks are
processes running ``tests/parallel_worker.py``, which join a gloo group
through ``initialize_distributed`` with a ``file://`` rendezvous under the
test's temporary directory (no ports, so xdist workers cannot clash), run
every sharded path at tiny sizes and write their results to ``.npz``. A
world that does not finish in ``WORLD_TIMEOUT`` seconds is killed and its
tests fail. Every case compares the ranks' results with each other, with
the single-device port and with the JAX package on a mesh of the same shape
over conftest's 8 virtual devices: the same ids (ties to the lower global
index), float32 scores within 1e-6 (relative; a shard's products may sum
in another order than the whole corpus'), embeddings within JAX's 2e-2
(tests/test_retriever.py:121), and equal greedy streams.
"""

import os
import subprocess
import sys
import time
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh, NamedSharding, PartitionSpec as P

import parallel_worker as W
from multimodal_colpali_tpu.generation import engine as JE, paged as JPG, scheduler as JSC
from multimodal_colpali_tpu.models import configs as JC
from multimodal_colpali_tpu.models import registry as JR
from multimodal_colpali_tpu.models.colpali import ColPaliModel as JColPali
from multimodal_colpali_tpu.models.idefics3 import LlamaTextConfig as JLlama
from multimodal_colpali_tpu.models.processing import ColPaliProcessor as JProcessor
from multimodal_colpali_tpu.models.qwen2vl import Qwen2TextConfig as JQwen2
from multimodal_colpali_tpu.ops import topk as JT, two_stage as J2
from multimodal_colpali_tpu.parallel import mesh as JM
from multimodal_colpali_tpu.store import dense as JD, multivector as JMV
from multimodal_colpali_tpu.store import types as jt
from multimodal_colpali_tpu_torch import parallel as TP
from multimodal_colpali_tpu_torch.ops import two_stage as T2
from multimodal_colpali_tpu_torch.ops.maxsim import maxsim_scores
from multimodal_colpali_tpu_torch.ops.topk import topk_with_stable_ties

torch.set_num_threads(1)

WORLD_TIMEOUT = 120.0
WORKER = Path(W.__file__)


def _start(world: int, root: Path):
    root.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(W.REPO))
    procs = [subprocess.Popen([sys.executable, str(WORKER), str(world), str(r),
                               str(root / "rendezvous"), str(root)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    return procs, time.monotonic()


def _finish(procs, t0, root: Path):
    """Every rank's results, or a failure: a rank that failed, or a world
    still running after WORLD_TIMEOUT (its ranks killed)."""
    logs = []
    for r, p in enumerate(procs):
        try:
            out, _ = p.communicate(timeout=max(WORLD_TIMEOUT - (time.monotonic() - t0), 1.0))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            for q in procs:
                q.communicate()
            pytest.fail(f"a world of {len(procs)} ranks hung past {WORLD_TIMEOUT} s")
        logs.append((p.returncode, out))
    for r, (rc, out) in enumerate(logs):
        assert rc == 0, f"rank {r} of {len(procs)} failed:\n{out[-4000:]}"
    res = []
    for r in range(len(procs)):
        with np.load(root / f"rank{r}.npz") as z:
            res.append({k: z[k] for k in z.files})
    for r, got in enumerate(res[1:], 1):   # every rank ends with the same answer
        assert got.keys() == res[0].keys()
        for k in got:
            if "owns" not in k:
                np.testing.assert_array_equal(got[k], res[0][k], err_msg=f"rank {r}: {k}")
    return res


class _Worlds:
    """Both worlds, started at once; ``worlds[n]`` waits for world ``n`` and
    is every rank's results, so a test's single-device and JAX work runs
    while the ranks do."""

    def __init__(self, root: Path):
        self._root = root
        self._started = {n: _start(n, root / f"w{n}") for n in (2, 4)}
        self._done: dict = {}

    def __getitem__(self, n: int):
        if n not in self._done:
            procs, t0 = self._started[n]
            self._done[n] = _finish(procs, t0, self._root / f"w{n}")
        return self._done[n]

    def close(self) -> None:
        """Stop the ranks of a world no test read."""
        for n, (procs, _) in self._started.items():
            if n not in self._done:
                for p in procs:
                    p.kill()
                    p.communicate()


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    w = _Worlds(tmp_path_factory.mktemp("worlds"))
    yield w
    w.close()


def _jmesh(shape, axes):
    n = int(np.prod(shape))
    return JMesh(np.array(jax.devices()[:n]).reshape(shape), axes)


def _t(a):
    return torch.from_numpy(np.asarray(a))


# -- the programming model --------------------------------------------------------------

def test_initialize_distributed_is_a_noop_without_an_address(monkeypatch):
    for var in ("JAX_COORDINATOR_ADDRESS", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    TP.initialize_distributed(device="cpu")
    assert not torch.distributed.is_initialized()


def test_a_mesh_needs_an_initialised_group():
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="initialised process group"):
        TP.get_mesh(("corpus",))


def test_a_tensor_on_the_wrong_backend_raises():
    """A gloo mesh takes CPU tensors only; an NCCL mesh CUDA tensors only."""
    for backend, dev in (("gloo", "meta"), ("nccl", "cpu")):
        mesh = types.SimpleNamespace(backend=backend)
        with pytest.raises(ValueError, match=f"on a {backend} group"):
            TP.Mesh.check(mesh, torch.empty(1, device=dev))


@pytest.mark.parametrize("n,axis_size,rank,want", [
    (17, None, 0, (0, 24, 24)),       # no mesh: padded to 8
    (17, 4, 2, (12, 18, 24)),         # lcm(4, 8) = 8
    (17, 3, 1, (8, 16, 24)),          # lcm(3, 8) = 24
    (48, 3, 2, (32, 48, 48)),
])
def test_shard_range_pads_to_lcm_and_splits_evenly(n, axis_size, rank, want):
    mesh = None if axis_size is None else types.SimpleNamespace(
        size=lambda axis: axis_size, index=lambda axis: rank)
    assert TP.shard_range(mesh, "corpus", n) == want
    rows = np.arange(n * 2, dtype=np.float32).reshape(n, 2)
    got = TP.rank_rows(rows, want[0], want[1], torch.device("cpu"))
    assert got.shape == (want[1] - want[0], 2)
    live = max(min(n, want[1]) - want[0], 0)
    np.testing.assert_array_equal(got[:live].numpy(), rows[want[0]: want[0] + live])
    assert not got[live:].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_row_dots_scores_a_row_alike_at_every_place(monkeypatch, dtype):
    """A copy of one row at every place of a batch, and in slices of 7 rows,
    scores bit-equal; the values match a float64 product of the same
    operands within float32's rounding."""
    from multimodal_colpali_tpu_torch.ops import topk as TT

    rng = np.random.default_rng(4)
    for n, d in ((37, 128), (130, 16), (9, 24)):
        rows = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32)).to(dtype)
        v = torch.from_numpy(rng.standard_normal(d).astype(np.float32)).to(dtype)
        same = rows[0].expand(n, d).contiguous()
        got = TT.row_dots(same, v)
        assert (got == got[0]).all()
        want = (rows.double() @ v.double()).float()
        np.testing.assert_allclose(TT.row_dots(rows, v).numpy(), want.numpy(), rtol=1e-5,
                                   atol=1e-5)
        monkeypatch.setattr(TT, "ROW_DOTS_SLICE", 7)
        assert torch.equal(TT.row_dots(rows, v), TT.row_dots(rows[None], v)[0])
        assert torch.equal(TT.row_dots(same, v), got)
        monkeypatch.undo()


@pytest.mark.parametrize("weight_dtype", ["native", "int8"])
def test_shard_params_for_tp_matches_jax_shards(weight_dtype):
    """Each rank's slice of a tiny Gemma-3 tree equals the shard JAX's
    ``shard_params_for_tp`` places on the device at that ``model``
    coordinate; 1-D leaves JAX replicates are whole here, except a column
    key's, which are the matching slice."""
    from multimodal_colpali_tpu_torch.models import registry as TR
    from multimodal_colpali_tpu_torch.ops.quant import quantize_lm_params

    cfg = W.decode_model("gemma3kv2")[0]
    tree = TR.gemma3_random_params(cfg, seed=3, dtype=torch.float32, device="cpu")
    if weight_dtype == "int8":
        tree = quantize_lm_params(tree)
    jtree = jax.tree.map(lambda x: jnp.asarray(x.numpy()), tree)
    jmesh = _jmesh((1, 2), ("data", "model"))
    placed = JM.shard_params_for_tp(jtree, jmesh, axis="model")
    devs = list(jmesh.devices.reshape(-1))
    flat_j = dict(jax.tree_util.tree_leaves_with_path(placed))
    for rank in range(2):
        mesh = types.SimpleNamespace(size=lambda a: 2, index=lambda a, r=rank: r)
        mine = TP.shard_params_for_tp(tree, mesh, "model")
        for path, leaf in jax.tree_util.tree_leaves_with_path(mine):
            keys = [getattr(k, "key", str(k)) for k in path]
            jleaf = flat_j[path]
            shard = next(s for s in jleaf.addressable_shards if s.device == devs[rank])
            want = np.asarray(shard.data)
            col = any(k in keys for k in TP.mesh.COL_KEYS)
            if leaf.dim() == 1 and col:   # JAX keeps it whole; the rank's slice here
                want = np.split(np.asarray(jleaf), 2)[rank]
            np.testing.assert_array_equal(leaf.numpy(), want, err_msg="/".join(keys))


# -- the sharded corpus ----------------------------------------------------------------

@pytest.mark.parametrize("name", list(W.topk_inputs()))
def test_sharded_maxsim_topk(worlds, name):
    """Random pages, equal pages on every shard, and k above a shard's page
    count, against the single-device port; the last two also against JAX's
    sharded top-k (which compiles anew at every call)."""
    q, d, dl, k = W.topk_inputs()[name]
    want_v, want_i = topk_with_stable_ties(maxsim_scores(_t(q), _t(d), None, _t(dl)), k)
    if name != "rand":
        jv, ji = JT.sharded_maxsim_topk(_jmesh((4,), ("corpus",)), "corpus", jnp.asarray(q),
                                        jnp.asarray(d), jnp.asarray(dl), k, use_pallas=False)
        np.testing.assert_array_equal(want_i.numpy(), np.asarray(ji))
        np.testing.assert_allclose(want_v.numpy(), np.asarray(jv), rtol=1e-6, atol=1e-6)
    got_v, got_i = worlds[4][0][f"topk/{name}/v"], worlds[4][0][f"topk/{name}/i"]
    np.testing.assert_array_equal(got_i, want_i.numpy())
    np.testing.assert_allclose(got_v, want_v.numpy(), rtol=1e-6, atol=1e-6)
    if name == "ties":
        assert got_i.tolist() == [[0, 1, 2, 3]]


@pytest.mark.parametrize("name", list(W.TWO_STAGE_CASES))
def test_sharded_two_stage(worlds, name):
    """With and without the originals, over 1 and 4 centroids a page,
    against the single-device port, and JAX's sharded search for the FPS
    prefilter with originals (JAX compiles its sharded search anew at every
    call)."""
    cents, full = W.TWO_STAGE_CASES[name]
    q, d, dl = W.two_stage_inputs()
    got_v, got_i = worlds[4][0][f"two/{name}/v"], worlds[4][0][f"two/{name}/i"]
    pooled, codes, scales = T2.build_two_stage_index(_t(d), _t(dl), n_centroids=cents)
    want_v, want_i = T2.two_stage_maxsim_topk(_t(q), q.shape[0], pooled, codes, scales, _t(dl),
                                              k=5, n_candidates=16,
                                              d_full=_t(d) if full else None)
    np.testing.assert_array_equal(got_i, want_i.numpy())
    np.testing.assert_allclose(got_v, want_v.numpy(), rtol=1e-6, atol=1e-6)
    if name != "fps4_full":
        return
    jmesh = _jmesh((4,), ("corpus",))
    put = lambda x: jax.device_put(x, NamedSharding(jmesh, P("corpus")))  # noqa: E731
    jp, jc, js = J2.build_two_stage_index(jnp.asarray(d), jnp.asarray(dl), n_centroids=cents)
    jv, ji = J2.sharded_two_stage_maxsim_topk(
        jmesh, "corpus", jnp.asarray(q), jnp.int32(q.shape[0]), put(jp), put(jc), put(js),
        put(jnp.asarray(dl)), k=5, n_candidates=16,
        d_full=put(jnp.asarray(d)) if full else None)
    np.testing.assert_array_equal(got_i, np.asarray(ji))
    np.testing.assert_allclose(got_v, np.asarray(jv), rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module")
def single_store_results():
    return W.store_results(None)


def _jax_store(mode, mesh):
    vecs, _ = W.store_points()
    kw = W.STORE_MODES.get(mode)
    if kw is None:
        store = JD.DenseVectorStore("dense", dim=16, dtype=jnp.float32, mesh=mesh)
        store.upsert([jt.PointStruct(id=i, vector=v[0], payload={"g": i % 3})
                      for i, v in enumerate(vecs)])
    else:
        store = JMV.MultiVectorStore(mode, dim=16, max_tokens=12, dtype=jnp.float32, mesh=mesh,
                                     **kw)
        store.upsert([jt.PointStruct(id=i, vector=v, payload={"g": i % 3})
                      for i, v in enumerate(vecs)])
    return store


JAX_STORE_MODES = ("exact", "int8", "pooled", "dense")


@pytest.mark.parametrize("mode", [*W.STORE_MODES, "dense"])
def test_sharded_store(worlds, single_store_results, mode):
    """A ``VectorClient(mesh=)`` collection over 4 ranks against the
    single-device port (3 queries x 4 searches: with and without a payload
    filter, int8 without rescore, a limit past the corpus) in the exact, int8
    prefilter, pooled (mean and 3 FPS centroids) and dense modes, and JAX's
    store sharded over 4 devices (the query near two tied points) in all but
    the FPS one."""
    store = _jax_store(mode, _jmesh((4,), ("corpus",))) if mode in JAX_STORE_MODES else None
    _, queries = W.store_points()
    for n, q in enumerate(queries):
        for m, (limit, g, rescore, over) in enumerate(W.store_queries()):
            key = f"store/{mode}/{n}/{m}"
            ids, scores = worlds[4][0][key + "/ids"], worlds[4][0][key + "/scores"]
            want_ids, want_scores = single_store_results[key]
            np.testing.assert_array_equal(ids, want_ids, err_msg=key)
            np.testing.assert_allclose(scores, want_scores, rtol=1e-6, atol=1e-6, err_msg=key)
            if (n, m) != (1, 0) or mode not in JAX_STORE_MODES:
                continue   # JAX's sharded search compiles anew at every call
            flt = None if g is None else jt.Filter(
                must=[jt.FieldCondition(key="g", match=jt.MatchValue(value=g))])
            if mode == "dense":
                r = store.query(q[0], limit=limit, query_filter=flt)
            else:
                r = store.query(q, limit=limit, query_filter=flt, search_params=jt.SearchParams(
                    quantization=jt.QuantizationSearchParams(rescore=rescore,
                                                             oversampling=over)))
            np.testing.assert_array_equal(ids, [p.id for p in r.points], err_msg=key)
            np.testing.assert_allclose(scores, [p.score for p in r.points], rtol=1e-6, atol=1e-6,
                                       err_msg=key)


def test_on_disk_refuses_a_mesh_and_the_client_drops_it(tmp_path):
    """on_disk with a mesh is JAX's ValueError; the client makes and loads an
    on_disk collection without its mesh (client.py:66-94)."""
    import multimodal_colpali_tpu_torch.store as ts

    fake = types.SimpleNamespace(check=lambda t: None)
    with pytest.raises(ValueError, match="mutually exclusive"):
        ts.MultiVectorStore("c", dim=16, device="cpu", on_disk=True, mesh=fake)
    client = ts.VectorClient(path=str(tmp_path), device="cpu", mesh=fake)
    client.create_collection("c", ts.VectorParams(
        size=16, multivector_config=ts.MultiVectorConfig(
            comparator=ts.MultiVectorComparator.MAX_SIM), on_disk=True))
    assert client._get("c").mesh is None
    client.upsert("c", [ts.PointStruct(id=0, vector=np.ones((2, 16), np.float32))])
    client.save()
    again = ts.VectorClient(path=str(tmp_path), device="cpu", mesh=fake)
    assert again._get("c").on_disk and again._get("c").mesh is None


def test_distributed_corpus_view(worlds):
    """tests/test_distributed.py's scenario over 2 ranks: page 11 lives on
    rank 1 and wins its own query, which only rank 1 ``owns``; both ranks
    return the same ids, and they equal the single-device two-stage
    search and JAX's view on a 2-device mesh; the exact view equals the
    single-device MaxSim top-k."""
    from multimodal_colpali_tpu.store.distributed import DistributedCorpusView as JView

    res = worlds[2][0]
    full = W.view_inputs()
    assert res["view/i"][0] == 11 and int(res["view/len"]) == 16
    assert [bool(r["view/owns11"]) for r in worlds[2]] == [False, True]
    vecs = full / np.linalg.norm(full, axis=-1, keepdims=True)
    d = _t(vecs).to(torch.bfloat16)
    lens = torch.full((16,), 4, dtype=torch.int32)
    pooled, codes, scales = T2.build_two_stage_index(d, lens)
    q = full[11] / np.linalg.norm(full[11], axis=-1, keepdims=True)
    want_v, want_i = T2.two_stage_maxsim_topk(_t(q), 4, pooled, codes, scales, lens, k=3,
                                              n_candidates=12, d_full=d)
    np.testing.assert_array_equal(res["view/i"], want_i.numpy())
    np.testing.assert_allclose(res["view/v"], want_v.numpy(), rtol=1e-6, atol=1e-6)
    jmesh = _jmesh((2,), ("corpus",))
    jv = JView(full, np.full(16, 4, np.int32), mesh=jmesh, prefilter="pooled")
    jvals, jids = jv.query(full[11], limit=3, oversampling=4.0)
    np.testing.assert_array_equal(res["view/i"], jids)
    np.testing.assert_allclose(res["view/v"], jvals, rtol=1e-6, atol=1e-6)
    q5 = full[5] / np.linalg.norm(full[5], axis=-1, keepdims=True)
    xv, xi = topk_with_stable_ties(maxsim_scores(_t(q5)[None], _t(vecs), None, lens), 4)
    np.testing.assert_array_equal(res["view_exact/i"], xi[0].numpy())
    np.testing.assert_allclose(res["view_exact/v"], xv[0].numpy(), rtol=1e-6, atol=1e-6)
    assert res["view_exact/i"][0] == 5


# -- data-parallel embedding -----------------------------------------------------------

def test_data_parallel_embedding(worlds):
    """5 images (the batch padded to 8) and 2 queries at ``data`` = 4 against
    the single-device port and JAX's Retriever on a (4, 1) mesh."""
    res = worlds[4][0]
    single = W.embed_results(None)
    with np.load(W.REPO / "goldens" / "tiny-colpali_params.npz") as z:
        flat = {k: z[k] for k in z.files}
    nested: dict = {}
    for key, val in flat.items():
        *parents, leaf = key.split("/")
        node = nested
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(val)
    cfg = JC.ColPaliModelConfig.tiny()
    jr = JR.Retriever(name="tiny-colpali", model=JColPali(cfg), params=nested,
                      processor=JProcessor(cfg), dtype=jnp.float32,
                      mesh=_jmesh((4, 1), ("data", "model")))
    jimg = jr.embed_images(W.embed_images(), batch_size=8)
    jq = jr.embed_queries(W.EMBED_QUERIES)
    assert len(jimg) == 5
    for key, want in single.items():
        kind, i = key.split("/")[1:]
        np.testing.assert_allclose(res[key], want, rtol=0, atol=1e-5, err_msg=key)
        jwant = (jimg if kind == "img" else jq)[int(i)]
        np.testing.assert_allclose(res[key], jwant, rtol=0, atol=2e-2, err_msg=key)


def _nested(flat):
    tree: dict = {}
    for key, val in flat.items():
        *parents, leaf = key.split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(val)
    return tree


def _jax_family_retriever(case, mesh):
    name, _, _ = W.EMBED_CASES[case]
    params = _nested(W.goldens_params(name))
    if case == "colqwen2.5":
        from multimodal_colpali_tpu.models import qwen2vl as JQ
        from multimodal_colpali_tpu.models.processing_qwen2vl import ColQwen2Processor

        cfg = JQ.ColQwen2ModelConfig.tiny_25()
        return JR.Retriever(name=name, model=JQ.ColQwen2Model(cfg), params=params,
                            processor=ColQwen2Processor(cfg, dynamic_resolution=True),
                            dtype=jnp.float32, family="colqwen2", mesh=mesh)
    if case == "colidefics3_split":
        from multimodal_colpali_tpu.models import idefics3 as JI
        from multimodal_colpali_tpu.models.processing_idefics3 import ColIdefics3Processor

        cfg = JI.ColIdefics3ModelConfig.tiny()
        return JR.Retriever(name=name, model=JI.ColIdefics3Model(cfg), params=params,
                            processor=ColIdefics3Processor(cfg, image_splitting=True),
                            dtype=jnp.float32, family="colidefics3", mesh=mesh)
    cfg = JC.ColPaliModelConfig.tiny()
    return JR.Retriever(name=name, model=JColPali(cfg), params=params,
                        processor=JProcessor(cfg), dtype=jnp.float32, quantize="int8",
                        mesh=mesh)


@pytest.mark.parametrize("case", list(W.EMBED_CASES))
def test_data_parallel_embedding_families(worlds, case):
    """The families whose batches split another way, data-parallel at the
    world's size (``parallel_worker.EMBED_CASES``): ColQwen2.5 over two grids
    (``position_ids`` split on axis 1), SmolVLM's tiled batches, W8A8 ColPali;
    each batch of 2 padded to the ``data`` size. Against the single-device
    port (atol 1e-5) and JAX's Retriever on a mesh of the same shape: 2e-2,
    or for W8A8 a per-token cosine of at least 0.999 (test_torch_w8a8.py's
    bound: JAX's int8 activations round apart from the port's)."""
    size = W.EMBED_CASES[case][2]
    res = worlds[size][0]
    single = W.embed_results(None, case)
    jr = _jax_family_retriever(case, _jmesh((size, 1), ("data", "model")))
    jimg = jr.embed_images(W.embed_case_pages(case), batch_size=2)
    jq = jr.embed_queries(W.EMBED_QUERIES)
    assert len(jimg) == 5 and len(single) == 7
    if case == "colidefics3_split":
        assert len({e.shape for e in jimg}) >= 2           # more than one tiling
    for key, want in single.items():
        kind, i = key.split("/")[2:]
        np.testing.assert_allclose(res[key], want, rtol=0, atol=1e-5, err_msg=key)
        jwant = (jimg if kind == "img" else jq)[int(i)]
        assert res[key].shape == jwant.shape, key
        if case == "colpali_int8":
            assert float(np.min(np.sum(res[key] * jwant, axis=-1))) >= 0.999, key
        else:
            np.testing.assert_allclose(res[key], jwant, rtol=0, atol=2e-2, err_msg=key)


# -- tensor- and data-parallel decode --------------------------------------------------

_JAX_LM = {}
_JAX_ENGINES = {}
_JAX_STREAMS = {}


def _jax_lm(model):
    """(JAX config, JAX tree) of a tiny decode model: the port's tree as numpy."""
    if model not in _JAX_LM:
        cfg, tree = W.decode_model(model)
        if model == "gemma1":
            jcfg = JC.ColPaliModelConfig.tiny().text
        elif model == "gemma3kv2":
            jcfg = JC.Gemma3TextConfig(**{f: getattr(cfg, f) for f in (
                "vocab_size", "hidden_size", "intermediate_size", "num_hidden_layers",
                "num_attention_heads", "num_key_value_heads", "head_dim", "sliding_window",
                "sliding_window_pattern", "query_pre_attn_scalar")})
        else:
            jcfg = JQwen2.tiny() if model == "qwen2" else JLlama.tiny_lm()
        _JAX_LM[model] = (jcfg, jax.tree.map(lambda x: jnp.asarray(x.numpy()), tree))
    return _JAX_LM[model]


def _jax_streams(case, shape):
    """JAX's greedy streams on a mesh of ``shape``: its engine's ``generate``
    (which JAX's own tests pin to its batchers' streams, tests/
    test_serving_sharded.py), except for int8 pools, whose rounding only
    JAX's paged batcher has. One engine a (model, weights, mesh). The port's
    speculative streams equal greedy decode; JAX's acceptance is one draft
    off (ROADMAP F6), so they are held against the plain streams."""
    name, eng_cls, model, wd, bat, kw = case
    cls = JPG.PagedContinuousBatcher if kw.get("kv_dtype") == "int8" else None
    key = (model, wd, shape, cls)
    if key not in _JAX_STREAMS:
        ekey = (model, wd, shape)
        if ekey not in _JAX_ENGINES:
            jcfg, jtree = _jax_lm(model)
            _JAX_ENGINES[ekey] = getattr(JE, eng_cls)(jcfg, jtree, weight_dtype=wd,
                                                      mesh=_jmesh(shape, ("data", "model")))
        eng = _JAX_ENGINES[ekey]
        run = eng if cls is None else cls(eng, batch_slots=4, max_seq_len=64, chunk=3, **kw)
        _JAX_STREAMS[key] = run.generate(W.PROMPTS, max_new_tokens=W.NEW_TOKENS)
    return _JAX_STREAMS[key]


@pytest.mark.parametrize("mesh_name,case", [
    *(("dp2tp2", c) for c in W.decode_cases()),
    *(("tp2", c) for c in W.decode_cases() if c[0] in W.TP2_CASES)],
    ids=lambda x: x if isinstance(x, str) else x[0])
def test_sharded_decode_streams(worlds, mesh_name, case):
    """Greedy streams of every batcher tier (dense, paged with preemption,
    int8 pools, int8 weights, speculative) and of ``generate`` for Gemma-1,
    Gemma-3 with 2 KV heads (the pools split their heads), Qwen2 (q/k/v
    biases) and Llama, on a (2, 2) DP x TP mesh of 4 ranks and a (1, 2) TP
    mesh of 2, against the single-device port and JAX on the same mesh."""
    res = worlds[2 if mesh_name == "tp2" else 4][0]
    got = res[f"decode/{mesh_name}/{case[0]}"]
    want, pre = W.run_decode(case, None)
    np.testing.assert_array_equal(got, W.streams_array(want))
    assert int(res[f"decode/{mesh_name}/{case[0]}/preemptions"]) == pre
    shape = (1, 2) if mesh_name == "tp2" else (2, 2)
    jwant = _jax_streams(case, shape)
    np.testing.assert_array_equal(got, W.streams_array(jwant))


def test_tp_refusals():
    """int4 weights refuse a mesh (JAX's ValueError, engine.py:387-393);
    a head count no rank split serves is a ValueError."""
    from multimodal_colpali_tpu_torch.generation.engine import GemmaDecodeEngine, tp_head_plan
    from multimodal_colpali_tpu_torch.models import configs as TC

    cfg, params = W.decode_model("gemma3kv2")
    fake = types.SimpleNamespace(check=lambda t: None, size=lambda a: 2, index=lambda a: 0)
    with pytest.raises(ValueError, match="int4"):
        GemmaDecodeEngine(cfg, params, device="cpu", weight_dtype="int4", mesh=fake)
    assert tp_head_plan(TC.Gemma3TextConfig.gemma3_27b(), 4, 3) == (24, 8, 12, 4)
    assert tp_head_plan(TC.Gemma3TextConfig.tiny(), 2, 1) == (1, 1, 0, 1)
    with pytest.raises(ValueError, match="do not split"):
        tp_head_plan(TC.Gemma3TextConfig.tiny(), 4, 0)
    with pytest.raises(ValueError, match="GQA groups"):
        tp_head_plan(types.SimpleNamespace(num_attention_heads=6, num_key_value_heads=3), 2, 0)
