"""One rank of a gloo world for ``tests/test_torch_parallel.py``.

Run as ``python tests/parallel_worker.py WORLD RANK RENDEZVOUS_FILE OUT_DIR``:
the rank joins the group through ``initialize_distributed(file://...)``,
runs every sharded path of the port for its world size on the CPU and writes
what it got to ``OUT_DIR/rank<RANK>.npz``. The test compares those results
with the single-device port and with the JAX package on a mesh of the same
shape. The inputs are made here from numpy seeds; the test imports the same
functions, so both sides see the same numbers. This module imports torch and
the port only.
"""

from __future__ import annotations

import contextlib
import os
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
PROMPTS = [[5, 9, 17, 3], [40, 2], list(range(3, 24)), [7, 30, 8, 2, 19]]
NEW_TOKENS = 8


# -- inputs, shared with the test ---------------------------------------------------------

def _normed(rng, shape):
    x = rng.standard_normal(shape).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def topk_inputs():
    """(name -> (q, d, d_lens, k)) for the sharded MaxSim top-k cases
    (tests/test_topk.py:40-90): random pages, a corpus of equal pages (ties
    across shards), and k above the pages a shard holds."""
    rng = np.random.default_rng(11)
    rand = (_normed(rng, (2, 4, 128)), _normed(rng, (64, 8, 128)),
            rng.integers(1, 9, 64).astype(np.int32), 5)
    q = np.zeros((1, 1, 128), np.float32)
    q[0, 0, 0] = 1.0
    d = np.zeros((16, 1, 128), np.float32)
    d[:, 0, 0] = 1.0
    ties = (q, d, np.ones(16, np.int32), 4)
    big = (_normed(rng, (1, 2, 128)), _normed(rng, (16, 4, 128)), np.full(16, 4, np.int32), 6)
    return {"rand": rand, "ties": ties, "bigk": big}


def two_stage_inputs():
    """A clustered corpus of 64 pages with a duplicated and a masked page
    (tests/test_two_stage.py:91-130) and a query of 5 tokens."""
    rng = np.random.default_rng(12)
    p, nt, dim = 64, 6, 128
    centers = _normed(rng, (8, dim))
    d = centers[rng.integers(0, 8, p)][:, None, :] + 0.02 * rng.standard_normal(
        (p, nt, dim)).astype(np.float32)
    d[10] = d[3]
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    d_lens = np.full(p, nt, np.int32)
    d_lens[7] = 0
    return _normed(rng, (5, dim)), d, d_lens


TWO_STAGE_CASES = {"mean": (1, False), "mean_full": (1, True), "fps4": (4, False),
                   "fps4_full": (4, True)}


def store_points():
    """23 multivector points of 3-12 tokens (an exact duplicate: a tie),
    payload ``g`` = id % 3, and three queries."""
    rng = np.random.default_rng(13)
    vecs = [rng.standard_normal((int(rng.integers(3, 13)), 16)).astype(np.float32)
            for _ in range(23)]
    vecs[9] = vecs[4].copy()
    queries = [rng.standard_normal((5, 16)).astype(np.float32),
               vecs[4] + 0.01 * rng.standard_normal(vecs[4].shape).astype(np.float32),
               rng.standard_normal((2, 16)).astype(np.float32)]
    return vecs, queries


STORE_MODES = {"exact": {}, "int8": dict(quantized=True),
               "pooled": dict(quantized=True, prefilter="pooled"),
               "pooled_fps3": dict(quantized=True, prefilter="pooled", pooled_centroids=3)}


def store_queries():
    """(limit, filter on ``g``, rescore, oversampling) a query."""
    return [(5, None, True, 2.0), (5, 1, True, 2.0), (4, 0, False, 3.0), (30, None, True, 2.0)]


def view_inputs():
    """tests/test_distributed.py's corpus: 16 pages of 4 tokens, 8 a process."""
    return np.random.default_rng(0).standard_normal((16, 4, 128)).astype(np.float32)


def embed_images():
    rng = np.random.default_rng(14)
    return [rng.integers(0, 256, (28 + 3 * i, 28 + 2 * i, 3), dtype=np.uint8) for i in range(5)]


EMBED_QUERIES = ["one question", "a second, longer question about glycans"]

# name -> (retriever, load_retriever's options, world size = data size): the
# families whose batches take another path through the data split: ColQwen2's
# position ids (batch on axis 1) over two grids, SmolVLM's tiled batches, W8A8
EMBED_CASES = {"colqwen2.5": ("tiny-colqwen2.5", dict(dynamic_resolution=True), 2),
               "colidefics3_split": ("tiny-colidefics3", dict(dynamic_resolution=True), 2),
               "colpali_int8": ("tiny-colpali", dict(quantize="int8"), 4)}


def embed_case_pages(case):
    """5 pages a case, made from a seed: two grids for ColQwen2, three
    tilings for SmolVLM's splitting, ``embed_images`` for ColPali."""
    if case == "colpali_int8":
        return embed_images()
    rng = np.random.default_rng(15)
    sizes = ([(112, 112)] * 3 + [(56, 112)] * 2 if case == "colqwen2.5"
             else [(40, 90), (90, 40), (45, 37), (33, 33), (40, 90)])
    return [rng.integers(0, 256, (h, w, 3), dtype=np.uint8) for h, w in sizes]


def goldens_params(name):
    with np.load(REPO / "goldens" / f"{name}_params.npz") as z:
        return {k: z[k] for k in z.files}


def decode_cases():
    """(name, engine class name, model, weight dtype, batcher, batcher kwargs)."""
    paged = dict(page_size=8)
    return [
        ("g1_generate", "GemmaDecodeEngine", "gemma1", "native", None, {}),
        ("g1_dense", "GemmaDecodeEngine", "gemma1", "native", "ContinuousBatcher", {}),
        ("g1_paged", "GemmaDecodeEngine", "gemma1", "native", "PagedContinuousBatcher",
         dict(paged, pool_pages=13)),
        ("g1_paged_int8kv", "GemmaDecodeEngine", "gemma1", "native", "PagedContinuousBatcher",
         dict(paged, kv_dtype="int8")),
        ("g1_paged_int8w", "GemmaDecodeEngine", "gemma1", "int8", "PagedContinuousBatcher",
         paged),
        ("g1_spec_dense", "GemmaDecodeEngine", "gemma1", "native",
         "SpeculativeContinuousBatcher", {}),
        ("g3kv2_paged", "GemmaDecodeEngine", "gemma3kv2", "native", "PagedContinuousBatcher",
         paged),
        ("g3kv2_spec_paged", "GemmaDecodeEngine", "gemma3kv2", "int8",
         "SpeculativePagedContinuousBatcher", paged),
        ("qwen2_generate", "Qwen2DecodeEngine", "qwen2", "native", None, {}),
        ("llama_generate", "LlamaDecodeEngine", "llama", "native", None, {}),
    ]


TP2_CASES = ("g1_generate", "g1_paged")   # the cases a (1, 2) mesh of 2 ranks runs


def decode_model(name):
    """(port config, port engine tree) of a tiny decode model, float32 on the CPU."""
    import torch

    from multimodal_colpali_tpu_torch.models import configs as TC, registry as TR
    from multimodal_colpali_tpu_torch.models.convert import engine_params_from_jax

    if name == "gemma1":   # the ColPali golden's LM: 2 query heads over 1 KV head
        with np.load(REPO / "goldens" / "tiny-colpali_params.npz") as z:
            flat = {k: z[k] for k in z.files if k.startswith(("embed/", "language_model/"))}
        tree: dict = {}
        for key, val in flat.items():
            *parents, leaf = key.split("/")
            node = tree
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = val
        return TC.ColPaliModelConfig.tiny().text, engine_params_from_jax(tree, device="cpu")
    if name == "gemma3kv2":   # 4 query heads over 2 KV heads: the pools split their heads
        cfg = TC.Gemma3TextConfig(vocab_size=64, hidden_size=16, intermediate_size=32,
                                  num_hidden_layers=4, num_attention_heads=4,
                                  num_key_value_heads=2, head_dim=8, sliding_window=8,
                                  sliding_window_pattern=2, query_pre_attn_scalar=8.0)
        return cfg, TR.gemma3_random_params(cfg, seed=5, dtype=torch.float32, device="cpu")
    cfg = TC.Qwen2TextConfig.tiny() if name == "qwen2" else TC.LlamaTextConfig.tiny_lm()
    tree = TR.qwen2vl_random_params(cfg, seed=7, dtype=torch.float32, device="cpu")
    rng = np.random.default_rng(8)   # nonzero q/k/v biases, which the ranks slice
    for i in range(cfg.num_hidden_layers):
        att = tree["language_model"][f"layers_{i}"]["self_attn"]
        for proj in ("q_proj", "k_proj", "v_proj"):
            if "bias" in att[proj]:
                att[proj]["bias"] = torch.from_numpy(
                    0.5 * rng.standard_normal(tuple(att[proj]["bias"].shape)).astype(np.float32))
    return cfg, tree


def run_decode(case, mesh=None):
    """The greedy streams of a decode case, one list a prompt."""
    from multimodal_colpali_tpu_torch.generation import engine as E, paged as PG
    from multimodal_colpali_tpu_torch.generation import scheduler as SC, speculative as SP

    _, eng_cls, model, wd, bat, kw = case
    cfg, params = decode_model(model)
    eng = getattr(E, eng_cls)(cfg, params, device="cpu", weight_dtype=wd, mesh=mesh)
    if bat is None:
        return eng.generate(PROMPTS, max_new_tokens=NEW_TOKENS), 0
    cls = {m: getattr(mod, m) for mod in (SC, PG, SP) for m in dir(mod)}[bat]
    b = cls(eng, batch_slots=4, max_seq_len=64, chunk=3, **kw)
    out = b.generate(PROMPTS, max_new_tokens=NEW_TOKENS)
    return out, getattr(b, "preemptions", 0)


def streams_array(streams):
    out = np.full((len(streams), NEW_TOKENS), -1, np.int64)
    for i, s in enumerate(streams):
        out[i, : len(s)] = s
    return out


@contextlib.contextmanager
def one_rank_mesh(tmp, axes=("corpus",), shape=None):
    """A mesh over a one-rank gloo group in this process (a ``file://``
    rendezvous under ``tmp``), torn down on exit: the card's world size,
    on the CPU."""
    import torch.distributed as dist

    from multimodal_colpali_tpu_torch.parallel import get_mesh, initialize_distributed

    initialize_distributed(f"file://{tmp}/one-rank", 1, 0, device="cpu")
    try:
        yield get_mesh(axes, shape)
    finally:
        dist.destroy_process_group()


# -- the rank's work ------------------------------------------------------------------------

def _sharded_paths(res, corpus):
    import torch

    from multimodal_colpali_tpu_torch.ops import two_stage as T2
    from multimodal_colpali_tpu_torch.ops.topk import sharded_maxsim_topk
    from multimodal_colpali_tpu_torch.parallel import Sharding

    sh = Sharding(corpus, "corpus")
    t = torch.from_numpy
    for name, (q, d, dl, k) in topk_inputs().items():
        v, i = sharded_maxsim_topk(corpus, "corpus", t(q), sh.local(t(d)), sh.local(t(dl)), k)
        res[f"topk/{name}/v"], res[f"topk/{name}/i"] = v.numpy(), i.numpy()
    q, d, dl = two_stage_inputs()
    for name, (cents, full) in TWO_STAGE_CASES.items():
        pooled, codes, scales = T2.build_two_stage_index(t(d), t(dl), n_centroids=cents)
        v, i = T2.sharded_two_stage_maxsim_topk(
            corpus, "corpus", t(q), q.shape[0], sh.local(pooled), sh.local(codes),
            sh.local(scales), sh.local(t(dl)), k=5, n_candidates=16,
            d_full=sh.local(t(d)) if full else None)
        res[f"two/{name}/v"], res[f"two/{name}/i"] = v.numpy(), i.numpy()


def store_results(mesh=None):
    """name -> (ids, scores) of every store mode's queries (one collection a
    mode through ``VectorClient``), and of the dense store's."""
    import torch

    import multimodal_colpali_tpu_torch.store as ts

    vecs, queries = store_points()
    client = ts.VectorClient(device="cpu", mesh=mesh)
    out = {}
    for mode, kw in STORE_MODES.items():
        client.create_collection(mode, ts.VectorParams(
            size=16, multivector_config=ts.MultiVectorConfig(
                comparator=ts.MultiVectorComparator.MAX_SIM)),
            max_tokens=12, **kw)
        store = client._get(mode)   # the client passes neither of these on
        store.dtype, store.pooled_centroids = torch.float32, kw.get("pooled_centroids", 1)
        client.upsert(mode, [ts.PointStruct(id=i, vector=v, payload={"g": i % 3})
                             for i, v in enumerate(vecs)])
    client.create_collection("dense", ts.VectorParams(size=16))
    client._get("dense").dtype = torch.float32
    client.upsert("dense", [ts.PointStruct(id=i, vector=v[0], payload={"g": i % 3})
                            for i, v in enumerate(vecs)])
    for mode in (*STORE_MODES, "dense"):
        for n, q in enumerate(queries):
            for m, (limit, g, rescore, over) in enumerate(store_queries()):
                flt = None if g is None else ts.Filter(
                    must=[ts.FieldCondition(key="g", match=ts.MatchValue(value=g))])
                params = ts.SearchParams(quantization=ts.QuantizationSearchParams(
                    rescore=rescore, oversampling=over))
                r = client.query_points(mode, q[0] if mode == "dense" else q, limit=limit,
                                        query_filter=flt, search_params=params)
                out[f"store/{mode}/{n}/{m}"] = (np.array([p.id for p in r.points], np.int64),
                                                np.array([p.score for p in r.points],
                                                         np.float32))
    return out


def embed_results(mesh=None, case=None):
    """``embed/[<case>/]{img,query}/<i>`` -> the embeddings of tiny-colpali
    (``case`` None) or of an ``EMBED_CASES`` family, data-parallel over
    ``mesh``'s ``data`` axis when given."""
    import torch

    from multimodal_colpali_tpu_torch.models import load_retriever

    name, kw, _ = EMBED_CASES[case] if case else ("tiny-colpali", {}, 4)
    r = load_retriever(name, device="cpu", dtype=torch.float32, params=goldens_params(name),
                       mesh=mesh, **kw)
    pages = embed_case_pages(case) if case else embed_images()
    prefix = f"embed/{case}" if case else "embed"
    out = {}
    for i, e in enumerate(r.embed_images(pages, batch_size=2 if case else 8)):
        out[f"{prefix}/img/{i}"] = e
    for i, e in enumerate(r.embed_queries(EMBED_QUERIES)):
        out[f"{prefix}/query/{i}"] = e
    return out


def main(world: int, rank: int, rendezvous: str, out_dir: str) -> None:
    import torch

    torch.set_num_threads(1)
    sys.path.insert(0, str(REPO))
    from multimodal_colpali_tpu_torch.parallel import get_mesh, initialize_distributed
    from multimodal_colpali_tpu_torch.store import DistributedCorpusView

    initialize_distributed(f"file://{rendezvous}", world, rank, device="cpu")
    res = {}
    corpus = get_mesh(("corpus",))
    if world == 4:
        _sharded_paths(res, corpus)
        for key, (ids, scores) in store_results(corpus).items():
            res[key + "/ids"], res[key + "/scores"] = ids, scores
        dp4 = get_mesh(("data", "model"), (4, 1))
        res.update(embed_results(dp4))
        meshes = {"dp2tp2": get_mesh(("data", "model"), (2, 2))}
    else:
        full = view_inputs()
        view = DistributedCorpusView(full[rank * 8:(rank + 1) * 8], np.full(8, 4, np.int32),
                                     mesh=corpus, prefilter="pooled")
        v, i = view.query(full[11], limit=3, oversampling=4.0)
        res["view/v"], res["view/i"] = v, i
        res["view/owns11"] = np.array(view.owns(11))
        res["view/len"] = np.array(len(view))
        exact = DistributedCorpusView(full[rank * 8:(rank + 1) * 8], np.full(8, 4, np.int32),
                                      mesh=corpus, prefilter="exact", dtype=torch.float32)
        v, i = exact.query(full[5], limit=4)
        res["view_exact/v"], res["view_exact/i"] = v, i
        meshes = {"tp2": get_mesh(("data", "model"), (1, 2))}
    dp = get_mesh(("data", "model"), (world, 1)) if world == 2 else dp4
    for case, (_, _, size) in EMBED_CASES.items():
        if size == world:
            res.update(embed_results(dp, case))
    for mesh_name, mesh in meshes.items():
        for case in decode_cases():
            if mesh_name == "tp2" and case[0] not in TP2_CASES:
                continue
            streams, pre = run_decode(case, mesh)
            res[f"decode/{mesh_name}/{case[0]}"] = streams_array(streams)
            res[f"decode/{mesh_name}/{case[0]}/preemptions"] = np.array(pre)
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **res)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
