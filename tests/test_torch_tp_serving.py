"""Serving over a multi-rank mesh, on the CPU: the dense caches' slots over
``data``, the leader/follower front end of ``GenerationServer`` and the image
engines over a tensor-parallel LM, against the single-device port and the
JAX package on a mesh of the same shape.

A world of 2 ranks (meshes ``(1, 2)`` and ``(2, 1)``) and one of 4 (``(2,
2)``) start once for the module: processes running
``tests/serving_worker.py``, joined into a gloo group by a ``file://``
rendezvous under the test's temporary directory, killed and failed if they
run past ``WORLD_TIMEOUT``. The image models' parameters are JAX's random
initializers, written as numpy files for the ranks before the worlds start.
The references run here while the ranks work: the single-device port (every
result equal) and JAX on a mesh of the same shape over conftest's virtual
devices (greedy streams and constrained replies equal; the port's speculative
streams are held to JAX's plain ones, ROADMAP F6; sampled streams differ from
JAX's by design). Every rank's counters must be equal.
"""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

import parallel_worker as PW
import serving_worker as SW
from multimodal_colpali_tpu.generation import engine as JE
from multimodal_colpali_tpu.generation.gemma3_mm import Gemma3MMEngine as JGemma3MM
from multimodal_colpali_tpu.generation.llava_next_mm import LlavaNextMMEngine as JLlava
from multimodal_colpali_tpu.generation.mllama_mm import MllamaMMEngine as JMllama
from multimodal_colpali_tpu.generation.paged import PagedContinuousBatcher as JPaged
from multimodal_colpali_tpu.generation.qwen2vl_mm import Qwen2VLMMEngine as JQwen2VL
from multimodal_colpali_tpu.generation.scheduler import ContinuousBatcher as JDense
from multimodal_colpali_tpu.generation.server import GenerationServer as JServer
from multimodal_colpali_tpu.models import configs as JC
from multimodal_colpali_tpu.models import registry as JR
from multimodal_colpali_tpu.models.idefics3 import LlamaTextConfig as JLlama
from multimodal_colpali_tpu_torch.generation import (
    GemmaDecodeEngine, GenerationServer, ModuloTokenizer, PagedContinuousBatcher)

torch.set_num_threads(1)

WORLD_TIMEOUT = 400.0
WORKER = Path(SW.__file__)
MESHES = {"tp2": (1, 2), "dp2": (2, 1), "dp2tp2": (2, 2)}
WORLD_OF = {"tp2": 2, "dp2": 2, "dp2tp2": 4}
IMAGE_MESHES = ("tp2", "dp2tp2")


# -- the worlds ------------------------------------------------------------------------------

def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _jax_gemma3_cfg():
    c = SW.gemma3_mm_config()
    text = JC.Gemma3TextConfig(**{f: getattr(c.text, f) for f in (
        "vocab_size", "hidden_size", "intermediate_size", "num_hidden_layers",
        "num_attention_heads", "num_key_value_heads", "head_dim", "sliding_window",
        "sliding_window_pattern", "query_pre_attn_scalar")})
    vision = JC.SiglipVisionConfig(**{f: getattr(c.vision, f) for f in (
        "hidden_size", "intermediate_size", "num_hidden_layers", "num_attention_heads",
        "image_size", "patch_size")})
    return JC.Gemma3MMConfig(vision=vision, text=text, image_token_id=c.image_token_id,
                             mm_tokens_per_image=c.mm_tokens_per_image)


_JAX_IMAGE = {}


def _jax_image_params(name):
    """(JAX config, numpy tree) of an image model (JAX's random init)."""
    if name not in _JAX_IMAGE:
        if name == "pali":
            cfg = JC.ColPaliModelConfig.tiny()
            tree = SW.unflatten(PW.goldens_params("tiny-colpali"))
        elif name == "gemma3":
            cfg = _jax_gemma3_cfg()
            tree = JR.gemma3_mm_random_params(cfg, seed=6)
        elif name == "qwen2vl":
            cfg = JR._QWEN2VL_FULL["tiny-qwen2vl"]()
            tree = JR.qwen2vl_mm_random_params(cfg, seed=4)
        elif name == "llava":
            cfg = JR.LLAVA_NEXT_CONFIGS["tiny-llava-next"]()
            tree = JR.llava_next_random_params(cfg, seed=2)
        else:
            cfg = JR.MLLAMA_CONFIGS["tiny-mllama"]()
            tree = JR.mllama_random_params(cfg, seed=2)
        _JAX_IMAGE[name] = (cfg, jax.tree.map(np.asarray, tree))
    return _JAX_IMAGE[name]


def _start(world: int, root: Path):
    root.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(PW.REPO))
    procs = [subprocess.Popen([sys.executable, str(WORKER), str(world), str(r),
                               str(root / "rendezvous"), str(root)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    return procs, time.monotonic()


def _finish(procs, t0, root: Path):
    """Every rank's results, or a failure: a rank that failed, or a world
    still running after WORLD_TIMEOUT (its ranks killed)."""
    logs = []
    for p in procs:
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
    return res


class _Worlds:
    """Both worlds, started at once; ``worlds[n]`` waits for world ``n``."""

    def __init__(self, root: Path):
        self._root = root
        self.params_dir = root / "params"
        self.params_dir.mkdir(parents=True)
        for name in SW.IMAGE_MODELS[1:]:        # PaliGemma reads the golden itself
            np.savez(self.params_dir / f"{name}.npz", **_flat(_jax_image_params(name)[1]))
        self._started = {n: _start(n, root / f"w{n}") for n in (2, 4)}
        self._done: dict = {}

    def __getitem__(self, n: int):
        if n not in self._done:
            procs, t0 = self._started[n]
            self._done[n] = _finish(procs, t0, self._root / f"w{n}")
        return self._done[n]

    def close(self) -> None:
        for n, (procs, _) in self._started.items():
            if n not in self._done:
                for p in procs:
                    p.kill()
                    p.communicate()


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    w = _Worlds(tmp_path_factory.mktemp("serving"))
    yield w
    w.close()


def _jmesh(tag):
    shape = MESHES[tag]
    return JMesh(np.array(jax.devices()[:int(np.prod(shape))]).reshape(shape), ("data", "model"))


def _counters_equal(ranks, key):
    for r, got in enumerate(ranks[1:], 1):
        np.testing.assert_array_equal(got[key], ranks[0][key], err_msg=f"rank {r}: {key}")


# -- (a) the dense caches' slots over data ----------------------------------------------------

_PORT_DENSE = {}
_JAX_DENSE = {}


def _jax_lm(model):
    cfg, tree = PW.decode_model(model)
    if model == "gemma1":
        jcfg = JC.ColPaliModelConfig.tiny().text
    else:
        jcfg = JC.Gemma3TextConfig(**{f: getattr(cfg, f) for f in (
            "vocab_size", "hidden_size", "intermediate_size", "num_hidden_layers",
            "num_attention_heads", "num_key_value_heads", "head_dim", "sliding_window",
            "sliding_window_pattern", "query_pre_attn_scalar")})
    return jcfg, jax.tree.map(lambda x: jnp.asarray(x.numpy()), tree)


def _jax_dense_streams(model, tag):
    """JAX's dense batcher over its mesh engine (its sharded caches)."""
    if (model, tag) not in _JAX_DENSE:
        jcfg, jtree = _jax_lm(model)
        eng = JE.GemmaDecodeEngine(jcfg, jtree, mesh=_jmesh(tag))
        bat = JDense(eng, batch_slots=4, max_seq_len=64, chunk=3)
        _JAX_DENSE[model, tag] = bat.generate(PW.PROMPTS, max_new_tokens=PW.NEW_TOKENS)
    return _JAX_DENSE[model, tag]


def _port_dense_streams(model, cls, slots):
    if (model, cls, slots) not in _PORT_DENSE:
        cfg, params = PW.decode_model(model)
        eng = GemmaDecodeEngine(cfg, params, device="cpu")
        bat = SW.batcher_class(cls)(eng, batch_slots=slots, max_seq_len=64, chunk=3)
        _PORT_DENSE[model, cls, slots] = bat.generate(PW.PROMPTS, max_new_tokens=PW.NEW_TOKENS)
    return _PORT_DENSE[model, cls, slots]


@pytest.mark.parametrize("tag", list(MESHES))
@pytest.mark.parametrize("model", SW.DENSE_MODELS)
@pytest.mark.parametrize("cls", SW.DENSE_BATCHERS)
@pytest.mark.parametrize("slots", SW.DENSE_SLOTS)
def test_dense_caches_hold_the_rank_s_slots(worlds, tag, model, cls, slots):
    """Each rank's dense caches hold ``slots / data`` slots (all of them
    where ``data`` does not divide ``slots``, as JAX's ``_batch_axis``
    replicates), and the leader's greedy streams equal the single-device
    port's and JAX's dense batcher on a mesh of the same shape; every rank
    counts the same admissions, decode steps, tokens and records."""
    ranks = worlds[WORLD_OF[tag]]
    key = f"dense/{tag}/{model}/{cls}/{slots}"
    dp = MESHES[tag][0]
    want_slots = slots // dp if slots % dp == 0 else slots
    assert [int(r[key + "/slots"]) for r in ranks] == [want_slots] * len(ranks)
    _counters_equal(ranks, key + "/counters")
    got = ranks[0][key]
    np.testing.assert_array_equal(got, PW.streams_array(_port_dense_streams(model, cls, slots)))
    np.testing.assert_array_equal(got, PW.streams_array(_jax_dense_streams(model, tag)))


# -- (b) the front end -------------------------------------------------------------------------

def _port_replies():
    """The single-device port server's replies to the same requests, sent
    the same way (serving_worker.front_end's leader)."""
    if "port" not in _FRONT:
        cfg, params = PW.decode_model("gemma1")
        eng = GemmaDecodeEngine(cfg, params, device="cpu")
        _FRONT["port"] = SW.front_replies(eng, ModuloTokenizer(cfg.vocab_size))[0]
    return _FRONT["port"]


_FRONT = {}


def _jax_replies(tag):
    """JAX's GenerationServer over its paged batcher on its mesh engine: the
    greedy, streaming and constrained requests at once."""
    if tag not in _FRONT:
        from concurrent.futures import ThreadPoolExecutor

        jcfg, jtree = _jax_lm("gemma1")
        eng = JE.GemmaDecodeEngine(jcfg, jtree, mesh=_jmesh(tag))
        bat = JPaged(eng, batch_slots=SW.FRONT["slots"], max_seq_len=96, chunk=3,
                     page_size=8).serve()
        want = {k: v for k, v in SW.front_requests().items() if k != "sampled"}
        try:
            with JServer(bat, JE.ModuloTokenizer(jcfg.vocab_size)) as srv:
                with ThreadPoolExecutor(len(want)) as ex:
                    got = dict(zip(want, ex.map(lambda b: SW.post(srv.base_url, b),
                                                want.values())))
        finally:
            bat.shutdown()
        _FRONT[tag] = got
    return _FRONT[tag]


@pytest.mark.parametrize("tag", list(MESHES))
def test_front_end_serves_as_the_single_device_server(worlds, tag):
    """The leader binds HTTP and its client sends, at once, greedy requests
    of three lengths, a streaming one, a sampled one, a structured MCQ, one
    that outlives ``admission_timeout`` (504) and one past ``max_queue``
    (429). The replies equal the single-device port server's; the greedy,
    streaming and constrained ones equal JAX's server over JAX's mesh
    engine. Every rank counts the same admissions, decode steps, tokens,
    expired requests and constrained forwards; the followers bound nothing
    and opened no socket."""
    ranks = worlds[WORLD_OF[tag]]
    key = f"front/{tag}"
    got = {k: tuple(v) for k, v in json.loads(str(ranks[0][key + "/replies"])).items()}
    want = _port_replies()
    assert got == want
    assert got["expired"][:2] == (504, "TimeoutError")
    assert got["rejected"][:2] == (429, "AdmissionQueueFull")
    assert json.loads(got["mcq"][1])["answer"] in SW.MCQ_CHOICES
    assert int(ranks[0][key + "/rejected"]) == 1
    _counters_equal(ranks, key + "/counters")
    admissions, steps, tokens, expired, forwards, _ = ranks[0][key + "/counters"].tolist()
    assert (admissions, expired, forwards) == (5, 1, 1) and steps > 0 and tokens > 0
    for r in ranks[1:]:
        assert int(r[key + "/sockets"]) == 0 and not bool(r[key + "/bound"])
    jgot = _jax_replies(tag)
    for name, reply in jgot.items():
        assert tuple(reply) == got[name], name


def test_constrained_forwards_are_record_entries():
    """A batcher runs a constrained forward at a scheduling point, under its
    lock: not serving, the server drains it; the answer is the bare
    engine's."""
    cfg, params = PW.decode_model("gemma1")
    eng = GemmaDecodeEngine(cfg, params, device="cpu")
    bat = PagedContinuousBatcher(eng, batch_slots=2, max_seq_len=96, chunk=3, page_size=8)
    body = SW.front_requests()["mcq"]
    with GenerationServer(bat, ModuloTokenizer(cfg.vocab_size)) as srv:
        got = SW.post(srv.base_url, body)
    with GenerationServer(eng, ModuloTokenizer(cfg.vocab_size)) as srv:
        want = SW.post(srv.base_url, body)
    assert got == want and bat.constrained_forwards == 1 and bat.records >= 1


# -- (c) the image engines over a tensor-parallel LM -------------------------------------------

_PORT_IMG = {}
_JAX_IMG = {}


def _pixels(name, pre, imgs):
    pix = pre(imgs)
    return pix if isinstance(pix, np.ndarray) else pix.numpy()


def _port_image_streams(name, cls, params_dir):
    """The single-device port's streams, and the pixels and requests behind them."""
    if (name, cls) not in _PORT_IMG:
        mm, pre = SW.image_engine(name, params_dir)
        kw = dict(SW.image_batchers(name))[cls]
        extra = dict(cross_max_images=2) if name == "mllama" else {}
        bat = SW.batcher_class(cls)(mm.lm, batch_slots=4, max_seq_len=96, chunk=3,
                                    mm_engine=mm, **kw, **extra)
        reqs = SW.image_inputs(name, mm)
        futs = [bat.submit(p, max_new_tokens=n, pixel_values=None if imgs is None
                           else _pixels(name, pre, imgs)) for p, imgs, n in reqs]
        bat.drain()
        _PORT_IMG[name, cls] = ([f.result(60) for f in futs],
                                [None if imgs is None else _pixels(name, pre, imgs)
                                 for _, imgs, _ in reqs], reqs)
    return _PORT_IMG[name, cls]


def _jax_image_streams(name, tag, pixels, reqs):
    """JAX's image engine with its ``lm`` on the mesh, through its paged
    batcher (its dense one for Mllama: JAX's paged batcher carries no cross
    pools)."""
    if (name, tag) not in _JAX_IMG:
        cfg, tree = _jax_image_params(name)
        jp = jax.tree.map(jnp.asarray, tree)
        mesh = _jmesh(tag)
        if name == "pali":
            mm = JE.PaliGemmaEngine(cfg, jp)
            mm.lm = JE.GemmaDecodeEngine(cfg.text, jp, mesh=mesh)
        elif name == "gemma3":
            mm = JGemma3MM(cfg, jp, dtype=jnp.float32)
            mm.lm = JE.GemmaDecodeEngine(cfg.text, jp, dtype=jnp.float32, mesh=mesh)
        elif name == "qwen2vl":
            mm = JQwen2VL(cfg, jp, dtype=jnp.float32)
            mm.lm = JE.Qwen2DecodeEngine(cfg.text, jp, dtype=jnp.float32, mesh=mesh)
        elif name == "llava":
            mm = JLlava(cfg, jp, dtype=jnp.float32)
            mm.lm = JE.LlamaDecodeEngine(cfg.text, jp, dtype=jnp.float32, mesh=mesh)
        else:
            mm = JMllama(cfg, jp, dtype=jnp.float32)
            mm.lm = JE.LlamaDecodeEngine(cfg.text, jp, dtype=jnp.float32, mesh=mesh)
        if name == "mllama":
            bat = JDense(mm.lm, batch_slots=4, max_seq_len=96, chunk=3, mm_engine=mm,
                         cross_max_images=2)
        else:
            bat = JPaged(mm.lm, batch_slots=4, max_seq_len=96, chunk=3, page_size=8,
                         mm_engine=mm)
        futs = [bat.submit(p, max_new_tokens=n, pixel_values=pix)
                for (p, _, n), pix in zip(reqs, pixels)]
        bat.drain()
        _JAX_IMG[name, tag] = [f.result(60) for f in futs]
    return _JAX_IMG[name, tag]


@pytest.mark.parametrize("tag", IMAGE_MESHES)
@pytest.mark.parametrize("name,cls", [(n, c) for n in SW.IMAGE_MODELS
                                      for c, _ in SW.image_batchers(n)])
def test_image_engines_over_a_tensor_parallel_lm(worlds, tag, name, cls):
    """A text, a 1-image and a 2-image request (pixels preprocessed on the
    leader, carried by the record) through the paged batcher (and the dense
    one for Mllama) over an image engine whose LM is tensor-parallel: the
    leader's greedy streams equal the single-device port's and JAX's with
    its ``lm`` on a mesh of the same shape; every rank counts alike, and
    Mllama's cross pools hold the rank's slots."""
    ranks = worlds[WORLD_OF[tag]]
    key = f"img/{tag}/{name}/{cls}"
    _counters_equal(ranks, key + "/counters")
    want, pixels, reqs = _port_image_streams(name, cls, worlds.params_dir)
    got = ranks[0][key]
    np.testing.assert_array_equal(got, PW.streams_array(want))
    np.testing.assert_array_equal(got, PW.streams_array(_jax_image_streams(name, tag, pixels,
                                                                           reqs)))
    if name == "mllama":
        dp = MESHES[tag][0]
        assert [int(r[key + "/cross_slots"]) for r in ranks] == [4 // dp] * len(ranks)


@pytest.mark.parametrize("rank", [0, 1])
def test_mllama_cross_blocks_cut_like_the_lm_layers(rank):
    """Over model = 2 a rank's cross blocks hold its query head of
    ``q_proj``, the one KV head whole (``tp_head_plan``: it does not split),
    half of the MLP's hidden units, and the matching rows of ``o_proj`` and
    ``down_proj``; the norms and the tanh gates stay whole."""
    import types

    from multimodal_colpali_tpu_torch.generation.engine import tp_engine_params
    from multimodal_colpali_tpu_torch.models import convert as C
    from multimodal_colpali_tpu_torch.models import registry as TR

    cfg = TR.MLLAMA_CONFIGS["tiny-mllama"]()
    cross = C.mllama_params_from_jax(_jax_image_params("mllama")[1], cfg, device="cpu")[3]
    mesh = types.SimpleNamespace(size=lambda axis: 2 if axis == "model" else 1,
                                 index=lambda axis: rank if axis == "model" else 0)
    cut, rc = tp_engine_params(cross, cfg.text, mesh, attention=lambda t: [
        t[str(g)]["cross_attn"] for g in cfg.cross_attention_layers])
    assert (rc.num_attention_heads, rc.num_key_value_heads) == (1, 1)
    d, h = cfg.text.head_dim, cfg.text.intermediate_size // 2
    for g in cfg.cross_attention_layers:
        full, part = cross[str(g)], cut[str(g)]
        fa, pa = full["cross_attn"], part["cross_attn"]
        cols = {("cross_attn", "q_proj"): slice(rank * d, (rank + 1) * d),
                ("cross_attn", "k_proj"): slice(None), ("cross_attn", "v_proj"): slice(None),
                ("mlp", "gate_proj"): slice(rank * h, (rank + 1) * h),
                ("mlp", "up_proj"): slice(rank * h, (rank + 1) * h)}
        for (blk, name), sl in cols.items():
            assert torch.equal(part[blk][name]["kernel"], full[blk][name]["kernel"][:, sl])
        assert torch.equal(pa["o_proj"]["kernel"], fa["o_proj"]["kernel"][rank * d:(rank + 1) * d])
        assert torch.equal(part["mlp"]["down_proj"]["kernel"],
                           full["mlp"]["down_proj"]["kernel"][rank * h:(rank + 1) * h])
        for leaf in (("gate_attn",), ("gate_mlp",), ("input_layernorm", "weight"),
                     ("post_attention_layernorm", "weight"), ("cross_attn", "q_norm", "weight"),
                     ("cross_attn", "k_norm", "weight")):
            a, b = full, part
            for k in leaf:
                a, b = a[k], b[k]
            assert torch.equal(a, b), leaf


# -- the programming model ---------------------------------------------------------------------

def test_a_mesh_still_needs_an_initialised_group():
    from multimodal_colpali_tpu_torch.parallel import get_mesh

    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="initialised process group"):
        get_mesh(("data", "model"), (1, 1))


def test_a_one_rank_mesh_broadcasts_nothing(tmp_path):
    """``broadcast_object`` over one rank returns its object; a one-rank
    batcher builds and applies the records itself, so its streams are the
    mesh-less batcher's."""
    from multimodal_colpali_tpu_torch.parallel import broadcast_object

    cfg, params = PW.decode_model("gemma1")
    with PW.one_rank_mesh(tmp_path, ("data", "model"), (1, 1)) as mesh:
        marker = object()
        assert broadcast_object(mesh, marker) is marker
        assert mesh.is_leader and mesh.leader == 0
        eng = GemmaDecodeEngine(cfg, params, device="cpu", mesh=mesh)
        bat = PagedContinuousBatcher(eng, batch_slots=2, max_seq_len=64, chunk=3, page_size=8)
        got = bat.generate(PW.PROMPTS, max_new_tokens=4)
        bat.shutdown()
    plain = GemmaDecodeEngine(cfg, params, device="cpu")
    want = PagedContinuousBatcher(plain, batch_slots=2, max_seq_len=64, chunk=3,
                                  page_size=8).generate(PW.PROMPTS, max_new_tokens=4)
    assert got == want and bat.records > 0


def test_a_bare_multi_rank_engine_is_refused():
    import types

    fake = types.SimpleNamespace(mesh=types.SimpleNamespace(
        devices=np.arange(2), is_leader=True))
    with pytest.raises(ValueError, match="through a batcher"):
        GenerationServer(fake, ModuloTokenizer(64))
