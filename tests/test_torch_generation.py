"""The port's generation tier against the JAX package, on the CPU.

Tiny Gemma-1 (the ColPali text LM) and Gemma-3 models: the JAX parameters
are carried over with ``engine_params_from_jax`` and both engines run in
float32, so the greedy streams of ``generate``, the dense batcher and the
paged batcher (native and int8 KV) must be token-identical to the JAX
package's. Sampling uses the port's counter-based sampler, which cannot
reproduce JAX's threefry bits, so sampled streams are checked for the
property JAX promises (the same stream whatever the slot, the batch and the
admission timing) rather than against JAX.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_colpali_tpu.generation import engine as JE
from multimodal_colpali_tpu.generation.paged import PagedContinuousBatcher as JPaged
from multimodal_colpali_tpu.generation.scheduler import ContinuousBatcher as JDense
from multimodal_colpali_tpu.models import configs as JC
from multimodal_colpali_tpu.models import registry as JR
from multimodal_colpali_tpu.models.colpali import ColPaliModel as JColPali
from multimodal_colpali_tpu_torch.generation import engine as TE
from multimodal_colpali_tpu_torch.generation.paged import PagedContinuousBatcher
from multimodal_colpali_tpu_torch.generation.scheduler import (
    AdmissionQueueFull, ContinuousBatcher)
from multimodal_colpali_tpu_torch.models import configs as TC
from multimodal_colpali_tpu_torch.models import registry as TR
from multimodal_colpali_tpu_torch.models.convert import (
    engine_params_from_jax, engine_params_from_state_dict)
from multimodal_colpali_tpu_torch.ops import quant as TQ

torch.set_num_threads(1)

PROMPTS = [[5, 9, 17, 3], [40, 2], list(range(3, 24))]


def _perturb_norms(params, seed):
    """Random (1 + w) norm weights, so every norm of the stack matters."""
    rng = np.random.default_rng(seed)

    def walk(t, key=None):
        if isinstance(t, dict):
            return {k: walk(v, k) for k, v in t.items()}
        a = np.asarray(t)
        if key == "weight" and a.ndim == 1:
            return (0.2 * rng.standard_normal(a.shape)).astype(np.float32)
        return a

    return walk(params)


@pytest.fixture(scope="module", params=["gemma1", "gemma3"])
def lm(request):
    """(arch, JAX cfg, port cfg, JAX params as numpy, JAX engine, port engine)."""
    if request.param == "gemma3":
        jcfg = JC.Gemma3TextConfig.tiny(vocab_size=64)
        tcfg = TC.Gemma3TextConfig.tiny(vocab_size=64)
        params = JR.gemma3_random_params(jcfg, seed=0)
    else:
        ccfg = JC.ColPaliModelConfig.tiny(vocab_size=64)
        jcfg, tcfg = ccfg.text, TC.ColPaliModelConfig.tiny(vocab_size=64).text
        params = JR.fast_random_params(JColPali(ccfg), ccfg, seed=3)
        params = {"embed": params["embed"], "language_model": params["language_model"]}
    params = _perturb_norms(jax.tree.map(np.asarray, params), seed=1)
    jeng = JE.GemmaDecodeEngine(jcfg, jax.tree.map(jnp.asarray, params))
    teng = TE.GemmaDecodeEngine(tcfg, engine_params_from_jax(params, device="cpu"),
                                device="cpu")
    return request.param, jcfg, tcfg, params, jeng, teng


def test_configs_match_jax_letter_for_letter():
    for name in ("gemma3_27b", "gemma3_12b", "gemma3_4b", "gemma3_1b", "tiny"):
        j, t = getattr(JC.Gemma3TextConfig, name)(), getattr(TC.Gemma3TextConfig, name)()
        assert dataclasses.asdict(t) == dataclasses.asdict(j), name
        assert t.layer_types_resolved == j.layer_types_resolved
    assert sorted(TR.GEMMA3_CONFIGS) == sorted(JR.GEMMA3_CONFIGS)
    c = TR.GEMMA3_CONFIGS["google/gemma-3-27b-it"]()
    shapes = TR.gemma3_param_shapes(c)
    jshapes = JR.gemma3_param_shapes(c)
    assert jax.tree.map(lambda s: tuple(s.shape), jshapes) == shapes
    n = sum(int(np.prod(s)) for _, s in TR.tree_leaves(shapes))
    assert 26.9e9 < n < 27.1e9   # gemma-3-27b's text tower: 27.0B parameters


def test_next_token_logits_match_jax(lm):
    arch, *_, jeng, teng = lm
    rng = np.random.default_rng(0)
    prompts = [rng.integers(2, 60, (n,)).tolist() for n in (21, 9, 14)]  # past window 8
    want = np.asarray(jeng.next_token_logits(prompts, bucket=8))
    got = teng.next_token_logits(prompts, bucket=8)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_greedy_generate_matches_jax(lm):
    *_, jeng, teng = lm
    prompts = PROMPTS + [[3, 17, 42, 7, 9, 23, 55, 4, 11, 30, 8, 2, 19]]
    want = jeng.generate(prompts, max_new_tokens=16)
    assert teng.generate(prompts, max_new_tokens=16) == want
    assert teng.generate(prompts, max_new_tokens=16, eos_id=want[0][3]) == \
        jeng.generate(prompts, max_new_tokens=16, eos_id=want[0][3])


@pytest.mark.parametrize("kind", ["dense", "paged", "paged_int8"])
def test_batchers_match_jax_batchers(lm, kind):
    """Each port batcher streams exactly what the JAX batcher of the same
    kind streams (int8 KV included: both quantize the same rows bit for bit
    and attend through the dequantize-first plain path on the CPU)."""
    _, _, _, _, jeng, teng = lm
    kw = dict(batch_slots=2, max_seq_len=64, chunk=3)
    if kind == "dense":
        jb, tb = JDense(jeng, **kw), ContinuousBatcher(teng, **kw)
    else:
        kv = "int8" if kind == "paged_int8" else "native"
        jb = JPaged(jeng, page_size=8, kv_dtype=kv, **kw)
        tb = PagedContinuousBatcher(teng, page_size=8, kv_dtype=kv, **kw)
        assert not hasattr(tb, "_kc")   # the paged batcher never makes dense caches
    want = jb.generate(PROMPTS, max_new_tokens=12)
    assert tb.generate(PROMPTS, max_new_tokens=12) == want
    if kind != "paged_int8":
        assert want == jeng.generate(PROMPTS, max_new_tokens=12)


def test_paged_preemption_replays_streams(lm):
    """A pool too small for every request at once preempts and recomputes,
    and still reproduces the JAX engine's streams exactly (Gemma-3's sliding
    layers included)."""
    *_, jeng, teng = lm
    prompts = [list(range(2, 18)), list(range(5, 17)), list(range(7, 21))]
    want = jeng.generate(prompts, max_new_tokens=10)
    bat = PagedContinuousBatcher(teng, batch_slots=3, max_seq_len=64, chunk=4, page_size=8,
                                 pool_pages=9)
    assert bat.generate(prompts, max_new_tokens=10) == want
    assert bat.preemptions > 0
    assert sorted(bat._free) == list(range(1, bat.P))   # every page came back
    int8 = PagedContinuousBatcher(teng, batch_slots=3, max_seq_len=64, chunk=4, page_size=8,
                                  pool_pages=9, kv_dtype="int8")
    base = PagedContinuousBatcher(teng, batch_slots=3, max_seq_len=64, chunk=4, page_size=8,
                                  kv_dtype="int8")
    assert int8.generate(prompts, max_new_tokens=10) == base.generate(prompts,
                                                                      max_new_tokens=10)
    assert int8.preemptions > 0


def test_paged_capacity_failures_fail_alone(lm):
    *_, teng = lm
    bat = PagedContinuousBatcher(teng, batch_slots=2, max_seq_len=64, chunk=3, page_size=8,
                                 pool_pages=5)
    ok = bat.submit([5, 9, 17], max_new_tokens=4)
    bad = bat.submit(list(range(1, 33)), max_new_tokens=8)   # pool holds the prompt only
    bat.drain()
    assert ok.result(10) == teng.generate([[5, 9, 17]], max_new_tokens=4)[0]
    with pytest.raises(ValueError, match="exceeds the KV capacity"):
        bad.result(10)
    prompt = list(range(2, 12))                 # exactly the pool: admitted and completes
    fut = bat.submit(prompt, max_new_tokens=17)
    bat.drain()
    assert fut.result(10) == teng.generate([prompt], max_new_tokens=17)[0]


@pytest.mark.parametrize("kv", ["native", "int8"])
def test_prefix_caching_shares_pages_and_skips_prefix_compute(lm, kv):
    """Prompts sharing page-aligned prefixes reuse the cached pages and
    prefill only their tails; streams equal the uncached batcher's."""
    *_, jeng, teng = lm
    shared = list(range(2, 18))                    # two full pages at 8
    prompts = [shared + [40, 41], shared + [50], shared + [60, 61, 62]]
    kw = dict(batch_slots=3, max_seq_len=64, chunk=3, page_size=8, kv_dtype=kv)
    want = PagedContinuousBatcher(teng, **kw).generate(prompts, max_new_tokens=6)
    if kv == "native":
        assert want == [jeng.generate([p], max_new_tokens=6)[0] for p in prompts]
    bat = PagedContinuousBatcher(teng, prefix_caching=True, **kw)
    futs = [bat.submit(p, max_new_tokens=6) for p in prompts]
    bat.drain()
    assert [f.result(10) for f in futs] == want
    assert bat.prefix_cache_hits == 4 and len(bat._cache_lru) > 0
    later = bat.submit(shared + [33], max_new_tokens=6)   # the prefix is cached by now
    bat.drain()
    assert bat.prefix_prefill_hits >= 1
    if kv == "native":
        assert later.result(10) == jeng.generate([shared + [33]], max_new_tokens=6)[0]


def test_prefix_caching_eviction_under_pressure(lm):
    *_, teng = lm
    bat = PagedContinuousBatcher(teng, batch_slots=2, max_seq_len=64, chunk=3, page_size=8,
                                 pool_pages=8, prefix_caching=True)
    rng = np.random.default_rng(5)
    for _ in range(5):
        p = rng.integers(2, 60, (int(rng.integers(6, 20)),)).tolist()
        fut = bat.submit(p, max_new_tokens=4)
        bat.drain()
        assert fut.result(10) == teng.generate([p], max_new_tokens=4)[0]


@pytest.mark.parametrize("paged", [False, True])
def test_chunked_prefill_matches_whole_prompt(lm, paged):
    *_, teng = lm
    cls = PagedContinuousBatcher if paged else ContinuousBatcher
    kw = dict(page_size=8) if paged else {}
    bat = cls(teng, batch_slots=2, max_seq_len=64, chunk=3, prefill_chunk=5, **kw)
    assert bat.generate(PROMPTS, max_new_tokens=8) == teng.generate(PROMPTS, max_new_tokens=8)
    assert bat.chunked_prefill_segments >= 5


def test_prefill_cache_reuses_identical_prompts(lm):
    *_, teng = lm
    bat = ContinuousBatcher(teng, batch_slots=2, max_seq_len=64, chunk=3)
    a = bat.generate([PROMPTS[0]], max_new_tokens=5)
    assert bat.generate([PROMPTS[0]], max_new_tokens=5) == a and bat.prefill_cache_hits == 1


@pytest.mark.parametrize("kv", ["native", "int8"])
def test_fail_all_rebuilds_pools_and_recovers(lm, kv, monkeypatch):
    """A step that fails mid-chunk fails every request, rebuilds zeroed pools
    and a fresh allocator, and the batcher serves the next request exactly."""
    *_, teng = lm
    bat = PagedContinuousBatcher(teng, batch_slots=2, max_seq_len=64, chunk=3, page_size=8,
                                 kv_dtype=kv, prefix_caching=True)
    futs = [bat.submit(p, max_new_tokens=8) for p in PROMPTS[:2]]
    queued = bat.submit(PROMPTS[2], max_new_tokens=8)
    calls = {"n": 0}
    real = bat._one_step

    def flaky(p):
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError("device fault")
        return real(p)

    monkeypatch.setattr(bat, "_one_step", flaky)
    with pytest.raises(RuntimeError, match="device fault"):
        bat.drain()
    for f in futs + [queued]:
        with pytest.raises(RuntimeError, match="device fault"):
            f.result(10)
    pool = bat._kpools[0][0] if kv == "int8" else bat._kpools[0]
    assert not pool.any() and sorted(bat._free) == list(range(1, bat.P))
    assert not bat._key_page and all(not p for p in bat._slot_pages)
    monkeypatch.setattr(bat, "_one_step", real)
    want = PagedContinuousBatcher(teng, batch_slots=2, max_seq_len=64, chunk=3, page_size=8,
                                  kv_dtype=kv).generate([PROMPTS[2]], max_new_tokens=8)
    assert bat.generate([PROMPTS[2]], max_new_tokens=8) == want


def test_logprobs_match_jax_batcher(lm):
    """Logprob records (chosen token and top-3) equal the JAX paged
    batcher's: same tokens and ids, logprobs to float32 sum order."""
    *_, jeng, teng = lm
    jb = JPaged(jeng, batch_slots=2, max_seq_len=64, chunk=3, page_size=8)
    tb = PagedContinuousBatcher(teng, batch_slots=2, max_seq_len=64, chunk=3, page_size=8)
    jf = [jb.submit(p, max_new_tokens=6, logprobs=3) for p in PROMPTS[:2]]
    tf = [tb.submit(p, max_new_tokens=6, logprobs=3) for p in PROMPTS[:2]]
    jb.drain()
    tb.drain()
    for a, b in zip(jf, tf):
        (jt, jl, jtop), (tt, tl, ttop) = a.result(10), b.result(10)
        assert tt == jt and len(tl) == len(jl) == 6
        np.testing.assert_allclose(tl, jl, rtol=1e-4, atol=1e-5)
        assert [[i for i, _ in s] for s in ttop] == [[i for i, _ in s] for s in jtop]
        np.testing.assert_allclose([[v for _, v in s] for s in ttop],
                                   [[v for _, v in s] for s in jtop], rtol=1e-4, atol=1e-5)


def test_streaming_callback_matches_result(lm):
    *_, teng = lm
    bat = PagedContinuousBatcher(teng, batch_slots=2, max_seq_len=64, chunk=3, page_size=8)
    seen = []
    fut = bat.submit(PROMPTS[2], max_new_tokens=7, on_token=seen.append)
    lp_seen = []
    fut2 = bat.submit(PROMPTS[0], max_new_tokens=5, logprobs=2, on_token=lp_seen.append)
    bat.drain()
    assert seen == fut.result(10) and len(seen) == 7
    toks, lps, tops = fut2.result(10)
    assert lp_seen == list(zip(toks, lps, tops))


def test_queue_bound_and_admission_deadline(lm):
    *_, teng = lm
    bat = ContinuousBatcher(teng, batch_slots=1, max_seq_len=64, chunk=2, max_queue=1)
    first = bat.submit([5, 9], max_new_tokens=3)
    over = bat.submit([6, 9], max_new_tokens=3)
    with pytest.raises(AdmissionQueueFull):
        over.result(1)
    assert bat.rejected == 1
    bat.drain()
    assert len(first.result(10)) == 3
    late = ContinuousBatcher(teng, batch_slots=1, max_seq_len=64, chunk=2,
                             admission_timeout=1e-6)
    fut = late.submit([5, 9], max_new_tokens=3)
    import time
    time.sleep(0.01)
    late.drain()
    with pytest.raises(TimeoutError):
        fut.result(1)
    assert late.expired == 1


@pytest.mark.parametrize("cls", [ContinuousBatcher, PagedContinuousBatcher])
def test_queue_bound_counts_requests_waiting_for_a_slot(lm, cls):
    """With the loop running and every slot busy, ``max_queue`` bounds the
    requests still waiting for a slot, also those a record already took
    from the queue: a submit past it fails however soon the loop drains the
    queue, and the accepted ones complete."""
    import time
    *_, teng = lm

    class SlowDecode(cls):          # a slow decode step: the slots stay busy
        def _step_chunk(self):
            time.sleep(0.02)
            super()._step_chunk()

    kw = dict(page_size=8) if cls is PagedContinuousBatcher else {}
    bat = SlowDecode(teng, batch_slots=2, max_seq_len=128, chunk=2, max_queue=3, **kw).serve()
    deadline = time.monotonic() + 60
    try:
        busy = [bat.submit([5, 9, i], max_new_tokens=100) for i in range(2)]
        while bat.admissions < 2 and time.monotonic() < deadline:
            time.sleep(0.005)
        waiting = []
        for i in range(6):
            waiting.append(bat.submit([6, 9, i], max_new_tokens=3))
            while not bat._queue.empty() and time.monotonic() < deadline:
                time.sleep(0.005)   # the loop takes the submit into a record
        assert bat.admissions == 2, "the busy slots finished before the burst ended"
        for fut in waiting[3:]:
            with pytest.raises(AdmissionQueueFull):
                fut.result(0)
        assert bat.rejected == 3
        assert [len(f.result(60)) for f in busy + waiting[:3]] == [100, 100, 3, 3, 3]
    finally:
        bat.shutdown()


def test_filter_top_p_top_k_identical_to_jax():
    rng = np.random.default_rng(9)
    logits = (rng.standard_normal((6, 64)) * 3).astype(np.float32)
    logits[0, :4] = logits[0, 10]          # ties at the boundary
    top_p = np.array([1.0, 0.9, 0.5, 0.0, 0.95, 0.7], np.float32)
    top_k = np.array([0, 0, 5, 0, 1, 64], np.int32)
    for p, k in ((top_p, top_k), (0.8, 0), (1.0, 3)):
        want = np.asarray(JE.filter_top_p_top_k(jnp.asarray(logits), p, k))
        got = TE.filter_top_p_top_k(torch.from_numpy(logits), p, k).numpy()
        np.testing.assert_array_equal(got, want)


def test_sampler_is_seed_and_admission_invariant(lm):
    """A (prompt, seed, temperature, top_p) request samples the same stream
    alone, in a batch, through the dense batcher and through the paged
    batcher under staggered admission and preemption; other seeds differ."""
    *_, teng = lm
    kw = dict(max_new_tokens=9, temperature=1.2, top_p=0.9)
    reqs = [(p, s) for p, s in zip(PROMPTS + [list(range(2, 18))], (11, 12, 11, 7))]
    alone = [teng.generate([p], seed=s, **kw)[0] for p, s in reqs]
    assert teng.generate([reqs[0][0]], seed=11, **kw)[0] == alone[0]
    assert teng.generate([reqs[0][0]], seed=99, **kw)[0] != alone[0]
    dense = ContinuousBatcher(teng, batch_slots=2, max_seq_len=64, chunk=2)
    futs = [dense.submit(p, seed=s, **kw) for p, s in reqs]
    dense.drain()
    assert [f.result(10) for f in futs] == alone
    paged = PagedContinuousBatcher(teng, batch_slots=3, max_seq_len=64, chunk=2, page_size=8,
                                   pool_pages=7)
    futs = []
    for i, (p, s) in enumerate(reqs):
        futs.append(paged.submit(p, seed=s, **kw))
        with paged._lock, torch.inference_mode():   # admit while others are mid-decode
            paged._admit()
            if paged._busy():
                paged._step_chunk()
    paged.drain()
    assert [f.result(10) for f in futs] == alone
    assert paged.preemptions > 0


def test_gumbel_noise_is_a_function_of_seed_step_and_token():
    a = TE.gumbel_noise(torch.tensor([3, 3, 4]), torch.tensor([0, 0, 0]), 1000)
    assert torch.equal(a[0], a[1]) and not torch.equal(a[0], a[2])
    b = TE.gumbel_noise(torch.tensor([3]), torch.tensor([1]), 1000)
    assert not torch.equal(a[0], b[0]) and torch.isfinite(a).all()
    # Gumbel(0, 1): mean 0.5772, variance pi^2 / 6
    g = TE.gumbel_noise(torch.arange(64), torch.zeros(64, dtype=torch.int64), 4096)
    assert abs(float(g.mean()) - 0.5772) < 0.01 and abs(float(g.var()) - 1.6449) < 0.03


def test_random_int8_tree_quantizes_the_bf16_trees_weights():
    """The leaf-streamed int8 init is the quantization of the same float32
    weights the bf16 init casts, leaf for leaf."""
    cfg = TC.Gemma3TextConfig.tiny(vocab_size=64)
    f32 = TR.gemma3_random_params(cfg, seed=4, dtype=torch.float32, device="cpu")
    i8 = TR.gemma3_random_params_int8(cfg, seed=4, dtype=torch.float32, device="cpu")
    q = TQ.quantize_lm_params(f32)
    flat_q = dict(TR.tree_leaves(jax.tree.map(np.asarray, q)))
    flat_i8 = dict(TR.tree_leaves(jax.tree.map(np.asarray, i8)))
    assert flat_q.keys() == flat_i8.keys()
    for k in flat_q:
        np.testing.assert_array_equal(flat_q[k], flat_i8[k])
    w = f32["language_model"]["layers_0"]["mlp"]["down_proj"]["kernel"]   # [32, 16]
    assert abs(float(w.std()) - 32 ** -0.5) < 0.05


def test_engine_tree_from_a_retrievers_state_dict():
    """The ColPali retriever's Gemma LM, loaded from a flax tree, turns back
    into the same engine tree the JAX tree gives."""
    ccfg = JC.ColPaliModelConfig.tiny(vocab_size=64)
    flax = jax.tree.map(np.asarray, JR.fast_random_params(JColPali(ccfg), ccfg, seed=3))
    r = TR.load_retriever("tiny-colpali", device="cpu", dtype=torch.float32, params=flax)
    got = engine_params_from_state_dict(r.model.state_dict())
    want = engine_params_from_jax({"embed": flax["embed"],
                                   "language_model": flax["language_model"]}, device="cpu")
    flat_g, flat_w = dict(TR.tree_leaves(got)), dict(TR.tree_leaves(want))
    assert flat_g.keys() == flat_w.keys()
    for k in flat_g:
        assert torch.equal(flat_g[k], flat_w[k]), k


def test_unported_paths_raise(monkeypatch, tmp_path):
    """The engines take a mesh now (here a one-rank gloo mesh, the card's
    world size) and decode as without one; a checkpoint_dir without weights
    is no checkpoint."""
    import parallel_worker

    cfg = TC.Gemma3TextConfig.tiny(vocab_size=64)
    params = TR.gemma3_random_params(cfg, seed=0, dtype=torch.float32, device="cpu")
    prompts = [[5, 9, 17], [3, 4]]
    with parallel_worker.one_rank_mesh(tmp_path, ("data", "model")) as mesh:
        eng = TE.GemmaDecodeEngine(cfg, params, device="cpu", mesh=mesh)
        assert eng.cfg.num_attention_heads == 2 and eng.model_cfg is cfg
        assert eng.generate(prompts, max_new_tokens=5) == TE.GemmaDecodeEngine(
            cfg, params, device="cpu").generate(prompts, max_new_tokens=5)
        for qcfg in (TC.Qwen2TextConfig.tiny(), TC.LlamaTextConfig.tiny_lm()):
            qparams = TR.qwen2vl_random_params(qcfg, seed=0, dtype=torch.float32, device="cpu")
            got = TE.Qwen2DecodeEngine(qcfg, qparams, device="cpu", mesh=mesh)
            assert got.generate(prompts, max_new_tokens=4) == TE.Qwen2DecodeEngine(
                qcfg, qparams, device="cpu").generate(prompts, max_new_tokens=4)
    # a checkpoint_dir without weights is no checkpoint: random init, as in JAX
    monkeypatch.delenv("COLPALI_TPU_CKPT_DIR", raising=False)
    with pytest.warns(UserWarning, match="random init"):
        TR.load_gemma3_lm("tiny-gemma3", device="cpu", checkpoint_dir="/nonexistent")

    # the Qwen2/Llama body runs through layer_stack
    for qcfg in (TC.Qwen2TextConfig.tiny(), TC.LlamaTextConfig.tiny_lm()):
        qparams = TR.qwen2vl_random_params(qcfg, seed=0, dtype=torch.float32, device="cpu")
        hidden, (ks, vs) = TE.layer_stack(
            qparams, qcfg, torch.randn(1, 3, qcfg.hidden_size), torch.arange(3)[None],
            lambda i, k, v: (k, v), lambda i, q, k, v: q)
        assert hidden.shape == (1, 3, qcfg.hidden_size) and torch.isfinite(hidden).all()
        assert len(ks) == len(vs) == qcfg.num_hidden_layers
