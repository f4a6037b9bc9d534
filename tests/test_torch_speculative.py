"""The port's prompt-lookup speculative decoding against the JAX package's, on the CPU.

Each case of ``tests/test_speculative.py`` runs here on four tiny LMs: the
ColPali Gemma of those tests (``fast_random_params`` seed 3), Gemma-3,
Qwen2-VL's Qwen2 and Llama, the JAX parameters carried over with
``engine_params_from_jax``. Speculation is a change of schedule only, so in
float32 every greedy stream equals the engine's ``generate`` (itself pinned
to JAX's in ``tests/test_torch_{generation,qwen2_engine}.py``) token for
token; on the Gemma of the JAX tests the port's ``speculative_generate`` and
paged batcher also equal JAX's. ``test_jax_acceptance_is_one_draft_off``
pins fault F6 (ROADMAP.md queue 3): JAX's acceptance compares the wrong
draft, so its stream can leave greedy decode, where the port's cannot.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_colpali_tpu.generation import engine as JE
from multimodal_colpali_tpu.generation import speculative as JS
from multimodal_colpali_tpu.models import registry as JR
from multimodal_colpali_tpu.models.colpali import ColPaliModel as JColPali
from multimodal_colpali_tpu.models.configs import ColPaliModelConfig as JColPaliCfg
from multimodal_colpali_tpu.models.configs import Gemma3TextConfig as JGemma3
from multimodal_colpali_tpu_torch.generation import engine as TE
from multimodal_colpali_tpu_torch.generation.paged import PagedContinuousBatcher
from multimodal_colpali_tpu_torch.generation.scheduler import ContinuousBatcher
from multimodal_colpali_tpu_torch.generation.speculative import (
    SpeculativeContinuousBatcher, SpeculativePagedContinuousBatcher, _draft,
    speculative_generate)
from multimodal_colpali_tpu_torch.models import configs as TC
from multimodal_colpali_tpu_torch.models.convert import engine_params_from_jax

torch.set_num_threads(1)

ARCHS = ["gemma", "gemma3", "qwen2", "llama"]


def _jax_lm(arch):
    """(JAX cfg, port cfg, JAX params as numpy, port engine class)."""
    if arch == "gemma":
        ccfg = JColPaliCfg.tiny(vocab_size=64)
        p = JR.fast_random_params(JColPali(ccfg), ccfg, seed=3)
        p = {"embed": p["embed"], "language_model": p["language_model"]}
        return ccfg.text, TC.ColPaliModelConfig.tiny(vocab_size=64).text, p, TE.GemmaDecodeEngine
    if arch == "gemma3":
        cfg = JGemma3.tiny(vocab_size=64)
        return cfg, TC.Gemma3TextConfig.tiny(vocab_size=64), JR.gemma3_random_params(
            cfg, seed=5), TE.GemmaDecodeEngine
    if arch == "qwen2":
        cfg = JR.QWEN2VL_CONFIGS["tiny-qwen2vl"]()
        return cfg, TC.Qwen2TextConfig.tiny(), JR.qwen2vl_random_params(cfg, 0), \
            TE.Qwen2DecodeEngine
    cfg = JR.LLAMA_CONFIGS["tiny-llama"]()
    return cfg, TC.LlamaTextConfig.tiny_lm(), JR.qwen2vl_random_params(cfg, 1), \
        TE.LlamaDecodeEngine


@pytest.fixture(scope="module", params=ARCHS)
def lm(request):
    """(arch, JAX cfg, JAX params as numpy, port engine)."""
    jcfg, tcfg, params, cls = _jax_lm(request.param)
    params = jax.tree.map(np.asarray, params)
    eng = cls(tcfg, engine_params_from_jax(params, device="cpu"), dtype=torch.float32,
              device="cpu")
    return request.param, jcfg, params, eng


def _prompts(seed, sizes):
    rng = np.random.default_rng(seed)
    return [rng.integers(2, 60, (n,)).tolist() for n in sizes]


def _greedy(eng, prompts, n, **kw):
    return [eng.generate([p], max_new_tokens=n, **kw)[0] for p in prompts]


def test_draft_finds_the_latest_full_continuation():
    toks = torch.tensor([[1, 2, 7, 8, 9, 1, 2, 5, 6, 0, 1, 2, 0, 0]])
    # the trailing [1, 2] occurs at 0 and 5; both have 3 tokens after them
    got = _draft(toks, torch.tensor([0]), torch.tensor([12]), 3, 2, pad_id=-1)
    assert got.tolist() == [[5, 6, 0]]
    # a continuation must fit before the end: at k = 6 only the one at 0 does
    got = _draft(toks, torch.tensor([0]), torch.tensor([12]), 6, 2, pad_id=-1)
    assert got.tolist() == [[7, 8, 9, 1, 2, 5]]
    assert _draft(toks, torch.tensor([3]), torch.tensor([12]), 6, 2, -1).tolist() == [[-1] * 6]


def test_speculative_matches_greedy_random_prompts(lm):
    """Low acceptance (random prompts): every verify emits at least one token."""
    _, _, _, eng = lm
    prompts = _prompts(0, (5, 11, 3, 19))
    got, acc = speculative_generate(eng, prompts, max_new_tokens=12, k=4)
    assert got == eng.generate(prompts, max_new_tokens=12)
    assert acc >= 1.0


def test_speculative_matches_greedy_repetitive_output(lm):
    """High acceptance: the tiny LMs' greedy streams fall into cycles."""
    arch, jcfg, params, eng = lm
    rng = np.random.default_rng(1)
    prompts = [rng.integers(2, 60, (rng.integers(4, 12),)).tolist() for _ in range(3)]
    want = eng.generate(prompts, max_new_tokens=24)
    got, acc = speculative_generate(eng, prompts, max_new_tokens=24, k=4)
    assert got == want
    # the JAX tests' bound, on their LM; the others' cycles are longer
    assert acc > (1.3 if arch == "gemma" else 1.0), f"no speculation benefit (acc={acc})"
    if arch == "gemma":      # the JAX tests' own case: JAX's speculative agrees
        jeng = JE.GemmaDecodeEngine(jcfg, jax.tree.map(jnp.asarray, params))
        jgot, jacc = JS.speculative_generate(jeng, prompts, max_new_tokens=24, k=4)
        assert got == jgot and acc == pytest.approx(jacc)


def test_speculative_eos_and_budget(lm):
    _, _, _, eng = lm
    prompts = [[5, 9, 17, 3], [40, 2]]
    eos = eng.generate(prompts, max_new_tokens=10)[0][3]
    got, _ = speculative_generate(eng, prompts, max_new_tokens=10, k=4, eos_id=eos)
    assert got == eng.generate(prompts, max_new_tokens=10, eos_id=eos)
    got1, _ = speculative_generate(eng, prompts, max_new_tokens=3, k=4)
    assert got1 == eng.generate(prompts, max_new_tokens=3)


def test_speculative_spans_and_k3(lm):
    """A prompt that repeats a span (drafts from the prompt itself), k = 3;
    on Gemma-3 through its sliding-window layers."""
    _, _, _, eng = lm
    span = [7, 21, 9, 33, 14]
    prompts = [span * 4, [3, 17, 42, 7, 9, 23, 55, 4, 11]]
    got, _ = speculative_generate(eng, prompts, max_new_tokens=14, k=3)
    assert got == eng.generate(prompts, max_new_tokens=14)


def test_speculative_generate_batch_size_reuse(lm):
    _, _, _, eng = lm
    prompts = _prompts(21, (5, 7))
    got2, _ = speculative_generate(eng, prompts, max_new_tokens=8, k=4)
    got1, _ = speculative_generate(eng, prompts[:1], max_new_tokens=8, k=4)
    assert got1[0] == got2[0]


def test_jax_acceptance_is_one_draft_off():
    """F6: where two drafts in a row differ, JAX accepts a window whose fed
    draft is not the token it emits (speculative.py:176), so its stream
    leaves greedy decode; the port's equals greedy."""
    jcfg, tcfg, params, cls = _jax_lm("qwen2")
    jeng = JE.Qwen2DecodeEngine(jcfg, params)
    teng = cls(tcfg, engine_params_from_jax(jax.tree.map(np.asarray, params), device="cpu"),
               dtype=torch.float32, device="cpu")
    prompts = [[int(t) for t in p] for p in _prompts(3, (10, 21, 7))]
    want = jeng.generate(prompts, max_new_tokens=16)
    jgot, _ = JS.speculative_generate(jeng, prompts, max_new_tokens=16, k=4)
    got, _ = speculative_generate(teng, prompts, max_new_tokens=16, k=4)
    assert jgot[0] != want[0]              # the fault, as the JAX package has it
    assert got == want == teng.generate(prompts, max_new_tokens=16)


# -- the speculative batchers ---------------------------------------------------------

def _bat(kind, eng, **kw):
    if kind == "dense":
        return SpeculativeContinuousBatcher(eng, batch_slots=3, max_seq_len=96, chunk=2, **kw)
    kw.setdefault("max_seq_len", 96)
    kw.setdefault("chunk", 2)
    return SpeculativePagedContinuousBatcher(eng, batch_slots=3, page_size=8, **kw)


def _plain(kind, eng, **kw):
    if kind == "dense":
        return ContinuousBatcher(eng, batch_slots=2, max_seq_len=96, chunk=2, **kw)
    return PagedContinuousBatcher(eng, batch_slots=2, max_seq_len=96, chunk=2, page_size=8, **kw)


@pytest.mark.parametrize("kind", ["dense", "paged"])
def test_spec_batcher_matches_engine_greedy(lm, kind):
    arch, jcfg, params, eng = lm
    prompts = _prompts(2 if kind == "dense" else 4, (5, 11, 19, 3))
    bat = _bat(kind, eng, spec_k=4 if arch != "gemma3" else 3)
    got = bat.generate(prompts, max_new_tokens=20)
    assert got == _greedy(eng, prompts, 20)
    assert bat.spec_accepted > bat.spec_forwards, (bat.spec_accepted, bat.spec_forwards)
    if arch == "gemma" and kind == "paged":        # and equal to JAX's paged speculation
        jeng = JE.GemmaDecodeEngine(jcfg, jax.tree.map(jnp.asarray, params))
        jb = JS.SpeculativePagedContinuousBatcher(jeng, batch_slots=3, max_seq_len=96,
                                                  chunk=2, page_size=8, spec_k=4)
        assert jb.generate(prompts, max_new_tokens=20) == got


@pytest.mark.parametrize("kind", ["dense", "paged"])
def test_spec_batcher_mixed_sampling_slots(lm, kind):
    """A sampled slot beside a greedy one: the sampled stream equals the
    plain batcher's with the same seed, the greedy one the engine's."""
    _, _, _, eng = lm
    greedy_p, temp_p = [5, 9, 17, 3], [40, 2, 8]
    ref = _plain(kind, eng)
    want_t = ref.submit(temp_p, max_new_tokens=10, temperature=1.2, seed=7)
    ref.drain()
    bat = _bat(kind, eng, spec_k=4)
    fg = bat.submit(greedy_p, max_new_tokens=10)
    ft = bat.submit(temp_p, max_new_tokens=10, temperature=1.2, seed=7)
    bat.drain()
    assert fg.result(30) == eng.generate([greedy_p], max_new_tokens=10)[0]
    assert ft.result(30) == want_t.result(30)


def test_spec_batcher_eos_and_staggered_admission(lm):
    _, _, _, eng = lm
    prompts = [[5, 9, 17, 3], [40, 2], [7, 30, 8]]
    eos = eng.generate(prompts[:1], max_new_tokens=12)[0][4]
    bat = _bat("dense", eng, spec_k=4, eos_id=eos)
    futs = [bat.submit(p, max_new_tokens=12) for p in prompts[:2]]
    with bat._lock:
        bat._admit()
        bat._step_chunk()
    futs.append(bat.submit(prompts[2], max_new_tokens=12))
    bat.drain()
    assert [f.result(30) for f in futs] == _greedy(eng, prompts, 12, eos_id=eos)


@pytest.mark.parametrize("kind", ["dense", "paged"])
def test_spec_batcher_logprobs_fall_back(lm, kind):
    _, _, _, eng = lm
    prompt = [5, 9, 17, 3]
    ref = _plain(kind, eng)
    fw = ref.submit(prompt, max_new_tokens=8, logprobs=2)
    ref.drain()
    want = fw.result(30)
    bat = _bat(kind, eng, spec_k=4)
    f = bat.submit(prompt, max_new_tokens=8, logprobs=2)
    bat.drain()
    got = f.result(30)
    assert got[0] == want[0]
    assert got[1] == pytest.approx(want[1])


def test_spec_batcher_draft_history_survives_logprobs_chunks(lm):
    _, _, _, eng = lm
    p_greedy = _prompts(22, (6, 9))
    p_lp = _prompts(23, (5,))[0]
    bat = _bat("dense", eng, spec_k=4)
    futs = [bat.submit(p, max_new_tokens=24) for p in p_greedy]
    bat.submit(p_lp, max_new_tokens=4, logprobs=1)
    saw_parent = saw_spec_after_parent = False
    with bat._lock:
        while not bat._queue.empty() or bat._readmit or bat._busy():
            bat._admit()
            if not bat._busy():
                continue
            bat._step_chunk()
            if bat._spec_dirty:
                saw_parent = True
                continue
            saw_spec_after_parent |= saw_parent
            nlen = bat._nlen.numpy()
            for slot, req in enumerate(bat._slots):
                if req is not None:
                    assert nlen[slot] == len(req.prompt) + len(req.tokens)
    assert saw_parent and saw_spec_after_parent
    assert [f.result(30) for f in futs] == _greedy(eng, p_greedy, 24)


def test_spec_paged_int8_pools(lm):
    """Accepted rows quantize to the codes sequential decode writes: streams
    equal the plain paged batcher's over int8 pools."""
    _, _, _, eng = lm
    prompts = _prompts(5, (7, 13, 4))
    ref = PagedContinuousBatcher(eng, batch_slots=3, max_seq_len=96, chunk=2, page_size=8,
                                 kv_dtype="int8")
    want = ref.generate(prompts, max_new_tokens=14)
    assert _bat("paged", eng, spec_k=4, kv_dtype="int8").generate(
        prompts, max_new_tokens=14) == want


def test_spec_paged_preemption_completes(lm):
    _, _, _, eng = lm
    prompts = [list(range(2, 18)), list(range(5, 17)), list(range(7, 21))]
    bat = _bat("paged", eng, spec_k=4, max_seq_len=64, chunk=4, pool_pages=10)
    assert bat.generate(prompts, max_new_tokens=10) == _greedy(eng, prompts, 10)
    assert bat.preemptions > 0, "pool was sized to force preemption"


def test_spec_paged_prefix_caching(lm):
    _, _, _, eng = lm
    shared = list(range(2, 20))
    prompts = [shared + [33], shared + [44, 7]]
    bat = _bat("paged", eng, spec_k=4, prefix_caching=True)
    f0 = bat.submit(prompts[0], max_new_tokens=12)
    bat.drain()
    f1 = bat.submit(prompts[1], max_new_tokens=12)
    bat.drain()
    assert [f0.result(30), f1.result(30)] == _greedy(eng, prompts, 12)
    assert bat.prefix_cache_hits > 0
