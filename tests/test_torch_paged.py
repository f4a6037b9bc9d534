"""Paged decode attention of the port (K7a, K7b plain versions) against the
JAX package, on the CPU.

The same numpy inputs go through the JAX Pallas kernels in interpret mode
(``paged_attention``/``paged_attention_int8``, as tests/test_paged.py runs
them) and through the port's dispatchers, which take the plain versions on a
CPU tensor. The kernels themselves are held against those plain versions on
the card by ``tests/test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_colpali_tpu.ops import paged_attention as JP
from multimodal_colpali_tpu_torch.ops import paged_attention as TP

torch.set_num_threads(1)


def _case(seed, b=3, hq=8, hkv=2, d=64, page=16, nb=4, zero_len=False):
    rng = np.random.default_rng(seed)
    p_phys = b * nb + 3
    q = rng.standard_normal((b, hq, d)).astype(np.float32)
    k = rng.standard_normal((p_phys, page, hkv, d)).astype(np.float32)
    v = rng.standard_normal((p_phys, page, hkv, d)).astype(np.float32)
    bt = rng.permutation(p_phys)[: b * nb].reshape(b, nb).astype(np.int32)
    lens = rng.integers(1, nb * page + 1, (b,)).astype(np.int32)
    if zero_len:
        lens[0] = 0
    return q, k, v, bt, lens


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("window", [0, 8, 16, 33])
@pytest.mark.parametrize("hq,hkv", [(8, 8), (8, 2), (8, 1)])
def test_paged_attention_plain_matches_pallas_interpret(hq, hkv, window):
    """K7a's plain version against the TPU kernel in interpret mode
    (float32; tests/test_paged.py's tolerance 1e-5)."""
    q, k, v, bt, lens = _case(1 + hq * 10 + hkv, hq=hq, hkv=hkv)
    want = JP.paged_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(bt),
                              jnp.asarray(lens), scale=0.125, interpret=True, window=window)
    got = TP.paged_attention(_t(q), _t(k), _t(v), _t(bt), _t(lens), scale=0.125, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("window", [0, 8])
def test_paged_attention_zero_length_slot_is_uniform_mean(window):
    """A slot of length 0 (every inactive batcher slot) gets the uniform
    mean of all NB * page gathered V rows: finite, not zero, as the TPU
    kernel's online softmax from the finite NEG fill gives."""
    q, k, v, bt, lens = _case(2, b=2, zero_len=True)
    want = JP.paged_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(bt),
                              jnp.asarray(lens), scale=0.125, interpret=True, window=window)
    got = TP.paged_attention(_t(q), _t(k), _t(v), _t(bt), _t(lens), scale=0.125, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    nb, page = bt.shape[1], k.shape[1]
    rows = v[bt[0]].reshape(nb * page, *v.shape[2:])            # [T, Hkv, D]
    mean = np.repeat(rows.mean(axis=0), q.shape[1] // v.shape[2], axis=0)
    np.testing.assert_allclose(got[0].numpy(), mean, rtol=1e-5, atol=1e-5)


def test_paged_attention_bf16_matches_pallas_interpret():
    q, k, v, bt, lens = _case(3, hq=4, hkv=2, d=32, page=8, nb=3)
    j = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)]
    want = JP.paged_attention(*j, jnp.asarray(bt), jnp.asarray(lens), scale=0.2,
                              interpret=True, window=6)
    t = [_t(a).to(torch.bfloat16) for a in (q, k, v)]
    got = TP.paged_attention(*t, _t(bt), _t(lens), scale=0.2, window=6)
    # bf16 operands, float32 sums in another order: the bf16 output may
    # round one unit apart
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=0, atol=2e-2)


@pytest.mark.parametrize("window", [0, 8, 16, 33])
@pytest.mark.parametrize("hq,hkv", [(8, 8), (8, 2), (8, 1)])
def test_paged_attention_int8_plain_matches_pallas_interpret(hq, hkv, window):
    """K7b's plain version (dequantize first) against the TPU int8 kernel
    in interpret mode (scales after the dots): tests/test_paged.py's 0.035."""
    q, k, v, bt, lens = _case(4 + hq + hkv, hq=hq, hkv=hkv, page=8)
    kc, ks = JP.quantize_kv_rows(jnp.asarray(k))
    vc, vs = JP.quantize_kv_rows(jnp.asarray(v))
    qb = jnp.asarray(q, jnp.bfloat16)
    want = JP.paged_attention_int8(qb, kc, ks, vc, vs, jnp.asarray(bt), jnp.asarray(lens),
                                   scale=0.125, interpret=True, window=window)
    got = TP.paged_attention_int8(_t(q).to(torch.bfloat16), _t(kc), _t(ks), _t(vc), _t(vs),
                                  _t(bt), _t(lens), scale=0.125, window=window)
    assert np.abs(got.float().numpy() - np.asarray(want, np.float32)).max() < 0.035


def test_paged_attention_int8_zero_length_slot_is_finite():
    q, k, v, bt, lens = _case(5, b=2, zero_len=True)
    kc, ks = TP.quantize_kv_rows(_t(k))
    vc, vs = TP.quantize_kv_rows(_t(v))
    got = TP.paged_attention_int8(_t(q), kc, ks, vc, vs, _t(bt), _t(lens), scale=0.125)
    assert torch.isfinite(got).all() and got[0].abs().sum() > 0


@pytest.mark.parametrize("shape", [(5, 16, 2, 64), (3, 7, 1, 8), (2, 4, 4, 128)])
def test_quantize_kv_rows_bit_exact(shape):
    """Codes and scales equal the JAX package's bit for bit, an all-zero
    row included (scale 0, codes 0)."""
    rng = np.random.default_rng(sum(shape))
    x = (rng.standard_normal(shape) * rng.uniform(0.01, 30.0, shape[:-1])[..., None]
         ).astype(np.float32)
    x[0, 0, 0] = 0.0
    jc, js = JP.quantize_kv_rows(jnp.asarray(x))
    tc, ts = TP.quantize_kv_rows(_t(x))
    assert tc.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ts.numpy().view(np.int32), np.asarray(js).view(np.int32))


def test_paged_dispatch_refuses_cpu_tensors_in_kernel_wrappers():
    q, k, v, bt, lens = (_t(a) for a in _case(6, b=1, nb=2))
    for call in (lambda: TP.paged_attention_cuda(q, k, v, bt, lens, scale=0.1),
                 lambda: TP.paged_attention_int8_cuda(q, k.to(torch.int8), lens.float(),
                                                      v.to(torch.int8), lens.float(), bt, lens,
                                                      scale=0.1)):
        before = (TP.paged_attention_cuda.launches, TP.paged_attention_int8_cuda.launches)
        with pytest.raises(ValueError, match="CUDA"):
            call()
        assert before == (TP.paged_attention_cuda.launches,
                          TP.paged_attention_int8_cuda.launches)


# -- the split plan of K7's launch (shapes only) ------------------------------------

@pytest.mark.parametrize("b,hkv,max_tokens,sms", [
    (4, 16, 2048, 132),     # the paged batcher's decode step at gemma-3-27b
    (8, 16, 4096, 132),     # chip_smoke's phase-2 case
    (1, 1, 16, 132),        # one step: one part
    (2, 1, 24, 132),        # a ragged last step
    (4, 16, 2048, 1),       # a card with one SM
    (64, 16, 2048, 132),    # more (slot, kv head) pairs than the aim: one part each
    (3, 2, 100_000, 132),   # long slots: the aim, not the steps, decides
])
def test_split_plan_reads_shapes_only(b, hkv, max_tokens, sms):
    """The plan is a function of shapes: one wave at the kernel's occupancy,
    never more parts than 16-token steps. How the kernels cut a slot's range
    into the parts is checked on the card against the kernels' own deal
    (tests/test_torch_cuda.py::test_paged_attention_deal_covers_every_token_once)."""
    splits = TP.split_plan(b, hkv, max_tokens, sms)
    steps = -(-max_tokens // TP.STEP)
    assert splits == TP.split_plan(b, hkv, max_tokens, sms)
    assert 1 <= splits <= steps                   # never more parts than 16-token steps
    # one wave at the kernel's occupancy, as full as the steps allow, or more
    # where a full slot's blocks would walk over MAX_BLOCK_TOKENS each
    chain = -(-max_tokens // TP.MAX_BLOCK_TOKENS)
    assert splits >= min(steps, chain, 65535 // b)
    assert b * hkv * splits <= max(b * hkv * chain, TP.WAVES * sms)
    assert splits == steps or splits >= chain or b * hkv * (splits + 1) > TP.WAVES * sms


def test_split_plan_fills_the_card_at_the_decode_shape():
    """4 slots of 2,048 tokens over 16 kv heads make at least one full wave
    of 132 SMs, and no more blocks than two an SM hold; phase 2's 8 slots of
    4,096 get 4 splits, so a full slot's blocks walk 1,024 tokens each."""
    splits = TP.split_plan(4, 16, 2048, 132)
    assert 4 * 16 * splits >= 132
    assert 4 * 16 * splits <= TP.WAVES * 132 < 4 * 16 * (splits + 1)
    assert TP.split_plan(4, 16, 2048, 132) == splits    # lengths never enter
    assert TP.split_plan(8, 16, 4096, 132) == 4


@pytest.mark.parametrize("q_dtype,kv_dtype,d,group,want", [
    (torch.bfloat16, torch.bfloat16, 128, 2, True),     # gemma-3-27b
    (torch.bfloat16, torch.int8, 128, 2, True),         # its int8 pools (K7b)
    (torch.bfloat16, torch.bfloat16, 256, 8, True),     # Gemma-1 2B
    (torch.bfloat16, torch.bfloat16, 64, 16, True),
    (torch.float32, torch.float32, 128, 2, False),      # float32: the CUDA cores
    (torch.float32, torch.int8, 128, 2, False),
    (torch.bfloat16, torch.bfloat16, 20, 3, False),     # D not a multiple of 16
    (torch.bfloat16, torch.bfloat16, 8, 2, False),
    (torch.bfloat16, torch.bfloat16, 512, 1, False),    # D above 256
    (torch.bfloat16, torch.bfloat16, 64, 32, False),    # group above 16
])
def test_tensor_core_path_gate(q_dtype, kv_dtype, d, group, want):
    assert TP.tensor_core_path(q_dtype, kv_dtype, d, group) is want


def test_deal_cuda_refuses_a_cpu_tensor():
    with pytest.raises(ValueError, match="CUDA"):
        TP.deal_cuda(torch.tensor([3, 0], dtype=torch.int32), window=0, total=64, splits=2)


@pytest.mark.parametrize("lengths,window,want_rows", [
    ([309, 709, 1109, 1509], 0, 2 * 3636),                      # the decode step
    ([309, 709, 1109, 1509], 1024, 2 * (309 + 709 + 1024 + 1024)),
    ([0, 16], 0, 2048 + 32),        # an empty slot reads its NB * page V rows only
    ([0, 0], 1024, 2 * 2048),
    ([5], 1024, 10),
])
def test_paged_sweep_counts_the_rows_the_kernel_reads(lengths, window, want_rows):
    """The sweep's byte bound: K and V rows of each needed token of every kv
    head, V rows only for an empty slot (NB 128, pages of 16, 16 kv heads)."""
    from multimodal_colpali_tpu_torch.generation import paged_sweep

    assert paged_sweep.kv_bytes(lengths, window, 128, 16, 16, 256) == want_rows * 16 * 256


def test_paged_sweep_needs_a_card(monkeypatch, capsys):
    from multimodal_colpali_tpu_torch.generation import paged_sweep

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert paged_sweep.main([]) == 2
    assert "CUDA is not available" in capsys.readouterr().err
