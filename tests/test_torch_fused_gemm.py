"""The K5 GEMM's plain version, its launch chains and its tile plan, on the CPU.

``gemm_reference`` is the GEMM's own contract (``epilogue(LN?(a) @ w.T +
bias)`` a segment), which the card tests and ``chip_smoke.py`` hold the
``gemm_wgmma`` kernel to. Here the chains the card runs
(``attention_chain``, ``mlp_chain``), put together from ``gemm_reference``
and K2's plain version, equal the fused references bit for bit and agree
with the JAX package's Pallas kernels in interpret mode; and the shape-only
tile plan covers every output column once without a tile crossing a weight
segment.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_colpali_tpu_torch.ops import fused_layer as TF
from multimodal_colpali_tpu_torch.ops.attention import attention_reference

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _j(a):
    return jnp.asarray(np.asarray(a))


def _weights(seed, h=256, inter=512):
    """Torch-layout weights ([out, in]) and float32 vectors, bf16-valued."""
    rng = np.random.default_rng(seed)

    def w(o, i):
        return (rng.standard_normal((o, i)) * i ** -0.5).astype(np.float32)

    def v(n, base=0.0):
        return (base + 0.1 * rng.standard_normal(n)).astype(np.float32)

    p = dict(g1=v(h, 1.0), b1=v(h), wq=w(h, h), bq=v(h), wk=w(h, h), bk=v(h), wv=w(h, h),
             bv=v(h), wo=w(h, h), bo=v(h), g2=v(h, 1.0), b2=v(h), w1=w(inter, h),
             bb1=v(inter), w2=w(h, inter), bb2=v(h))
    return {k: _t(a).to(torch.bfloat16).float() if a.ndim == 2 else _t(a) for k, a in p.items()}


ATTN = ("g1", "b1", "wq", "bq", "wk", "bk", "wv", "bv", "wo", "bo")
MLP = ("g2", "b2", "w1", "bb1", "w2", "bb2")


def _chain(which, x, p, heads, eps=1e-6):
    """The card's launch chains on the plain versions."""
    gemm = TF.gemm_reference
    if which in ("layer", "attn"):
        x = TF.attention_chain(gemm, attention_reference, x, *(p[k] for k in ATTN), heads, eps)
    if which in ("layer", "mlp"):
        x = TF.mlp_chain(gemm, x, *(p[k] for k in MLP), eps)
    return x


def _fused_reference(which, x, p, heads, eps=1e-6):
    if which == "layer":
        return TF.fused_vit_layer_reference(x, *(p[k] for k in ATTN + MLP), heads=heads, eps=eps)
    if which == "attn":
        return TF.fused_vit_attention_block_reference(x, *(p[k] for k in ATTN), heads=heads,
                                                      eps=eps)
    return TF.fused_mlp_block_reference(x, *(p[k] for k in MLP), eps=eps)


@pytest.mark.parametrize("which", ["layer", "attn", "mlp"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,s,h,heads,inter", [(2, 64, 128, 2, 256), (1, 100, 64, 4, 192)])
def test_chains_of_gemm_reference_equal_the_fused_references(which, dtype, b, s, h, heads,
                                                              inter):
    p = _weights(1, h, inter)
    p = {k: v.to(dtype) if v.dim() == 2 else v for k, v in p.items()}
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((b, s, h))
                         .astype(np.float32)).to(dtype)
    got = _chain(which, x, p, heads)
    assert got.dtype == dtype and got.shape == x.shape
    assert torch.equal(got, _fused_reference(which, x, p, heads))


@pytest.mark.parametrize("which", ["layer", "attn", "mlp"])
def test_gemm_reference_chains_match_pallas_interpret(which):
    from multimodal_colpali_tpu.ops import fused_layer as JF

    p = _weights(5)
    x = np.random.default_rng(6).standard_normal((2, 256, 256)).astype(np.float32)
    xt = _t(x).to(torch.bfloat16)
    # flax layout: a dense kernel is the transpose of the torch weight
    jp = {k: _j(v.float().numpy().T if v.dim() == 2 else v.numpy()) for k, v in p.items()}
    xj = _j(x).astype(jnp.bfloat16)
    if which == "layer":
        want = JF.fused_vit_layer(xj, *(jp[k] for k in ATTN + MLP), heads=4, interpret=True)
    elif which == "attn":
        want = JF.fused_vit_attention_block(xj, *(jp[k] for k in ATTN), heads=4, interpret=True)
    else:
        want = JF.fused_mlp_block(xj, *(jp[k] for k in MLP), interpret=True)
    got = _chain(which, xt, {k: v.to(torch.bfloat16) if v.dim() == 2 else v
                             for k, v in p.items()}, heads=4)
    # test_torch_ops.py's tolerance for the fused references: bf16 intermediates round apart
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               rtol=3e-2, atol=3e-2)


@pytest.mark.parametrize("epilogue", ["bias", "gelu", "residual"])
@pytest.mark.parametrize("ln", [False, True])
def test_gemm_reference_rounds_where_the_kernel_does(epilogue, ln):
    """LN in float32 then bf16; each product in float32 plus the float32
    bias, then bf16; gelu_tanh on that bf16 value; the residual added in
    bf16 (one rounding), per segment plane."""
    rng = np.random.default_rng(3)
    m, k, n = 9, 32, 16
    a = _t(rng.standard_normal((m, k)).astype(np.float32)).to(torch.bfloat16)
    ws = [_t(rng.standard_normal((n, k)).astype(np.float32) * 0.2).to(torch.bfloat16)
          for _ in range(1 if epilogue == "residual" else 3)]
    bs = [_t(rng.standard_normal(n).astype(np.float32)) for _ in ws]
    g, b = _t(1 + 0.1 * rng.standard_normal(k).astype(np.float32)), _t(
        0.1 * rng.standard_normal(k).astype(np.float32))
    resid = _t(rng.standard_normal((m, n)).astype(np.float32)).to(torch.bfloat16)
    got = TF.gemm_reference(a, ws, bs, epilogue, ln=(g, b) if ln else None, eps=1e-6,
                            resid=resid if epilogue == "residual" else None)
    assert got.shape == (len(ws), m, n) and got.dtype == torch.bfloat16
    x = a.float()
    if ln:
        mean = x.mean(-1, keepdim=True)
        var = (x - mean).square().mean(-1, keepdim=True)
        x = ((x - mean) / torch.sqrt(var + 1e-6) * g + b).to(torch.bfloat16).float()
    for plane, w, bias in zip(got, ws, bs):
        y = (x.double() @ w.double().t() + bias.double()).float().to(torch.bfloat16)
        if epilogue == "gelu":
            y = torch.nn.functional.gelu(y.float(), approximate="tanh").to(torch.bfloat16)
        if epilogue == "residual":
            y = (y.float() + resid.float()).to(torch.bfloat16)
        # float32 sums against float64 ones: at most one bf16 step apart
        torch.testing.assert_close(plane.float(), y.float(), rtol=2 ** -7, atol=1e-3)


def test_ln_stats_reference_is_mean_and_rstd():
    rng = np.random.default_rng(4)
    a = _t(rng.standard_normal((7, 136)).astype(np.float32) * 3 + 1).to(torch.bfloat16)
    st = TF.ln_stats_reference(a, 1e-6)
    x = a.double().numpy()
    mean = x.mean(-1)
    rstd = 1 / np.sqrt(((x - mean[:, None]) ** 2).mean(-1) + 1e-6)
    assert st.shape == (7, 2) and st.dtype == torch.float32
    np.testing.assert_allclose(st.numpy(), np.stack([mean, rstd], -1), rtol=1e-5, atol=1e-6)
    # the normalized row it gives is F.layer_norm's
    xn = (a.float() - st[:, :1]) * st[:, 1:]
    ref = torch.nn.functional.layer_norm(a.float(), (136,), eps=1e-6)
    torch.testing.assert_close(xn, ref, rtol=1e-5, atol=1e-5)


SHAPES = [(8192, 768, 3), (8192, 768, 1), (8192, 3072, 1), (16384, 768, 3), (16384, 768, 1),
          (16384, 3072, 1), (1, 128, 1), (100, 768, 3), (300, 128, 3), (130, 72, 3),
          (300, 136, 2), (4096, 1152, 3), (1, 8, 1)]


@pytest.mark.parametrize("m,nseg,segs", SHAPES)
@pytest.mark.parametrize("sms", [132, 114])
def test_gemm_plan_covers_each_column_once_within_a_segment(m, nseg, segs, sms):
    plan = TF.gemm_plan(m, nseg, segs, sms)
    assert plan == TF.gemm_plan(m, nseg, segs, sms)          # the shapes alone decide
    assert plan.bn in (128, 256)
    assert 1 <= plan.grid == min(plan.tiles, sms)
    assert plan.tiles == -(-m // TF.GEMM_BM) * -(-nseg // plan.bn) * segs
    tiles = list(TF.gemm_tiles(plan, m, nseg, segs))
    assert len(tiles) == plan.tiles
    for m0, seg, n0 in tiles:
        assert 0 <= seg < segs and m0 % TF.GEMM_BM == 0 and m0 < m
        assert 0 <= n0 < nseg and n0 % plan.bn == 0   # starts inside its segment ...
        # ... and its columns n0 .. n0 + bn - 1 past nseg are the segment's zero fill
    assert len(set(tiles)) == len(tiles)                      # each tile once
    want = {(m0, s, n0) for m0 in range(0, m, TF.GEMM_BM) for s in range(segs)
            for n0 in range(0, nseg, plan.bn)}
    assert set(tiles) == want


def test_gemm_plan_reads_no_tensor():
    """The plan takes ints: the same call for a CPU tensor's shape and a
    meta tensor's, whatever their contents."""
    shapes = [torch.zeros(300, 768).shape, torch.empty(300, 768, device="meta").shape,
              torch.full((300, 768), float("nan")).shape]
    plans = {TF.gemm_plan(s[0], s[1], 3, 132) for s in shapes}
    assert len(plans) == 1


@pytest.mark.parametrize("m,nseg,segs,bn", [
    (8192, 768, 3, 256),    # QKV: 576 tiles, 5 waves of 256 = 9 of 128
    (8192, 768, 1, 128),    # out_proj, fc2: 3 waves of 128 beat 2 of 256
    (8192, 3072, 1, 256),   # fc1
    (16384, 768, 1, 256),   # ColSmol's batch of 16: 3 waves of 256
    (300, 128, 3, 128),     # a 128-column segment never takes 256
])
def test_gemm_plan_widths_at_the_main_shapes(m, nseg, segs, bn):
    assert TF.gemm_plan(m, nseg, segs, 132).bn == bn
