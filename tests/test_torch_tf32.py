"""The arithmetic of K2's float32 kernels on the CPU: 3xTF32.

On the card, K2's float32 forward and its backward take every product on
the tensor cores in 3xTF32 (``csrc/mma.cuh``): each operand is split as
``hi = tf32(x)`` and ``lo = tf32(x - hi)`` (``cvt.rna``: nearest, ties away
from zero, the low 13 bits cleared), and ``a.b`` is taken as ``ah.bh +
ah.bl + al.bh`` with float32 sums. The CUDA kernels cannot run here, so
these tests emulate that arithmetic: the rounding on the int32 bits, each
product as three float32 einsums of tf32 operands (whose products are exact
in float32), through the forward's two products and the five of
``attention_backward_reference``. Against float64 the error stays a tenth of
the card tests' gates (forward atol 1e-4; each gradient within 1e-4 of its
largest element), while TF32 alone does not. The plain versions stay the
float32 references; nothing on the main path uses this emulation.
"""

import numpy as np
import pytest
import torch

from multimodal_colpali_tpu_torch.ops import attention as A

torch.set_num_threads(1)

NEG = A.NEG
_MASKS = ["none", "kv_lens", "kv_valid", "causal", "all"]


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest tf32 (10 explicit significand bits, ties away
    from zero), as ``cvt.rna.tf32.f32`` rounds it."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split(x: torch.Tensor):
    hi = tf32(x)
    return hi, tf32(x - hi)


def product(eq: str, a: torch.Tensor, b: torch.Tensor, passes: int = 3) -> torch.Tensor:
    """``einsum(eq, a, b)`` of float32 operands as the tensor cores take it:
    3xTF32 (``ah.bh + ah.bl + al.bh``) or, with ``passes=1``, TF32 alone."""
    ah, al = split(a)
    bh, bl = split(b)
    out = torch.einsum(eq, ah, bh)
    if passes == 3:
        out = out + torch.einsum(eq, ah, bl) + torch.einsum(eq, al, bh)
    return out


def _case(d: int, masks: str):
    """float32 q, k, v, dO ``[2, 150, 3, D]`` from a numpy seed and the
    masks of the card tests (``_attention_masks``): kv_lens [150, 51]; under
    kv_valid, every key of the last batch row masked (uniform weights)."""
    b, s, h = 2, 150, 3
    rng = np.random.default_rng(1000 * d + _MASKS.index(masks))
    q, k, v, g = (torch.from_numpy(rng.standard_normal((b, s, h, d)).astype(np.float32))
                  for _ in range(4))
    kw = {}
    if masks in ("kv_lens", "all"):
        kw["kv_lens"] = torch.tensor([s, s // 3 + 1], dtype=torch.int32)
    if masks in ("kv_valid", "all"):
        valid = torch.from_numpy(rng.random((b, s)) > 0.5)
        valid[-1] = False
        kw["kv_valid"] = valid
    if masks in ("causal", "all"):
        kw["causal"] = True
    return q, k, v, g, kw


def _probs(q, k, kw, scale, passes):
    """Unnormalised P and each row's sum, from emulated logits."""
    logits = product("bshd,bthd->bhst", q, k, passes) * scale
    keep = A._keep(q, k, None, kw.get("kv_lens"), kw.get("kv_valid"), kw.get("causal", False))
    if keep is not None:
        logits = logits.masked_fill(~keep, NEG)
    p = torch.exp(logits - logits.amax(-1, keepdim=True))
    return p, p.sum(-1, keepdim=True), keep


def emulated_forward(q, k, v, kw, scale, passes=3):
    """K2's float32 forward: S = Q.K^T, the float32 softmax, P.V with the
    unnormalised P, divided by the row sum at the end."""
    p, l, _ = _probs(q, k, kw, scale, passes)
    return product("bhst,bthd->bshd", p, v, passes) / l.transpose(1, 2)


def emulated_backward(q, k, v, out, g, kw, scale, passes=3):
    """The five products of ``attention_backward_reference`` in emulation."""
    p, l, keep = _probs(q, k, kw, scale, passes)
    p = p / l
    dv = product("bhst,bshd->bthd", p, g, passes)
    dp = product("bshd,bthd->bhst", g, v, passes)
    delta = (g * out).sum(-1).transpose(1, 2)[..., None]
    ds = p * (dp - delta)
    if keep is not None:
        ds = ds.masked_fill(~keep, 0.0)
    dq = product("bhst,bthd->bshd", ds, k, passes) * scale
    dk = product("bhst,bshd->bthd", ds, q, passes) * scale
    return dq, dk, dv


def test_tf32_rounds_to_nearest_ties_away():
    """The emulated cvt.rna: 10 explicit bits kept, the 11th rounds, a tie
    goes away from zero in both signs, and hi + lo splits exactly."""
    one = 1.0
    ulp = 2.0 ** -10
    x = torch.tensor([one + ulp / 2, -(one + ulp / 2), one + ulp / 2 - 2.0 ** -23,
                      one + 3 * ulp / 2, 3.0e-3], dtype=torch.float32)
    got = tf32(x)
    assert got[0] == one + ulp and got[1] == -(one + ulp)
    assert got[2] == one
    assert got[3] == one + 2 * ulp
    assert (got.view(torch.int32) & 0x1FFF).eq(0).all()
    hi, lo = split(x)
    assert torch.equal(hi + (x - hi), x)
    assert (lo.view(torch.int32) & 0x1FFF).eq(0).all()


@pytest.mark.parametrize("masks", _MASKS)
@pytest.mark.parametrize("d", [8, 20, 72, 128])
def test_3xtf32_forward_is_well_inside_the_gate(d, masks):
    """The forward's two products in 3xTF32 against float64: within a tenth
    of the card's atol 1e-4 (2e-6 or less seen), every mask and a fully
    masked row; TF32 alone misses that by far."""
    q, k, v, _, kw = _case(d, masks)
    scale = d ** -0.5
    want = A.attention_reference(q.double(), k.double(), v.double(), scale=scale, **kw)
    err = float((emulated_forward(q, k, v, kw, scale).double() - want).abs().max())
    assert err <= 1e-5, err
    one = float((emulated_forward(q, k, v, kw, scale, passes=1).double() - want).abs().max())
    assert one > 10 * err, (one, err)


@pytest.mark.parametrize("masks", _MASKS)
@pytest.mark.parametrize("d", [8, 20, 72, 128])
def test_3xtf32_backward_is_well_inside_the_gate(d, masks):
    """The backward's five products in 3xTF32 against float64: each of dq,
    dk, dv within a tenth of the card's gate (1e-4 of its largest element;
    2e-6 or less seen), every mask; a fully masked row sends nothing to dq
    and dk. TF32 alone misses the gate."""
    q, k, v, g, kw = _case(d, masks)
    scale = d ** -0.5
    out = A.attention_reference(q, k, v, scale=scale, **kw)
    want = A.attention_backward_reference(*(x.double() for x in (q, k, v, out, g)),
                                          scale=scale, **kw)
    got = emulated_backward(q, k, v, out, g, kw, scale)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        top = float(w.abs().max())
        err = float((a.double() - w).abs().max())
        assert err <= 1e-5 * top + 1e-8, (name, err, top)
    if "kv_valid" in kw:
        assert not got[0][-1].any() and not got[1][-1].any()
    one = emulated_backward(q, k, v, out, g, kw, scale, passes=1)
    assert max(float((a.double() - w).abs().max() / w.abs().max())
               for a, w in zip(one, want)) > 1e-4


@pytest.mark.parametrize("dtype,s,d,scale,path", [
    (torch.float32, 1024, 72, 0.12, ("tf32", 0)),          # the training path's tower
    (torch.float32, 40, 20, 0.2, ("tf32", 0)),             # every float32 D
    (torch.float32, 7, 128, -1.0, ("tf32", 0)),            # any scale
    (torch.bfloat16, 1024, 72, 0.12, ("tensor_core", 128)),
    (torch.bfloat16, 1024, 128, 0.09, ("tensor_core", 64)),
    (torch.bfloat16, 512, 80, 0.11, ("tensor_core", 128)),  # both 128-row limits met
    (torch.bfloat16, 511, 72, 0.12, ("tensor_core", 64)),   # S below 512
    (torch.bfloat16, 577, 20, 0.2, ("cuda_core", 0)),      # D not whole 16-byte chunks
    (torch.bfloat16, 64, 64, -1.0, ("cuda_core", 0)),      # the bf16 path needs scale > 0
])
def test_kernel_path_chooses_from_dtype_shape_and_scale(dtype, s, d, scale, path):
    """Every float32 call takes the 3xTF32 path: nothing float32 is left on
    the CUDA cores. The rows a block come with the path: the bf16
    tensor-core path's from :func:`block_rows`, 0 for the others."""
    assert A.kernel_path(dtype, s, d, scale) == path
