"""Fused pre-LN SigLIP encoder layer (counterpart of ``multimodal_colpali_tpu/ops/fused_layer.py``).

    y = x2 + fc2(gelu_tanh(fc1(LN2(x2)))),   x2 = x + out_proj(MHA(LN1(x)))

Three functions per TPU kernel:

- the plain PyTorch versions :func:`fused_vit_layer_reference`,
  :func:`fused_vit_attention_block_reference` and
  :func:`fused_mlp_block_reference`, with the TPU kernels' rounding points
  (fused_layer.py:154-158, :285-322): LayerNorm in float32 then the
  activation dtype, each dense with float32 accumulation and a float32 bias
  then the activation dtype, gelu_tanh on the rounded fc1 output, residual
  adds in the activation dtype;
- the kernel wrappers K5a :func:`fused_vit_layer_cuda`, K5b
  :func:`fused_vit_attention_block_cuda` and K5c :func:`fused_mlp_block_cuda`;
- the dispatchers :func:`fused_vit_layer`, :func:`fused_vit_attention_block`
  and :func:`fused_mlp_block`: a CPU tensor takes the plain version, a CUDA
  tensor the kernel, with no fallback between them.

A whole layer does not fit an SM's shared memory the way it fits a TPU
core's VMEM, so on the card each wrapper is a short chain of launches of
the GEMM in ``csrc/fused_layer.cu`` (LayerNorm prologue; bias, bias +
gelu_tanh or bias + residual epilogue) and of K2 (``ops/attention.py``):
K5a = LN1·QKV, K2, out_proj + residual, LN2·fc1 + gelu, fc2 + residual;
K5b = LN1·QKV, K2, out_proj + residual; K5c = LN2·fc1 + gelu, fc2 +
residual. No LayerNorm output is written to device memory. The GEMM takes
bf16 activations on the tensor cores and float32 ones (a model run in
float32) on the CUDA cores; any other dtype raises.

Weights are in torch layout (``[out, in]``, the transpose of the flax
``kernel``), as the port's ``Dense`` modules hold them. ``layer_plan`` is
the JAX package's applicability gate, copied as it is so that the same
models take the fused path (``models/layers.py``): its VMEM estimate is a
TPU figure (SigLIP-768 admitted, SigLIP-So400m refused).
``attention_block_plan`` and ``mlp_block_plan`` pick the TPU kernels' tile
rows; nothing in the port reads them, and they exist only so that a test
holds them equal to the JAX package's.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch
import torch.nn.functional as F

from multimodal_colpali_tpu_torch import _build
from multimodal_colpali_tpu_torch.ops.attention import attention_reference, fused_attention_cuda

_VMEM_BUDGET = 14 * 1024 * 1024
_LAYER_VMEM_CEILING = 64 * 1024 * 1024
_LAYER_VMEM_LIMIT = 100 * 1024 * 1024

# csrc/fused_layer.cu epilogue and activation-dtype codes
_EPI_BIAS, _EPI_GELU, _EPI_RESIDUAL = 0, 1, 2
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


class LayerPlan(NamedTuple):
    vmem_limit: int


class AttnBlockPlan(NamedTuple):
    bq: int


class MlpBlockPlan(NamedTuple):
    bm: int


def layer_plan(s: int, h: int, inter: int, heads: int,
               dtype_bytes: int = 2) -> Optional[LayerPlan]:
    """The whole-layer kernel's applicability gate (fused_layer.py:69-97):
    a TPU VMEM estimate, or None when over the ceiling."""
    if h % heads or s % 128 or h % 128:
        return None
    db = dtype_bytes
    weights = 4 * h * h * db + 2 * h * inter * db
    io = 4 * s * h * db
    attn_peak = (s * h * 4 + 4 * s * h * db + 2 * s * s * 4 + s * h * db
                 + s * h * 4 + 2 * s * h * db)
    mlp_peak = (s * h * 4 + 2 * s * h * db + s * inter * 4 + s * inter * db
                + s * h * 4)
    if weights + io + max(attn_peak, mlp_peak) > _LAYER_VMEM_CEILING:
        return None
    return LayerPlan(vmem_limit=_LAYER_VMEM_LIMIT)


def attention_block_plan(s: int, h: int, heads: int,
                         dtype_bytes: int = 2) -> Optional[AttnBlockPlan]:
    """The attention-block kernel's gate (fused_layer.py:108-137)."""
    if h % heads or s % 128 or h % 128:
        return None
    fixed = 2 * s * h * dtype_bytes + 3 * h * h * dtype_bytes + 2 * s * h * dtype_bytes
    for bq in (256, 128):
        if s % bq:
            continue
        need = fixed + 2 * bq * h * dtype_bytes + (3 * bq * s * 4) // 2 + 2 * bq * h * 4
        if need <= _VMEM_BUDGET:
            return AttnBlockPlan(bq=bq)
    return None


def mlp_block_plan(h: int, inter: int, dtype_bytes: int = 2) -> Optional[MlpBlockPlan]:
    """The MLP-block kernel's gate (fused_layer.py:140-151)."""
    fixed = 2 * h * inter * dtype_bytes
    for bm in (256, 128):
        need = (fixed + 4 * bm * h * dtype_bytes + bm * inter * 4
                + bm * inter * dtype_bytes + 2 * bm * h * 4)
        if need <= _VMEM_BUDGET:
            return MlpBlockPlan(bm=bm)
    return None


# -- plain versions -------------------------------------------------------------

def _layernorm(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor, eps: float) -> torch.Tensor:
    y = F.layer_norm(x.float(), (x.shape[-1],), g.float(), b.float(), eps)
    return y.to(x.dtype)


def _dense(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``x @ w.T + b`` in float32 on the activation's values, cast back."""
    return (x.float() @ w.float().t() + b.float()).to(x.dtype)


def _attention_reference(x, ln_g, ln_b, wq, bq, wk, bk, wv, bv, heads, eps):
    b, s, h = x.shape
    xn = _layernorm(x, ln_g, ln_b, eps)
    shape = (b, s, heads, h // heads)
    q, k, v = (_dense(xn, w, bias).view(shape) for w, bias in ((wq, bq), (wk, bk), (wv, bv)))
    return attention_reference(q, k, v, scale=(h // heads) ** -0.5).reshape(b, s, h)


def fused_vit_attention_block_reference(x, ln_g, ln_b, wq, bq, wk, bk, wv, bv, wo, bo,
                                        *, heads: int, eps: float = 1e-6) -> torch.Tensor:
    """``x + out_proj(MHA(LN1(x)))`` for ``x [B, S, H]``, plain PyTorch."""
    attn = _attention_reference(x, ln_g, ln_b, wq, bq, wk, bk, wv, bv, heads, eps)
    return x + _dense(attn, wo, bo)


def fused_mlp_block_reference(x, ln_g, ln_b, w1, b1, w2, b2,
                              *, eps: float = 1e-6) -> torch.Tensor:
    """``x + fc2(gelu_tanh(fc1(LN2(x))))`` over the last axis, plain PyTorch."""
    hid = F.gelu(_dense(_layernorm(x, ln_g, ln_b, eps), w1, b1), approximate="tanh")
    return x + _dense(hid, w2, b2)


def fused_vit_layer_reference(x, ln1_g, ln1_b, wq, bq, wk, bk, wv, bv, wo, bo,
                              ln2_g, ln2_b, w1, b1, w2, b2,
                              *, heads: int, eps: float = 1e-6) -> torch.Tensor:
    """One pre-LN SigLIP encoder layer on ``x [B, S, H]``, plain PyTorch."""
    x2 = fused_vit_attention_block_reference(x, ln1_g, ln1_b, wq, bq, wk, bk, wv, bv, wo, bo,
                                             heads=heads, eps=eps)
    return fused_mlp_block_reference(x2, ln2_g, ln2_b, w1, b1, w2, b2, eps=eps)


# -- kernels ----------------------------------------------------------------------

def _vec(v: torch.Tensor, n: int, dev: torch.device, what: str) -> torch.Tensor:
    if v.shape != (n,):
        raise ValueError(f"{what} must have shape ({n},), got {tuple(v.shape)}")
    return v.to(device=dev, dtype=torch.float32).contiguous()


def _gemm(a: torch.Tensor, weights: Sequence[torch.Tensor], biases: Sequence[torch.Tensor],
          epilogue: int, ln: Optional[tuple] = None, eps: float = 0.0,
          resid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``csrc/fused_layer.cu``: ``epilogue(LN?(a) @ [w0; w1; w2].T + bias)``.

    ``a [M, K]`` bf16 or float32; each weight ``[Nseg, K]`` in ``a``'s dtype;
    returns ``[len(weights), M, Nseg]`` in that dtype, one plane per weight."""
    m, k = a.shape
    dev = a.device
    nseg = weights[0].shape[0]
    for i, w in enumerate(weights):
        if w.shape != (nseg, k):
            raise ValueError(f"weight {i} must be [{nseg}, {k}], got {tuple(w.shape)}")
        if w.device != dev or w.dtype != a.dtype:
            raise TypeError(f"weight {i} must be {a.dtype} on {dev}, got {w.dtype} on "
                            f"{w.device}")
    if k % 8 or nseg % 8:
        raise ValueError(f"the GEMM takes K and N in multiples of 8, got K={k}, N={nseg}")
    ws = [w.contiguous() for w in weights]
    bs = [_vec(bias, nseg, dev, f"bias {i}") for i, bias in enumerate(biases)]
    g, b = (None, None) if ln is None else (_vec(ln[0], k, dev, "LN weight"),
                                            _vec(ln[1], k, dev, "LN bias"))
    out = torch.empty((len(ws), m, nseg), dtype=a.dtype, device=dev)
    for t in (a, *ws, out) + (() if resid is None else (resid,)):
        if t.data_ptr() % 16:
            raise ValueError("the GEMM needs 16-byte aligned tensors")
    ws += [ws[0]] * (3 - len(ws))
    bs += [bs[0]] * (3 - len(bs))
    lib = _build.load("fused_layer")
    code = lib.gemm_launch(
        a.data_ptr(), None if g is None else g.data_ptr(), None if b is None else b.data_ptr(),
        float(eps), *(w.data_ptr() for w in ws), *(v.data_ptr() for v in bs),
        None if resid is None else resid.data_ptr(), out.data_ptr(),
        m, nseg * len(weights), k, nseg, epilogue, _DTYPE_CODES[a.dtype],
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, code, "gemm_launch")
    return out


def _check_x(x: torch.Tensor, what: str) -> torch.Tensor:
    if not x.is_cuda:
        raise ValueError(f"{what} needs a CUDA tensor")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"{what} takes bf16 or float32 activations, got {x.dtype}")
    return x.contiguous()


def _attention_block_cuda(x, ln_g, ln_b, wq, bq, wk, bk, wv, bv, wo, bo, heads, eps):
    b, s, h = x.shape
    if h % heads:
        raise ValueError(f"hidden {h} is not a multiple of {heads} heads")
    x2d = x.view(b * s, h)
    qkv = _gemm(x2d, (wq, wk, wv), (bq, bk, bv), _EPI_BIAS, ln=(ln_g, ln_b), eps=eps)
    shape = (b, s, heads, h // heads)
    attn = fused_attention_cuda(qkv[0].view(shape), qkv[1].view(shape), qkv[2].view(shape),
                                scale=(h // heads) ** -0.5)
    return _gemm(attn.view(b * s, h), (wo,), (bo,), _EPI_RESIDUAL, resid=x2d)[0].view(b, s, h)


def _mlp_block_cuda(x, ln_g, ln_b, w1, b1, w2, b2, eps):
    h = x.shape[-1]
    x2d = x.view(-1, h)
    hid = _gemm(x2d, (w1,), (b1,), _EPI_GELU, ln=(ln_g, ln_b), eps=eps)[0]
    return _gemm(hid, (w2,), (b2,), _EPI_RESIDUAL, resid=x2d)[0].view(x.shape)


def fused_vit_attention_block_cuda(x, ln_g, ln_b, wq, bq, wk, bk, wv, bv, wo, bo,
                                   *, heads: int, eps: float = 1e-6) -> torch.Tensor:
    """K5b on the card: LN1·QKV and K2, then out_proj + residual, on
    ``x [B, S, H]`` (bf16 or float32, the weights in the same dtype). Adds one to ``.launches`` per call."""
    x = _check_x(x, "fused_vit_attention_block_cuda")
    if x.dim() != 3:
        raise ValueError(f"expected [B, S, H], got {tuple(x.shape)}")
    y = _attention_block_cuda(x, ln_g, ln_b, wq, bq, wk, bk, wv, bv, wo, bo, heads, eps)
    fused_vit_attention_block_cuda.launches += 1
    return y


def fused_mlp_block_cuda(x, ln_g, ln_b, w1, b1, w2, b2, *, eps: float = 1e-6) -> torch.Tensor:
    """K5c on the card: LN2·fc1 + gelu_tanh, then fc2 + residual, over the
    last axis of ``x`` (bf16 or float32). Adds one to ``.launches`` per call."""
    x = _check_x(x, "fused_mlp_block_cuda")
    y = _mlp_block_cuda(x, ln_g, ln_b, w1, b1, w2, b2, eps)
    fused_mlp_block_cuda.launches += 1
    return y


def fused_vit_layer_cuda(x, ln1_g, ln1_b, wq, bq, wk, bk, wv, bv, wo, bo,
                         ln2_g, ln2_b, w1, b1, w2, b2,
                         *, heads: int, eps: float = 1e-6) -> torch.Tensor:
    """K5a on the card: a whole pre-LN SigLIP layer on ``x [B, S, H]``
    as five launches (LN1·QKV, K2, out_proj + residual, LN2·fc1 + gelu,
    fc2 + residual). Adds one to ``.launches`` per call."""
    x = _check_x(x, "fused_vit_layer_cuda")
    if x.dim() != 3:
        raise ValueError(f"expected [B, S, H], got {tuple(x.shape)}")
    x2 = _attention_block_cuda(x, ln1_g, ln1_b, wq, bq, wk, bk, wv, bv, wo, bo, heads, eps)
    y = _mlp_block_cuda(x2, ln2_g, ln2_b, w1, b1, w2, b2, eps)
    fused_vit_layer_cuda.launches += 1
    return y


fused_vit_layer_cuda.launches = 0
fused_vit_attention_block_cuda.launches = 0
fused_mlp_block_cuda.launches = 0


# -- dispatchers ----------------------------------------------------------------------

def _pick(x: torch.Tensor, kernel, plain, name: str):
    if x.device.type == "cuda":
        return kernel
    if x.device.type == "cpu":
        return plain
    raise ValueError(f"{name}: unsupported device {x.device}")


def fused_vit_layer(x, ln1_g, ln1_b, wq, bq, wk, bk, wv, bv, wo, bo, ln2_g, ln2_b,
                    w1, b1, w2, b2, *, heads: int, eps: float = 1e-6) -> torch.Tensor:
    """One pre-LN SigLIP encoder layer (fused_layer.py:326-392 semantics):
    K5a for a CUDA tensor, the plain version for a CPU tensor."""
    fn = _pick(x, fused_vit_layer_cuda, fused_vit_layer_reference, "fused_vit_layer")
    return fn(x, ln1_g, ln1_b, wq, bq, wk, bk, wv, bv, wo, bo, ln2_g, ln2_b, w1, b1, w2, b2,
              heads=heads, eps=eps)


def fused_vit_attention_block(x, ln_g, ln_b, wq, bq, wk, bk, wv, bv, wo, bo,
                              *, heads: int, eps: float = 1e-6) -> torch.Tensor:
    """``x + out_proj(MHA(LN1(x)))`` (fused_layer.py:218-273 semantics):
    K5b for a CUDA tensor, the plain version for a CPU tensor."""
    fn = _pick(x, fused_vit_attention_block_cuda, fused_vit_attention_block_reference,
               "fused_vit_attention_block")
    return fn(x, ln_g, ln_b, wq, bq, wk, bk, wv, bv, wo, bo, heads=heads, eps=eps)


def fused_mlp_block(x, ln_g, ln_b, w1, b1, w2, b2, *, eps: float = 1e-6) -> torch.Tensor:
    """``x + fc2(gelu_tanh(fc1(LN2(x))))`` (fused_layer.py:413-464 semantics):
    K5c for a CUDA tensor, the plain version for a CPU tensor."""
    fn = _pick(x, fused_mlp_block_cuda, fused_mlp_block_reference, "fused_mlp_block")
    return fn(x, ln_g, ln_b, w1, b1, w2, b2, eps=eps)
