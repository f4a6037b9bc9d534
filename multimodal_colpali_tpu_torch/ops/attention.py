"""Masked multi-head attention (counterpart of ``multimodal_colpali_tpu/ops/attention.py``).

- :func:`attention_reference` - the plain PyTorch version: float32 logits
  times ``scale``, masked logits filled with the finite ``-1e30``, a float32
  softmax, probabilities cast to the value type, P.V summed in float32
  (the einsum branch of the JAX ``models/layers.attention``, layers.py:210-231).
- :func:`fused_attention_cuda` - the hand-written CUDA kernel K2
  (``csrc/attention.cu``) that replaces the TPU kernel ``_attn_kernel``:
  three paths, chosen by :func:`kernel_path`: float32 on the tensor cores in
  3xTF32, bf16 with D % 8 == 0 on the tensor cores (:func:`block_rows`), and
  the rest of bf16 on the CUDA cores.
- :func:`attention_backward_reference` - the plain version of K2's gradient,
  and :func:`fused_attention_backward_cuda` its hand-written CUDA kernel
  (``csrc/attention_backward.cu``, float32 on the tensor cores in 3xTF32).
  The TPU kernel has no backward (``pallas_call`` has no reverse mode, so
  ``jax.grad`` through it raises): the JAX trainer's gradient is autodiff of
  the einsum branch, whose counterpart this is.
- :func:`fused_attention` - the dispatcher: CPU tensors take the plain
  version, CUDA tensors the kernel, with no fallback between them. Under
  grad, with q, k or v requiring grad, it goes through the autograd Function
  ``_FusedAttention`` (the same forward, then the backward kernel or its
  plain version), or on the CPU in bf16 or float16 through autograd of the
  plain version; otherwise it calls the forward alone and saves nothing.

Layouts are the JAX package's: ``[B, S, H, D]`` for q, k and v.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch.autograd.function import once_differentiable

from multimodal_colpali_tpu_torch import _build
from multimodal_colpali_tpu_torch.ops._grad import refuse_grad

NEG = -1e30
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_HEAD_DIM = 128


def block_rows(dtype: torch.dtype, s: int, d: int) -> int:
    """Query rows a block of K2's bf16 tensor-core path takes for ``[B, S,
    H, D]`` inputs of ``dtype``, or 0 where that path is not taken. bf16
    with D a multiple of 8 (the row stride is then whole 16-byte cp.async
    chunks) and at most 128 goes to it: 128 rows a block (two 16-row tiles a
    warp, sharing each K and V fragment) from S = 512 on where D <= 80
    leaves the registers for it, else 64. Other bf16 D take the CUDA cores;
    float32 takes its own 3xTF32 path (64 rows a block, :func:`kernel_path`)."""
    if dtype != torch.bfloat16 or d % 8 or not 1 <= d <= _MAX_HEAD_DIM:
        return 0
    return 128 if s >= 512 and d <= 80 else 64


def kernel_path(dtype: torch.dtype, s: int, d: int, scale: float) -> Tuple[str, int]:
    """The path K2 takes for ``[B, S, H, D]`` inputs of ``dtype`` and the
    query rows a block that its launch is given -> ``(path, rows)``: ("tf32",
    0) for float32, every D (3xTF32 on the tensor cores); ("tensor_core",
    :func:`block_rows`) for bf16 where that is > 0 and scale > 0 (the path
    takes each row's max before the scale); else ("cuda_core", 0)."""
    if dtype == torch.float32:
        return "tf32", 0
    rows = block_rows(dtype, s, d)
    return ("tensor_core", rows) if rows and scale > 0 else ("cuda_core", 0)


def attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    kv_lens: Optional[torch.Tensor] = None,
    kv_valid: Optional[torch.Tensor] = None,
    *,
    scale: float,
    causal: bool = False,
) -> torch.Tensor:
    """Attention on ``[B, S, H, D]`` q and ``[B, T, H, D]`` k/v (heads equal).

    ``mask`` broadcasts to ``[B, 1, S, T]`` (True = attend); ``kv_lens``
    ``[B]`` keeps keys below each length; ``kv_valid`` ``[B, T]`` keeps keys
    marked True; ``causal`` keeps keys at or before the query. A row whose
    keys are all masked gets uniform weights, as in the JAX package.
    """
    ct = _compute_dtype(q.dtype)
    logits = torch.einsum("bshd,bthd->bhst", q.to(ct), k.to(ct)) * scale
    keep = _keep(q, k, mask, kv_lens, kv_valid, causal)
    if keep is not None:
        logits = logits.masked_fill(~keep, NEG)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhst,bthd->bshd", probs.to(v.dtype).to(ct), v.to(ct))
    return out.to(q.dtype)


def _compute_dtype(dtype: torch.dtype) -> torch.dtype:
    """float32 for float32 and narrower types; float64 stays float64 (the
    CPU's gradcheck)."""
    return torch.promote_types(dtype, torch.float32)


def _keep(q, k, mask, kv_lens, kv_valid, causal) -> Optional[torch.Tensor]:
    """The attended (query, key) pairs as one boolean broadcasting to
    ``[B, 1, S, T]``, or None when nothing is masked."""
    s, t = q.shape[1], k.shape[1]
    keep = None if mask is None else mask.bool()
    if kv_valid is not None:
        keep = _and(keep, kv_valid.bool().to(q.device)[:, None, None, :])
    if kv_lens is not None:
        lens = torch.arange(t, device=q.device)[None, :] < kv_lens.to(q.device)[:, None]
        keep = _and(keep, lens[:, None, None, :])
    if causal:
        keep = _and(keep, torch.ones((s, t), dtype=torch.bool, device=q.device).tril())
    return keep


def _and(a: Optional[torch.Tensor], b: torch.Tensor) -> torch.Tensor:
    return b if a is None else a & b


def attention_backward_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    out: torch.Tensor,
    dout: torch.Tensor,
    kv_lens: Optional[torch.Tensor] = None,
    kv_valid: Optional[torch.Tensor] = None,
    *,
    scale: float,
    causal: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradient of :func:`attention_reference` (no ``mask``) at ``out``
    for the output gradient ``dout`` -> ``(dq, dk, dv)``, in float32 (float64
    for float64 inputs), as K2's backward computes it:

    ``P = softmax(masked logits)``, ``dV = P^T dO``, ``dP = dO V^T``,
    ``D = rowsum(dO * O)``, ``dS = P (dP - D)`` set to 0 on masked pairs
    (``masked_fill`` passes no gradient to them), ``dQ = scale dS K``,
    ``dK = scale dS^T Q``. A row whose keys are all masked has uniform P:
    it still sends ``P dO`` to dV, and nothing to dQ or dK."""
    ct = _compute_dtype(q.dtype)
    qf, kf, vf, of, df = (x.to(ct) for x in (q, k, v, out, dout))
    logits = torch.einsum("bshd,bthd->bhst", qf, kf) * scale
    keep = _keep(q, k, None, kv_lens, kv_valid, causal)
    if keep is not None:
        logits = logits.masked_fill(~keep, NEG)
    p = torch.softmax(logits, dim=-1)
    dv = torch.einsum("bhst,bshd->bthd", p, df)
    dp = torch.einsum("bshd,bthd->bhst", df, vf)
    delta = (df * of).sum(-1).transpose(1, 2)[..., None]  # [B, H, S, 1]
    ds = p * (dp - delta)
    if keep is not None:
        ds = ds.masked_fill(~keep, 0.0)
    dq = torch.einsum("bhst,bthd->bshd", ds, kf) * scale
    dk = torch.einsum("bhst,bshd->bthd", ds, qf) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def fused_attention_cuda(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_lens: Optional[torch.Tensor] = None,
    kv_valid: Optional[torch.Tensor] = None,
    *,
    scale: float,
    causal: bool = False,
) -> torch.Tensor:
    """K2 on the card: self-attention over ``[B, S, H, D]``, D <= 128.

    q, k and v share one shape and one dtype (float32 or bf16); repeat K/V
    heads for GQA first. Adds one to ``fused_attention_cuda.launches`` per
    kernel launch, and one to ``.tf32_launches``, ``.tensor_core_launches``
    or ``.cuda_core_launches`` by the path it took (:func:`kernel_path`).
    Under grad, with an input that requires grad, it raises:
    :func:`fused_attention` carries the gradient."""
    refuse_grad("fused_attention_cuda", q, k, v)
    q, k, v, kv_lens, kv_valid = _checked("fused_attention_cuda", (q, k, v), kv_lens,
                                          kv_valid, _DTYPE_CODES)
    b, s, h, d = q.shape
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    path, rows = kernel_path(q.dtype, s, d, scale)
    lib = _build.load("attention")
    code = lib.attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        kv_lens.data_ptr(), None if kv_valid is None else kv_valid.data_ptr(),
        b, s, h, d, float(scale), int(bool(causal)), _DTYPE_CODES[q.dtype], rows,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, code, "attention_launch")
    fused_attention_cuda.launches += 1
    setattr(fused_attention_cuda, f"{path}_launches",
            getattr(fused_attention_cuda, f"{path}_launches") + 1)
    return out


fused_attention_cuda.launches = 0
fused_attention_cuda.tf32_launches = 0
fused_attention_cuda.tensor_core_launches = 0
fused_attention_cuda.cuda_core_launches = 0


def _checked(name: str, tensors, kv_lens, kv_valid, dtypes):
    """``tensors`` (q, k, v, ...: one CUDA device, one ``[B, S, H, D]`` shape
    with D <= 128, one dtype of ``dtypes``) made contiguous, ``kv_lens``
    (default S) and ``kv_valid`` as int32 on their device -> ``(*tensors,
    kv_lens, kv_valid)``."""
    q = tensors[0]
    if not (q.is_cuda and all(x.device == q.device for x in tensors)):
        raise ValueError(f"{name} needs q, k, v on one CUDA device")
    if q.dim() != 4 or any(x.shape != q.shape for x in tensors):
        raise ValueError(f"{name}: q, k, v must share one [B, S, H, D] shape, got "
                         f"{', '.join(str(tuple(x.shape)) for x in tensors)}")
    if q.dtype not in dtypes or any(x.dtype != q.dtype for x in tensors):
        raise TypeError(f"{name}: inputs must all be one of "
                        f"{', '.join(str(t) for t in dtypes)}, got "
                        f"{', '.join(str(x.dtype) for x in tensors)}")
    b, s, _, d = q.shape
    if not 1 <= d <= _MAX_HEAD_DIM:
        raise ValueError(f"head_dim must be in [1, {_MAX_HEAD_DIM}], got {d}")
    if kv_lens is None:
        kv_lens = torch.full((b,), s, dtype=torch.int32, device=q.device)
    kv_lens = kv_lens.to(device=q.device, dtype=torch.int32).contiguous()
    if kv_valid is not None:
        if kv_valid.shape != (b, s):
            raise ValueError(f"kv_valid must be [B, S] = {(b, s)}, got {tuple(kv_valid.shape)}")
        kv_valid = kv_valid.to(device=q.device, dtype=torch.int32).contiguous()
    return (*(x.contiguous() for x in tensors), kv_lens, kv_valid)


def fused_attention_backward_cuda(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    out: torch.Tensor,
    dout: torch.Tensor,
    kv_lens: Optional[torch.Tensor] = None,
    kv_valid: Optional[torch.Tensor] = None,
    *,
    scale: float,
    causal: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K2's backward on the card (``csrc/attention_backward.cu``):
    :func:`attention_backward_reference` for float32 ``[B, S, H, D]`` q, k, v,
    the forward's ``out`` and its gradient ``dout`` -> ``(dq, dk, dv)``.

    Two launches, every product on the tensor cores in 3xTF32: dQ over
    query blocks (which first takes each row's max, the inverse of its sum
    of exponentials and ``rowsum(dO * O)`` into a float32 scratch), then dK
    and dV over key blocks. Adds one to
    ``fused_attention_backward_cuda.launches`` per call."""
    refuse_grad("fused_attention_backward_cuda", q, k, v, out, dout)
    q, k, v, out, dout, kv_lens, kv_valid = _checked(
        "fused_attention_backward_cuda", (q, k, v, out, dout), kv_lens, kv_valid,
        (torch.float32,))
    b, s, h, d = q.shape
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    if q.numel() == 0:
        return dq, dk, dv
    stats = torch.empty((3, b * h * s), dtype=torch.float32, device=q.device)
    lib = _build.load("attention_backward")
    code = lib.attention_backward_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), stats.data_ptr(), kv_lens.data_ptr(),
        None if kv_valid is None else kv_valid.data_ptr(), b, s, h, d, float(scale),
        int(bool(causal)), torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, code, "attention_backward_launch")
    fused_attention_backward_cuda.launches += 1
    return dq, dk, dv


fused_attention_backward_cuda.launches = 0


class _FusedAttention(torch.autograd.Function):
    """:func:`fused_attention` with a gradient: the forward is K2 (a CUDA
    tensor) or :func:`attention_reference` (a CPU tensor), the backward
    :func:`fused_attention_backward_cuda` or
    :func:`attention_backward_reference` on the saved q, k, v and output."""

    @staticmethod
    def forward(ctx, q, k, v, kv_lens, kv_valid, scale, causal):
        if q.device.type == "cuda":
            out = fused_attention_cuda(q, k, v, kv_lens, kv_valid, scale=scale, causal=causal)
        else:
            out = attention_reference(q, k, v, None, kv_lens, kv_valid, scale=scale,
                                      causal=causal)
        ctx.save_for_backward(q, k, v, out, kv_lens, kv_valid)
        ctx.scale, ctx.causal = scale, causal
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, dout):
        q, k, v, out, kv_lens, kv_valid = ctx.saved_tensors
        grad = (fused_attention_backward_cuda if q.device.type == "cuda"
                else attention_backward_reference)
        dq, dk, dv = grad(q, k, v, out, dout, kv_lens, kv_valid, scale=ctx.scale,
                          causal=ctx.causal)
        return dq, dk, dv, None, None, None, None


def fused_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_lens: Optional[torch.Tensor] = None,
    kv_valid: Optional[torch.Tensor] = None,
    *,
    scale: float,
    causal: bool = False,
) -> torch.Tensor:
    """Self-attention with (kv_lens ``[B]``, kv_valid ``[B, S]``, causal) masks
    on ``[B, S, H, D]``.

    A CUDA tensor runs K2, a CPU tensor the plain version. Under grad, with
    q, k or v requiring grad, a float32 (or, on the CPU, float64) call goes
    through ``_FusedAttention``, whose backward is K2's backward kernel or,
    on the CPU, its plain version. On the CPU a bf16 or float16 call takes
    autograd through the plain version, as the JAX trainer differentiates
    its einsum in any dtype. On the card a bf16 call under grad raises
    ``NotImplementedError``: K2's bf16 forward rounds P to bf16, and no
    kernel computes that function's gradient."""
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"fused_attention: unsupported device {q.device}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        if q.device.type == "cpu" and q.dtype in (torch.bfloat16, torch.float16):
            return attention_reference(q, k, v, None, kv_lens, kv_valid, scale=scale,
                                       causal=causal)
        allowed = (torch.float32,) if q.device.type == "cuda" else (torch.float32, torch.float64)
        if q.dtype not in allowed:
            raise NotImplementedError(
                f"fused_attention: no gradient for {q.dtype} on {q.device.type}; "
                f"train in {' or '.join(map(str, allowed))}")
        return _FusedAttention.apply(q, k, v, kv_lens, kv_valid, scale, causal)
    if q.device.type == "cuda":
        return fused_attention_cuda(q, k, v, kv_lens, kv_valid, scale=scale,
                                    causal=causal)
    return attention_reference(q, k, v, None, kv_lens, kv_valid, scale=scale, causal=causal)
