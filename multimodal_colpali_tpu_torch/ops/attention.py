"""Masked multi-head attention (counterpart of ``multimodal_colpali_tpu/ops/attention.py``).

- :func:`attention_reference` - the plain PyTorch version: float32 logits
  times ``scale``, masked logits filled with the finite ``-1e30``, a float32
  softmax, probabilities cast to the value type, P.V summed in float32
  (the einsum branch of the JAX ``models/layers.attention``, layers.py:210-231).
- :func:`fused_attention_cuda` - the hand-written CUDA kernel K2
  (``csrc/attention.cu``) that replaces the TPU kernel ``_attn_kernel``.
- :func:`fused_attention` - the dispatcher: CPU tensors take the plain
  version, CUDA tensors the kernel, with no fallback between them.

Layouts are the JAX package's: ``[B, S, H, D]`` for q, k and v.
"""

from __future__ import annotations

from typing import Optional

import torch

from multimodal_colpali_tpu_torch import _build

NEG = -1e30
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_HEAD_DIM = 128


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
    logits = torch.einsum("bshd,bthd->bhst", q.float(), k.float()) * scale
    t = k.shape[1]
    if mask is not None:
        logits = logits.masked_fill(~mask.bool(), NEG)
    if kv_valid is not None:
        logits = logits.masked_fill(~kv_valid.bool()[:, None, None, :], NEG)
    if kv_lens is not None:
        keep = torch.arange(t, device=q.device)[None, :] < kv_lens.to(q.device)[:, None]
        logits = logits.masked_fill(~keep[:, None, None, :], NEG)
    if causal:
        s = q.shape[1]
        tril = torch.ones((s, t), dtype=torch.bool, device=q.device).tril()
        logits = logits.masked_fill(~tril, NEG)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhst,bthd->bshd", probs.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


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
    kernel launch."""
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("fused_attention_cuda needs q, k, v on one CUDA device")
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must share one [B, S, H, D] shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must all be float32 or bfloat16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    b, s, h, d = q.shape
    if not 1 <= d <= _MAX_HEAD_DIM:
        raise ValueError(f"head_dim must be in [1, {_MAX_HEAD_DIM}], got {d}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if kv_lens is None:
        kv_lens = torch.full((b,), s, dtype=torch.int32, device=q.device)
    kv_lens = kv_lens.to(device=q.device, dtype=torch.int32).contiguous()
    if kv_valid is not None:
        if kv_valid.shape != (b, s):
            raise ValueError(f"kv_valid must be [B, S] = {(b, s)}, got {tuple(kv_valid.shape)}")
        kv_valid = kv_valid.to(device=q.device, dtype=torch.int32).contiguous()
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    lib = _build.load("attention")
    code = lib.attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        kv_lens.data_ptr(), None if kv_valid is None else kv_valid.data_ptr(),
        b, s, h, d, float(scale), int(bool(causal)), _DTYPE_CODES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, code, "attention_launch")
    fused_attention_cuda.launches += 1
    return out


fused_attention_cuda.launches = 0


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

    A CUDA tensor runs K2, a CPU tensor the plain version."""
    if q.device.type == "cuda":
        return fused_attention_cuda(q, k, v, kv_lens, kv_valid, scale=scale,
                                    causal=causal)
    if q.device.type == "cpu":
        return attention_reference(q, k, v, None, kv_lens, kv_valid,
                                   scale=scale, causal=causal)
    raise ValueError(f"fused_attention: unsupported device {q.device}")
