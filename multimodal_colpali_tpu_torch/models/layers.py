"""Shared transformer blocks (counterpart of ``multimodal_colpali_tpu/models/layers.py``).

Parameters live in the model's dtype on the model's device and are created
uninitialized: a checkpoint (``models/convert.py``) or the seeded random
init (``models/registry.py``) fills them. Norms and softmax run in float32
whatever the activation dtype, as in the JAX package.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from multimodal_colpali_tpu_torch.ops.attention import attention_reference, fused_attention


def empty_param(*shape: int, device, dtype) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, device=device, dtype=dtype), requires_grad=False)


def dense(x: torch.Tensor, weight: torch.Tensor,
          bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """y = x @ weight.T (+ bias) in x's dtype (layers.py:18-36).

    ``weight`` is ``[out, in]``, the transpose of the flax ``kernel``."""
    return F.linear(x, weight.to(x.dtype), None if bias is None else bias.to(x.dtype))


class Dense(nn.Module):
    def __init__(self, in_features: int, out_features: int, bias: bool = True, *,
                 device, dtype):
        super().__init__()
        self.weight = empty_param(out_features, in_features, device=device, dtype=dtype)
        self.bias = empty_param(out_features, device=device, dtype=dtype) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return dense(x, self.weight, self.bias)


class RMSNorm(nn.Module):
    """Gemma RMSNorm: ``x / rms(x) * (1 + weight)`` in float32 (layers.py:52-64)."""

    def __init__(self, dim: int, eps: float = 1e-6, *, device, dtype):
        super().__init__()
        self.eps = eps
        self.weight = empty_param(dim, device=device, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        var = xf.square().mean(dim=-1, keepdim=True)
        y = xf * torch.rsqrt(var + self.eps) * (1.0 + self.weight.float())
        return y.to(x.dtype)


class LayerNorm(nn.Module):
    """LayerNorm with weight and bias in float32 (layers.py:67-81)."""

    def __init__(self, dim: int, eps: float = 1e-6, *, device, dtype):
        super().__init__()
        self.eps = eps
        self.weight = empty_param(dim, device=device, dtype=dtype)
        self.bias = empty_param(dim, device=device, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float(), (x.shape[-1],), self.weight.float(),
                         self.bias.float(), self.eps)
        return y.to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0) -> torch.Tensor:
    """Rotary embedding, half-split convention; x ``[B, S, H, D]``,
    positions ``[B, S]`` (layers.py:84-97)."""
    d = x.shape[-1]
    exps = torch.arange(0, d // 2, dtype=torch.float32, device=x.device) * 2.0 / d
    freq = 1.0 / (theta ** exps)
    angles = positions[..., None].float() * freq  # [B, S, D/2]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor],
    scale: float,
    kv_lens: Optional[torch.Tensor] = None,
    causal: bool = False,
    kv_valid: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Multi-head attention core with a float32 softmax (layers.py:175-231).

    q ``[B, S, Hq, D]``; k/v ``[B, T, Hkv, D]`` with Hkv dividing Hq;
    ``mask`` broadcastable to ``[B, 1, S, T]`` (True = attend).

    Routing follows layers.py:204-209: with no explicit ``mask`` and S == T
    the call goes to ``fused_attention``, which runs K2 for a CUDA tensor at
    any length (the JAX package's 512-token gate was a TPU measurement) and
    the plain version for a CPU tensor. An explicit mask takes the plain
    einsum path.
    """
    hq, hkv = q.shape[2], k.shape[2]
    if hkv != hq:
        k = k.repeat_interleave(hq // hkv, dim=2)
        v = v.repeat_interleave(hq // hkv, dim=2)
    if kv_valid is not None and kv_valid.dim() == 1:
        kv_valid = kv_valid[None].expand(q.shape[0], k.shape[1])
    if mask is None and q.shape[1] == k.shape[1]:
        return fused_attention(q, k, v, kv_lens, kv_valid, scale=scale, causal=causal)
    return attention_reference(q, k, v, mask, kv_lens, kv_valid, scale=scale, causal=causal)
