"""Shared transformer blocks (counterpart of ``multimodal_colpali_tpu/models/layers.py``).

Parameters live in the model's dtype on the model's device and are created
uninitialized: a checkpoint (``models/convert.py``) or the seeded random
init (``models/registry.py``) fills them. Norms and softmax run in float32
whatever the activation dtype, as in the JAX package.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from multimodal_colpali_tpu_torch.ops.attention import attention_reference, fused_attention
from multimodal_colpali_tpu_torch.ops.quant import w8a8_dense
from multimodal_colpali_tpu_torch.parallel.mesh import copy_to_model, reduce_from_model


def empty_param(*shape: int, device, dtype) -> nn.Parameter:
    """A frozen parameter: inference builds no autograd graph. The trainer
    thaws a model with :func:`set_trainable`."""
    return nn.Parameter(torch.empty(shape, device=device, dtype=dtype), requires_grad=False)


def set_trainable(model: nn.Module, trainable: bool = True) -> nn.Module:
    """Make every floating-point parameter of ``model`` require grad (or
    not); int8 codes stay frozen. Returns ``model``."""
    for p in model.parameters():
        if p.is_floating_point():
            p.requires_grad_(trainable)
    return model


def dense(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor] = None,
          scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """y = x @ weight.T (+ bias) in x's dtype (layers.py:18-36).

    ``weight`` is ``[out, in]``, the transpose of the flax ``kernel``. An
    int8 ``weight`` with its per-output-channel ``scale`` (an encoder under
    ``quantize="int8"``) runs W8A8 (``ops/quant.w8a8_dense``)."""
    if weight.dtype == torch.int8:
        return w8a8_dense(x, weight, scale, bias)
    return F.linear(x, weight.to(x.dtype), None if bias is None else bias.to(x.dtype))


def _cut(p: nn.Parameter, dim: int, size: int, rank: int) -> nn.Parameter:
    """This rank's ``1/size`` of ``p`` along ``dim``, a parameter of its own."""
    n = p.shape[dim]
    if n % size:
        raise ValueError(f"dimension {dim} of {tuple(p.shape)} does not split over {size} "
                         f"model ranks")
    part = p.detach().narrow(dim, rank * (n // size), n // size).clone()
    return nn.Parameter(part, requires_grad=p.requires_grad)


class Dense(nn.Module):
    """A dense projection; ``ops/quant.quantize_encoder_params`` turns its
    weight into int8 codes and sets ``weight_scale``.

    :meth:`shard_` makes it one rank's part of a tensor-parallel layer
    (``tp_split``): "col" keeps a slice of the output features (weight rows
    and bias entries), "row" a slice of the input features, whose partial
    products are summed over the axis before the whole bias is added once,
    and "sum" keeps it whole while each rank uses part of its output, so its
    gradients are summed over the axis by the trainer."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True, *,
                 device, dtype):
        super().__init__()
        self.weight = empty_param(out_features, in_features, device=device, dtype=dtype)
        self.bias = empty_param(out_features, device=device, dtype=dtype) if bias else None
        self.register_buffer("weight_scale", None)
        self.tp_split: Optional[str] = None
        self.tp = None                     # (mesh, axis) of a row-parallel projection

    def shard_(self, split: str, mesh, axis: str) -> None:
        if self.weight.dtype == torch.int8:
            raise ValueError("int8 (W8A8) projections do not shard")
        size, rank = mesh.size(axis), mesh.index(axis)
        if split == "col":
            self.weight = _cut(self.weight, 0, size, rank)
            if self.bias is not None:
                self.bias = _cut(self.bias, 0, size, rank)
        elif split == "row":
            self.weight = _cut(self.weight, 1, size, rank)
            self.tp = (mesh, axis)
        elif split != "sum":
            raise ValueError(f"tensor-parallel split must be col/row/sum, got {split!r}")
        self.tp_split = split

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.tp is None:
            return dense(x, self.weight, self.bias, self.weight_scale)
        y = reduce_from_model(self.tp[0], dense(x, self.weight), self.tp[1])
        return y if self.bias is None else y + self.bias.to(y.dtype)


def tp_input(x: torch.Tensor, tp) -> torch.Tensor:
    """A layer's normalized input entering its tensor-parallel projections
    (``tp`` the layer's (mesh, axis), None off a mesh): once a block, so the
    gradient that reaches the norm and the residual stream is the sum of
    every rank's heads or hidden units, equal on every rank."""
    return x if tp is None else copy_to_model(tp[0], x, tp[1])


def tp_plan(model: nn.Module) -> Dict[str, Tuple[Optional[int], bool]]:
    """``{parameter name: (split dim, gradient summed over the model axis)}``
    of ``model``'s tensor-parallel projections: dim 0 for a column slice and
    its bias, 1 for a row slice, None for a projection kept whole whose
    gradient every rank holds a part of. Every other parameter is replicated
    and absent."""
    plan: Dict[str, Tuple[Optional[int], bool]] = {}
    for name, mod in model.named_modules():
        split = getattr(mod, "tp_split", None) if isinstance(mod, Dense) else None
        if split is None:
            continue
        prefix = f"{name}." if name else ""
        plan[prefix + "weight"] = ({"col": 0, "row": 1}.get(split), split == "sum")
        if mod.bias is not None and split != "row":
            plan[prefix + "bias"] = (0 if split == "col" else None, split == "sum")
    return plan


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


class LlamaRMSNorm(nn.Module):
    """Qwen2/Llama RMSNorm: ``x / rms(x) * weight`` in float32, no ``1 +``
    (qwen2vl.py:511-521); its neutral weight is 1."""

    def __init__(self, dim: int, eps: float = 1e-6, *, device, dtype):
        super().__init__()
        self.eps = eps
        self.weight = empty_param(dim, device=device, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        var = xf.square().mean(dim=-1, keepdim=True)
        return (xf * torch.rsqrt(var + self.eps) * self.weight.float()).to(x.dtype)


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


# The fused SigLIP-layer path (ops/fused_layer.py, K5a-c), as the JAX
# package's gate (layers.py:129-172): None = auto, taken for a CUDA tensor
# whose layer shape ``layer_plan`` admits (SigLIP-768 yes, So400m no), in
# any dtype: the kernels take bf16 and float32 and raise on anything else;
# True forces it wherever the plan admits the shape (a CPU tensor then
# runs the plain versions of the fused functions); False turns it off.
# ``_FUSED_PARTS`` picks the whole-layer kernel ("both") or one of the two
# partial kernels ("attn", "mlp").
_FUSED_LAYER: Optional[bool] = None
_FUSED_PARTS: str = "both"


def set_fused_layer(enabled: Optional[bool]) -> None:
    global _FUSED_LAYER
    _FUSED_LAYER = None if enabled is None else bool(enabled)


def set_fused_parts(parts: str) -> None:
    if parts not in ("both", "attn", "mlp"):
        raise ValueError(f"fused parts must be both/attn/mlp, got {parts!r}")
    global _FUSED_PARTS
    _FUSED_PARTS = parts


# The K2 route of ``attention`` (layers.py:111-126): None = today's rule, K2
# for every CUDA tensor (the plain version on the CPU); True the same; False
# sends every call to ``attention_reference``, the einsum branch, also on
# the card (chip_smoke's plain-version training step).
_FUSED_ATTENTION: Optional[bool] = None


def set_fused_attention(enabled: Optional[bool]) -> None:
    global _FUSED_ATTENTION
    _FUSED_ATTENTION = None if enabled is None else bool(enabled)


def _fused_layer_enabled(x: torch.Tensor, hidden: int, inter: int, heads: int) -> bool:
    """Whether a SigLIP layer on ``x [B, S, hidden]`` takes the fused path."""
    if _FUSED_LAYER is False:
        return False
    from multimodal_colpali_tpu_torch.ops.fused_layer import layer_plan

    if layer_plan(x.shape[1], hidden, inter, heads, x.element_size()) is None:
        return False
    if _FUSED_LAYER:
        return True
    return x.device.type == "cuda"


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
    the plain version for a CPU tensor, with K2's backward under grad. An
    explicit mask, or ``set_fused_attention(False)``, takes the plain einsum
    path.
    """
    hq, hkv = q.shape[2], k.shape[2]
    if hkv != hq:
        k = k.repeat_interleave(hq // hkv, dim=2)
        v = v.repeat_interleave(hq // hkv, dim=2)
    if kv_valid is not None and kv_valid.dim() == 1:
        kv_valid = kv_valid[None].expand(q.shape[0], k.shape[1])
    if mask is None and q.shape[1] == k.shape[1] and _FUSED_ATTENTION is not False:
        return fused_attention(q, k, v, kv_lens, kv_valid, scale=scale, causal=causal)
    return attention_reference(q, k, v, mask, kv_lens, kv_valid, scale=scale, causal=causal)
