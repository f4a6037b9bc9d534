"""SigLIP vision tower (counterpart of ``multimodal_colpali_tpu/models/siglip.py``).

NHWC pixels in, ``[B, num_patches, hidden]`` out: one strided patch
convolution, a learned position table, pre-LN encoder layers with
``gelu(approximate="tanh")`` MLPs, and a final LayerNorm. Self-attention has
no mask, so on a CUDA tensor it runs K2 (``ops/attention.py``).

A layer whose shape ``layer_plan`` admits (SigLIP-768, ColSmol's tower)
takes the fused path on a CUDA tensor, as siglip.py:85-121 does on a TPU:
K5a for the whole layer, or K5b / K5c for one half
(``layers.set_fused_parts``). SigLIP-So400m (ColPali) is refused by the plan
and runs the unfused layer, whose attention is K2. So does a layer whose
projections are W8A8 int8 (``ops/quant``), on ``w8a8_dense``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from multimodal_colpali_tpu_torch.models import layers as L
from multimodal_colpali_tpu_torch.models.configs import SiglipVisionConfig
from multimodal_colpali_tpu_torch.ops import fused_layer as FL


class SiglipMLP(nn.Module):
    def __init__(self, cfg: SiglipVisionConfig, *, device, dtype):
        super().__init__()
        self.fc1 = L.Dense(cfg.hidden_size, cfg.intermediate_size, device=device, dtype=dtype)
        self.fc2 = L.Dense(cfg.intermediate_size, cfg.hidden_size, device=device, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x), approximate="tanh"))


class SiglipAttention(nn.Module):
    def __init__(self, cfg: SiglipVisionConfig, *, device, dtype):
        super().__init__()
        self.cfg = cfg
        self.heads = cfg.num_attention_heads      # this rank's, on a tensor-parallel mesh
        h = cfg.hidden_size
        self.q_proj = L.Dense(h, h, device=device, dtype=dtype)
        self.k_proj = L.Dense(h, h, device=device, dtype=dtype)
        self.v_proj = L.Dense(h, h, device=device, dtype=dtype)
        self.out_proj = L.Dense(h, h, device=device, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        head_dim = c.hidden_size // c.num_attention_heads
        b, s, _ = x.shape
        shape = (b, s, self.heads, head_dim)
        q = self.q_proj(x).view(shape)
        k = self.k_proj(x).view(shape)
        v = self.v_proj(x).view(shape)
        out = L.attention(q, k, v, mask=None, scale=head_dim ** -0.5)
        return self.out_proj(out.reshape(b, s, self.heads * head_dim))


class SiglipEncoderLayer(nn.Module):
    def __init__(self, cfg: SiglipVisionConfig, *, device, dtype):
        super().__init__()
        self.cfg = cfg
        kw = dict(device=device, dtype=dtype)
        self.layer_norm1 = L.LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, **kw)
        self.self_attn = SiglipAttention(cfg, **kw)
        self.layer_norm2 = L.LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, **kw)
        self.mlp = SiglipMLP(cfg, **kw)
        self.tp = None       # (mesh, axis) once :meth:`shard_` made it a rank's part

    def shard_(self, mesh, axis: str = "model") -> None:
        """Make this layer one rank's part of a tensor-parallel layer over
        ``axis``: whole heads of the attention (q/k/v columns, ``out_proj``
        rows) and a slice of the MLP's hidden units (``fc1`` columns, ``fc2``
        rows); the norms and the row projections' biases stay whole."""
        a, m, tp = self.self_attn, self.mlp, mesh.size(axis)
        if a.heads % tp:
            raise ValueError(f"{a.heads} SigLIP heads do not split over {tp} model ranks")
        for proj in (a.q_proj, a.k_proj, a.v_proj, m.fc1):
            proj.shard_("col", mesh, axis)
        for proj in (a.out_proj, m.fc2):
            proj.shard_("row", mesh, axis)
        a.heads //= tp
        self.tp = (mesh, axis)

    def _attn_params(self):
        a, ln = self.self_attn, self.layer_norm1
        return (ln.weight, ln.bias, a.q_proj.weight, a.q_proj.bias, a.k_proj.weight,
                a.k_proj.bias, a.v_proj.weight, a.v_proj.bias, a.out_proj.weight,
                a.out_proj.bias)

    def _mlp_params(self):
        m, ln = self.mlp, self.layer_norm2
        return ln.weight, ln.bias, m.fc1.weight, m.fc1.bias, m.fc2.weight, m.fc2.bias

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        parts = None
        # int8 (W8A8) projections never take K5a-c (siglip.py:52-84); the
        # quantizer gives every projection its weight_scale at once. Nor does
        # a rank's part of a tensor-parallel layer: the kernels hold a whole
        # layer and have no backward.
        if (self.tp is None and self.mlp.fc1.weight_scale is None
                and L._fused_layer_enabled(x, c.hidden_size, c.intermediate_size,
                                           c.num_attention_heads)):
            parts = L._FUSED_PARTS
        kw = dict(eps=c.layer_norm_eps)
        if parts == "both":
            return FL.fused_vit_layer(x, *self._attn_params(), *self._mlp_params(),
                                      heads=c.num_attention_heads, **kw)
        if parts == "attn":
            x = FL.fused_vit_attention_block(x, *self._attn_params(),
                                             heads=c.num_attention_heads, **kw)
        else:
            x = x + self.self_attn(L.tp_input(self.layer_norm1(x), self.tp))
        if parts == "mlp":
            return FL.fused_mlp_block(x, *self._mlp_params(), **kw)
        return x + self.mlp(L.tp_input(self.layer_norm2(x), self.tp))


class SiglipVisionTower(nn.Module):
    """pixel_values ``[B, H, W, 3]`` (NHWC, normalized) -> ``[B, P, hidden]``.

    ``pos_index``: the row of the position table for each patch. SigLIP in
    ColPali uses them in order (empty); Idefics3 passes its bucketized
    fractional coordinates (siglip.py:124-155). ``n_layers`` (default all)
    and ``post_layernorm=False`` make the feature tower LLaVA-Next reads
    (``models/granite.SiglipFeatureTower``)."""

    def __init__(self, cfg: SiglipVisionConfig, *, device, dtype, pos_index: tuple = (),
                 n_layers: Optional[int] = None, post_layernorm: bool = True):
        super().__init__()
        self.cfg = cfg
        self.register_buffer("pos_index", torch.tensor(pos_index, dtype=torch.long,
                                                       device=device) if pos_index else None,
                             persistent=False)
        kw = dict(device=device, dtype=dtype)
        p = cfg.patch_size
        # torch conv layout [cout, cin, kh, kw]; the flax kernel is [kh, kw, cin, cout]
        self.patch_embedding = nn.Module()
        self.patch_embedding.weight = L.empty_param(cfg.hidden_size, 3, p, p, **kw)
        self.patch_embedding.bias = L.empty_param(cfg.hidden_size, **kw)
        self.position_embedding = L.empty_param(cfg.num_patches, cfg.hidden_size, **kw)
        n = cfg.num_hidden_layers if n_layers is None else n_layers
        self.layers = nn.ModuleList(SiglipEncoderLayer(cfg, **kw) for _ in range(n))
        self.post_layernorm = (L.LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, **kw)
                               if post_layernorm else None)

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        pe = self.patch_embedding
        x = F.conv2d(pixel_values.permute(0, 3, 1, 2), pe.weight.to(pixel_values.dtype),
                     pe.bias.to(pixel_values.dtype), stride=c.patch_size)
        x = x.flatten(2).transpose(1, 2)  # [B, P, hidden], row-major patch order
        pos = self.position_embedding
        if self.pos_index is not None:
            pos = pos[self.pos_index]
        x = x + pos.to(x.dtype)[None]
        for layer in self.layers:
            x = layer(x)
        return x if self.post_layernorm is None else self.post_layernorm(x)
