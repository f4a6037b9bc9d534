"""SigLIP vision tower (counterpart of ``multimodal_colpali_tpu/models/siglip.py``).

NHWC pixels in, ``[B, num_patches, hidden]`` out: one strided patch
convolution, a learned position table, pre-LN encoder layers with
``gelu(approximate="tanh")`` MLPs, and a final LayerNorm. Self-attention has
no mask, so on a CUDA tensor it runs K2 (``ops/attention.py``).

The JAX package's fused-layer path (K5) is taken only for SigLIP-768
(``layer_plan``, fused_layer.py:69); So400m runs these unfused layers.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from multimodal_colpali_tpu_torch.models import layers as L
from multimodal_colpali_tpu_torch.models.configs import SiglipVisionConfig


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
        h = cfg.hidden_size
        self.q_proj = L.Dense(h, h, device=device, dtype=dtype)
        self.k_proj = L.Dense(h, h, device=device, dtype=dtype)
        self.v_proj = L.Dense(h, h, device=device, dtype=dtype)
        self.out_proj = L.Dense(h, h, device=device, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        head_dim = c.hidden_size // c.num_attention_heads
        b, s, _ = x.shape
        shape = (b, s, c.num_attention_heads, head_dim)
        q = self.q_proj(x).view(shape)
        k = self.k_proj(x).view(shape)
        v = self.v_proj(x).view(shape)
        out = L.attention(q, k, v, mask=None, scale=head_dim ** -0.5)
        return self.out_proj(out.reshape(b, s, c.hidden_size))


class SiglipEncoderLayer(nn.Module):
    def __init__(self, cfg: SiglipVisionConfig, *, device, dtype):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.layer_norm1 = L.LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, **kw)
        self.self_attn = SiglipAttention(cfg, **kw)
        self.layer_norm2 = L.LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, **kw)
        self.mlp = SiglipMLP(cfg, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.self_attn(self.layer_norm1(x))
        return x + self.mlp(self.layer_norm2(x))


class SiglipVisionTower(nn.Module):
    """pixel_values ``[B, H, W, 3]`` (NHWC, normalized) -> ``[B, P, hidden]``."""

    def __init__(self, cfg: SiglipVisionConfig, *, device, dtype):
        super().__init__()
        self.cfg = cfg
        kw = dict(device=device, dtype=dtype)
        p = cfg.patch_size
        # torch conv layout [cout, cin, kh, kw]; the flax kernel is [kh, kw, cin, cout]
        self.patch_embedding = nn.Module()
        self.patch_embedding.weight = L.empty_param(cfg.hidden_size, 3, p, p, **kw)
        self.patch_embedding.bias = L.empty_param(cfg.hidden_size, **kw)
        self.position_embedding = L.empty_param(cfg.num_patches, cfg.hidden_size, **kw)
        self.layers = nn.ModuleList(
            SiglipEncoderLayer(cfg, **kw) for _ in range(cfg.num_hidden_layers))
        self.post_layernorm = L.LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, **kw)

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        pe = self.patch_embedding
        x = F.conv2d(pixel_values.permute(0, 3, 1, 2), pe.weight.to(pixel_values.dtype),
                     pe.bias.to(pixel_values.dtype), stride=c.patch_size)
        x = x.flatten(2).transpose(1, 2)  # [B, P, hidden], row-major patch order
        x = x + self.position_embedding.to(x.dtype)[None]
        for layer in self.layers:
            x = layer(x)
        return self.post_layernorm(x)
