"""CLIP vision tower, LLaVA-NeXT's image encoder (counterpart of
``multimodal_colpali_tpu/models/clip.py``).

NHWC pixels in, the hidden states of the ``feature_layer`` encoder layer out
with the CLS row dropped (LLaVA-NeXT's ``vision_feature_layer=-2`` and its
"default" strategy): a bias-free patch convolution, a learned CLS row, learned
positions over [CLS + patches], ``pre_layrnorm``, then pre-LN encoder layers.
A layer is SigLIP's attention block (biased q/k/v/out projections, no mask, so
K2 on a CUDA tensor) and an MLP with quick-GELU. The JAX layer is not fused,
and K5's GELU is the tanh one, so no layer takes K5. The encoder stops at the
feature layer: 23 of CLIP-L's 24 layers exist and run.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from multimodal_colpali_tpu_torch.models import layers as L
from multimodal_colpali_tpu_torch.models.configs import ClipVisionConfig
from multimodal_colpali_tpu_torch.models.siglip import SiglipAttention


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


class ClipMLP(nn.Module):
    def __init__(self, cfg: ClipVisionConfig, *, device, dtype):
        super().__init__()
        self.fc1 = L.Dense(cfg.hidden_size, cfg.intermediate_size, device=device, dtype=dtype)
        self.fc2 = L.Dense(cfg.intermediate_size, cfg.hidden_size, device=device, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(quick_gelu(self.fc1(x)))


class ClipEncoderLayer(nn.Module):
    def __init__(self, cfg: ClipVisionConfig, *, device, dtype):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.layer_norm1 = L.LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, **kw)
        self.self_attn = SiglipAttention(cfg, **kw)
        self.layer_norm2 = L.LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, **kw)
        self.mlp = ClipMLP(cfg, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.self_attn(self.layer_norm1(x))
        return x + self.mlp(self.layer_norm2(x))


class ClipFeatureTower(nn.Module):
    """pixel_values ``[B, H, W, 3]`` (normalized NHWC) -> ``[B, P, hidden]``,
    the ``feature_layer``'s hidden states without the CLS row."""

    def __init__(self, cfg: ClipVisionConfig, feature_layer: int = -2, *, device, dtype):
        super().__init__()
        self.cfg = cfg
        kw = dict(device=device, dtype=dtype)
        p = cfg.patch_size
        # torch conv layout [cout, cin, kh, kw]; the flax kernel is [kh, kw, cin, cout]
        self.patch_embedding = nn.Module()
        self.patch_embedding.weight = L.empty_param(cfg.hidden_size, 3, p, p, **kw)
        self.class_embedding = L.empty_param(cfg.hidden_size, **kw)
        self.position_embedding = L.empty_param(cfg.num_positions, cfg.hidden_size, **kw)
        self.pre_layrnorm = L.LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, **kw)
        n = cfg.num_hidden_layers
        stop = min(n + 1 + feature_layer if feature_layer < 0 else feature_layer, n)
        self.layers = nn.ModuleList(ClipEncoderLayer(cfg, **kw) for _ in range(stop))

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        dt = pixel_values.dtype
        x = F.conv2d(pixel_values.permute(0, 3, 1, 2), self.patch_embedding.weight.to(dt),
                     stride=c.patch_size)
        x = x.flatten(2).transpose(1, 2)               # [B, P, hidden], row-major patches
        b = x.shape[0]
        cls = self.class_embedding.to(dt)[None, None].expand(b, 1, c.hidden_size)
        x = torch.cat([cls, x], dim=1) + self.position_embedding.to(dt)[None]
        x = self.pre_layrnorm(x)
        for layer in self.layers:
            x = layer(x)
        return x[:, 1:]
