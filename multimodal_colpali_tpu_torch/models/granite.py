"""ColGranite retrieval model (counterpart of ``multimodal_colpali_tpu/models/granite.py``).

granite-vision-3.3-2b-embedding, the reference's fifth retriever: a
LLaVA-Next model with a Granite LM and a 128-d head.

- vision: :class:`SiglipFeatureTower`, the SigLIP encoder up to
  ``vision_feature_layer`` with no post-LayerNorm. Its self-attention has
  no mask, so on a CUDA tensor it is K2 (``ops/attention.py``); the
  So400m layer shape is refused by the fused-layer plan (K5a-c);
- projector: ``projector_linear_1`` -> exact GELU -> ``projector_linear_2``;
- packing (LLaVA-Next ``pack_image_features``): the base image's g x g
  tokens, then the tiles' spatial grid with an ``image_newline`` token
  closing each row. ``tiles=None`` is the square layout, where the one tile
  is the base image itself; ``tiles=(ty, tx, dy, dx)`` is anyres, the
  pixels ``[B, 1 + ty * tx, S, S, 3]`` (base first, tiles row-major) and
  ``dy`` / ``dx`` the feature rows / columns HF's ``unpad_image`` crops
  from each side;
- language model: a Llama decoder with Granite's multipliers (attention
  scale ``attention_multiplier``, residual branches times
  ``residual_multiplier``, embeddings times ``embedding_multiplier`` after
  the image features are merged) under ``causal & attention_mask``, an
  explicit mask, so its attention is the plain float32 einsum, as in JAX;
- head: ``embedding_proj_layer``, L2-normalized and masked, in float32.

Parameter names follow the flax tree (``vision_tower``,
``projector_linear_1``, ``image_newline``, ``layers.<i>``, ``norm``,
``embedding_proj_layer``, ``embed_tokens``).
"""

from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from multimodal_colpali_tpu_torch._device import resolve_device
from multimodal_colpali_tpu_torch.models import layers as L
from multimodal_colpali_tpu_torch.models.configs import (
    ColGraniteModelConfig, GraniteTextConfig, SiglipVisionConfig)
from multimodal_colpali_tpu_torch.models.idefics3 import LlamaAttention, LlamaDecoderLayer
from multimodal_colpali_tpu_torch.models.siglip import SiglipVisionTower


@functools.lru_cache(maxsize=None)
def scalar_in(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype``, as JAX's weak-typed Python scalar meets
    an array of that dtype; a Python float, so multiplying by it copies
    nothing to the card. Cached: a layer call builds no tensor."""
    return float(torch.tensor(value, dtype=dtype))


class SiglipFeatureTower(SiglipVisionTower):
    """The SigLIP encoder's ``feature_layer`` hidden states, before the
    post-LayerNorm, as LLaVA-Next reads them (granite.py:106-130): only the
    layers up to it exist."""

    def __init__(self, cfg: SiglipVisionConfig, n_layers: int, *, device, dtype):
        super().__init__(cfg, device=device, dtype=dtype, n_layers=n_layers,
                         post_layernorm=False)


class GraniteAttention(LlamaAttention):
    """Llama attention scaled by ``attention_multiplier`` (granite.py:150-168)."""

    def __init__(self, cfg: GraniteTextConfig, *, device, dtype):
        super().__init__(cfg, device=device, dtype=dtype)
        self.scale = cfg.attention_multiplier


class GraniteDecoderLayer(LlamaDecoderLayer):
    """Both residual branches times ``residual_multiplier`` (granite.py:133-147),
    the multiplier rounded to the activations' dtype (:func:`scalar_in`)."""

    attention_cls = GraniteAttention

    def __init__(self, cfg: GraniteTextConfig, *, device, dtype):
        super().__init__(cfg, device=device, dtype=dtype)
        self.residual_multiplier = cfg.residual_multiplier

    def forward(self, x: torch.Tensor, positions: torch.Tensor,
                mask: torch.Tensor) -> torch.Tensor:
        r = scalar_in(self.residual_multiplier, x.dtype)
        x = x + self.self_attn(self.input_layernorm(x), positions, mask) * r
        y = self.post_attention_layernorm(x)
        return x + self.down_proj(F.silu(self.gate_proj(y)) * self.up_proj(y)) * r


class ColGraniteModel(nn.Module):
    def __init__(self, cfg: ColGraniteModelConfig, *, device="cuda", dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        device = resolve_device(device)
        t, v = cfg.text, cfg.vision
        kw = dict(device=device, dtype=dtype)
        self.embed_tokens = L.empty_param(t.vocab_size, t.hidden_size, **kw)
        self.vision_tower = SiglipFeatureTower(v, cfg.feature_layers, **kw)
        self.projector_linear_1 = L.Dense(v.hidden_size, t.hidden_size, **kw)
        self.projector_linear_2 = L.Dense(t.hidden_size, t.hidden_size, **kw)
        self.image_newline = L.empty_param(t.hidden_size, **kw)
        self.layers = nn.ModuleList(GraniteDecoderLayer(t, **kw)
                                    for _ in range(t.num_hidden_layers))
        self.norm = L.LlamaRMSNorm(t.hidden_size, t.rms_norm_eps, **kw)
        self.embedding_proj_layer = L.Dense(t.hidden_size, cfg.embedding_dim, **kw)

    def image_features(self, pixel_values: torch.Tensor,
                       tiles: Optional[tuple] = None) -> torch.Tensor:
        """Pixels -> the packed image tokens ``[B, n_image_tokens_for(tiles),
        hidden]`` (granite.py:205-243)."""
        c = self.cfg
        g, d = c.grid, c.text.hidden_size
        b = pixel_values.shape[0]
        pix = pixel_values if tiles is None else pixel_values.flatten(0, 1)
        proj = self.projector_linear_2(
            F.gelu(self.projector_linear_1(self.vision_tower(pix))))
        newline = self.image_newline.to(proj.dtype)
        if tiles is None:
            rows, cols = g, g
            base, sp = proj, proj.reshape(b, g, g, d)
        else:
            ty, tx, dy, dx = (tuple(tiles) + (0, 0))[:4]
            proj = proj.reshape(b, 1 + ty * tx, g * g, d)
            base = proj[:, 0]
            sp = proj[:, 1:].reshape(b, ty, tx, g, g, d).permute(0, 1, 3, 2, 4, 5)
            sp = sp.reshape(b, ty * g, tx * g, d)
            rows, cols = ty * g - 2 * dy, tx * g - 2 * dx
            sp = sp[:, dy: dy + rows, dx: dx + cols]
        nl = newline.expand(b, rows, 1, d)
        sp = torch.cat([sp, nl], dim=2).reshape(b, rows * (cols + 1), d)
        return torch.cat([base, sp], dim=1)

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                pixel_values: Optional[torch.Tensor] = None,
                tiles: Optional[tuple] = None) -> torch.Tensor:
        """input_ids/attention_mask ``[B, S]``; pixel_values ``[B, H, W, 3]``
        (square layout) or ``[B, 1 + T, H, W, 3]`` (``tiles``), NHWC
        normalized -> ``[B, S, embedding_dim]`` float32."""
        c = self.cfg
        is_img = input_ids == c.image_token_id
        dtype = pixel_values.dtype if pixel_values is not None else torch.float32
        embeds = F.embedding(torch.where(is_img, torch.zeros_like(input_ids), input_ids),
                             self.embed_tokens).to(dtype)
        if pixel_values is not None:
            feats = self.image_features(pixel_values, tiles)
            img_pos = (torch.cumsum(is_img.long(), dim=1) - 1).clamp(0, feats.shape[1] - 1)
            gathered = torch.gather(feats, 1, img_pos[..., None].expand(-1, -1, feats.shape[-1]))
            embeds = torch.where(is_img[..., None], gathered, embeds)
        embeds = embeds * scalar_in(c.text.embedding_multiplier, embeds.dtype)

        positions = torch.cumsum(attention_mask, dim=1) - 1  # 0-indexed
        s = input_ids.shape[1]
        causal = torch.ones((s, s), dtype=torch.bool, device=input_ids.device).tril()
        mask = causal[None, None] & attention_mask[:, None, None, :].bool()
        x = embeds
        for layer in self.layers:
            x = layer(x, positions, mask)
        proj = self.embedding_proj_layer(self.norm(x)).float()
        proj = proj / torch.linalg.vector_norm(proj, dim=-1, keepdim=True).clamp_min(1e-12)
        return proj * attention_mask[..., None].float()
