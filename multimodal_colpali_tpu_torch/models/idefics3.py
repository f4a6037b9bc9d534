"""ColIdefics3 / ColSmol retrieval model (counterpart of ``multimodal_colpali_tpu/models/idefics3.py``).

SmolVLM backbone + 128-d head:

- vision: the SigLIP tower with Idefics3's bucketized position ids
  (:func:`idefics3_position_index`); at SigLIP-768 its layers take the fused
  path (K5a on a CUDA device, ``models/siglip.py``);
- connector: :func:`pixel_shuffle` by ``scale_factor`` and a bias-less
  ``modality_projection`` into the LM width;
- language model: a Llama decoder (GQA without biases, plain RMSNorm,
  SiLU-gated MLP, 1-D rotary) under ``causal & attention_mask``, an explicit
  mask, so its attention takes the plain einsum path, as in the JAX package;
- head: ``embedding_proj_layer``, L2-normalized and masked, in float32.

A batch without pixels runs the language model in float32, as the JAX
module does (its embeddings take the pixels' dtype, else float32;
idefics3.py:201-204). With image splitting (``tiles``) the pixels are
``[B, T + 1, S, S, 3]``, the tiles row-major and the global view last; the
tower and the connector run over every sub-image and their features fill
the prompt's image tokens in that order (idefics3.py:180-214).

Parameter names follow the flax tree (``vision_model``, ``modality_projection``,
``layers.<i>``, ``norm``, ``embedding_proj_layer``, ``embed_tokens``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from multimodal_colpali_tpu_torch._device import resolve_device
from multimodal_colpali_tpu_torch.models import layers as L
from multimodal_colpali_tpu_torch.models.configs import ColIdefics3ModelConfig, LlamaTextConfig
from multimodal_colpali_tpu_torch.models.siglip import SiglipVisionTower


def idefics3_position_index(num_patches_per_side: int) -> tuple:
    """Bucketized fractional-coordinate position ids of a full square image
    (idefics3.py:117-128): per axis the buckets are not sequential, e.g.
    ``[0, 0, 1, 2]`` for a 4-wide grid."""
    n = num_patches_per_side
    frac = np.arange(n) / n * (1 - 1e-6)
    boundaries = np.arange(1, n) / n
    buckets = np.searchsorted(boundaries, frac, side="right")
    pos = (buckets[:, None] * n + buckets[None, :]).reshape(-1)
    return tuple(int(p) for p in pos)


def pixel_shuffle(x: torch.Tensor, scale: int) -> torch.Tensor:
    """``[B, S, D] -> [B, S / scale^2, D * scale^2]``, the Idefics3 connector's
    space-to-depth in its fixed transpose order (idefics3.py:131-139)."""
    b, seq, d = x.shape
    h = w = int(seq ** 0.5)
    x = x.reshape(b, h, w // scale, d * scale).transpose(1, 2)
    x = x.reshape(b, w // scale, h // scale, d * scale * scale).transpose(1, 2)
    return x.reshape(b, seq // (scale * scale), d * scale * scale)


class LlamaAttention(nn.Module):
    def __init__(self, cfg: LlamaTextConfig, *, device, dtype):
        super().__init__()
        self.cfg = cfg
        kw = dict(bias=False, device=device, dtype=dtype)
        hd = cfg.head_dim
        self.q_proj = L.Dense(cfg.hidden_size, cfg.num_attention_heads * hd, **kw)
        self.k_proj = L.Dense(cfg.hidden_size, cfg.num_key_value_heads * hd, **kw)
        self.v_proj = L.Dense(cfg.hidden_size, cfg.num_key_value_heads * hd, **kw)
        self.o_proj = L.Dense(cfg.num_attention_heads * hd, cfg.hidden_size, **kw)
        self.scale = hd ** -0.5

    def forward(self, x: torch.Tensor, positions: torch.Tensor,
                mask: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        b, s, _ = x.shape
        q = self.q_proj(x).view(b, s, c.num_attention_heads, c.head_dim)
        k = self.k_proj(x).view(b, s, c.num_key_value_heads, c.head_dim)
        v = self.v_proj(x).view(b, s, c.num_key_value_heads, c.head_dim)
        q = L.rope(q, positions, theta=c.rope_theta)
        k = L.rope(k, positions, theta=c.rope_theta)
        out = L.attention(q, k, v, mask=mask, scale=self.scale)
        return self.o_proj(out.reshape(b, s, c.num_attention_heads * c.head_dim))


class LlamaDecoderLayer(nn.Module):
    attention_cls = LlamaAttention

    def __init__(self, cfg: LlamaTextConfig, *, device, dtype):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.input_layernorm = L.LlamaRMSNorm(cfg.hidden_size, cfg.rms_norm_eps, **kw)
        self.self_attn = self.attention_cls(cfg, **kw)
        self.post_attention_layernorm = L.LlamaRMSNorm(cfg.hidden_size, cfg.rms_norm_eps, **kw)
        nb = dict(bias=False, **kw)
        self.gate_proj = L.Dense(cfg.hidden_size, cfg.intermediate_size, **nb)
        self.up_proj = L.Dense(cfg.hidden_size, cfg.intermediate_size, **nb)
        self.down_proj = L.Dense(cfg.intermediate_size, cfg.hidden_size, **nb)

    def forward(self, x: torch.Tensor, positions: torch.Tensor,
                mask: torch.Tensor) -> torch.Tensor:
        x = x + self.self_attn(self.input_layernorm(x), positions, mask)
        y = self.post_attention_layernorm(x)
        return x + self.down_proj(F.silu(self.gate_proj(y)) * self.up_proj(y))


class ColIdefics3Model(nn.Module):
    def __init__(self, cfg: ColIdefics3ModelConfig, *, device="cuda", dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        device = resolve_device(device)
        t = cfg.text
        kw = dict(device=device, dtype=dtype)
        self.embed_tokens = L.empty_param(t.vocab_size, t.hidden_size, **kw)
        nps = cfg.vision.image_size // cfg.vision.patch_size
        self.vision_model = SiglipVisionTower(cfg.vision, pos_index=idefics3_position_index(nps),
                                              **kw)
        self.modality_projection = L.Dense(cfg.vision.hidden_size * cfg.scale_factor ** 2,
                                           t.hidden_size, bias=False, **kw)
        self.layers = nn.ModuleList(LlamaDecoderLayer(t, **kw)
                                    for _ in range(t.num_hidden_layers))
        self.norm = L.LlamaRMSNorm(t.hidden_size, t.rms_norm_eps, **kw)
        self.embedding_proj_layer = L.Dense(t.hidden_size, cfg.embedding_dim, **kw)

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                pixel_values: Optional[torch.Tensor] = None,
                tiles: Optional[tuple] = None) -> torch.Tensor:
        """input_ids/attention_mask ``[B, S]``; pixel_values ``[B, H, W, 3]``
        (or ``[B, T + 1, S, S, 3]`` with ``tiles``) NHWC normalized ->
        ``[B, S, embedding_dim]`` float32."""
        c = self.cfg
        is_img = input_ids == c.image_token_id
        dtype = pixel_values.dtype if pixel_values is not None else torch.float32
        embeds = F.embedding(torch.where(is_img, torch.zeros_like(input_ids), input_ids),
                             self.embed_tokens).to(dtype)
        if pixel_values is not None:
            b = pixel_values.shape[0]
            pix = pixel_values if tiles is None else pixel_values.flatten(0, 1)
            feats = pixel_shuffle(self.vision_model(pix), c.scale_factor)
            feats = self.modality_projection(feats)
            if tiles is not None:  # [B * N, tok, D] -> [B, N * tok, D], sub-images in order
                feats = feats.reshape(b, -1, feats.shape[-1])
            # image slot s takes feature cumsum(is_img)[s] - 1 (idefics3.py:223-226)
            img_pos = (torch.cumsum(is_img.long(), dim=1) - 1).clamp(0, feats.shape[1] - 1)
            gathered = torch.gather(feats, 1, img_pos[..., None].expand(-1, -1, feats.shape[-1]))
            embeds = torch.where(is_img[..., None], gathered, embeds)

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
