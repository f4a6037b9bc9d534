"""Gemma text tower (counterpart of ``multimodal_colpali_tpu/models/gemma.py``).

For retrieval the whole input is prefix, so attention is bidirectional over
the valid tokens: the ``attention_mask`` becomes an explicit ``[B, 1, 1, T]``
mask (gemma.py:79-87), which keeps Gemma on the plain einsum path, as in the
JAX package. MQA: 8 query heads share 1 key/value head of width 256.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from multimodal_colpali_tpu_torch.models import layers as L
from multimodal_colpali_tpu_torch.models.configs import GemmaTextConfig


class GemmaMLP(nn.Module):
    def __init__(self, cfg: GemmaTextConfig, *, device, dtype):
        super().__init__()
        kw = dict(bias=False, device=device, dtype=dtype)
        self.gate_proj = L.Dense(cfg.hidden_size, cfg.intermediate_size, **kw)
        self.up_proj = L.Dense(cfg.hidden_size, cfg.intermediate_size, **kw)
        self.down_proj = L.Dense(cfg.intermediate_size, cfg.hidden_size, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        act = F.gelu(self.gate_proj(x), approximate="tanh")
        return self.down_proj(act * self.up_proj(x))


class GemmaAttention(nn.Module):
    def __init__(self, cfg: GemmaTextConfig, *, device, dtype):
        super().__init__()
        self.cfg = cfg
        kw = dict(bias=False, device=device, dtype=dtype)
        hd = cfg.head_dim
        self.q_proj = L.Dense(cfg.hidden_size, cfg.num_attention_heads * hd, **kw)
        self.k_proj = L.Dense(cfg.hidden_size, cfg.num_key_value_heads * hd, **kw)
        self.v_proj = L.Dense(cfg.hidden_size, cfg.num_key_value_heads * hd, **kw)
        self.o_proj = L.Dense(cfg.num_attention_heads * hd, cfg.hidden_size, **kw)

    def forward(self, x: torch.Tensor, positions: torch.Tensor,
                mask: Optional[torch.Tensor]) -> torch.Tensor:
        c = self.cfg
        b, s, _ = x.shape
        q = self.q_proj(x).view(b, s, c.num_attention_heads, c.head_dim)
        k = self.k_proj(x).view(b, s, c.num_key_value_heads, c.head_dim)
        v = self.v_proj(x).view(b, s, c.num_key_value_heads, c.head_dim)
        q = L.rope(q, positions, theta=c.rope_theta)
        k = L.rope(k, positions, theta=c.rope_theta)
        out = L.attention(q, k, v, mask=mask, scale=c.head_dim ** -0.5)
        return self.o_proj(out.reshape(b, s, c.num_attention_heads * c.head_dim))


class GemmaDecoderLayer(nn.Module):
    def __init__(self, cfg: GemmaTextConfig, *, device, dtype):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.input_layernorm = L.RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, **kw)
        self.self_attn = GemmaAttention(cfg, **kw)
        self.post_attention_layernorm = L.RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, **kw)
        self.mlp = GemmaMLP(cfg, **kw)

    def forward(self, x, positions, mask):
        x = x + self.self_attn(self.input_layernorm(x), positions, mask)
        return x + self.mlp(self.post_attention_layernorm(x))


class GemmaModel(nn.Module):
    """inputs_embeds ``[B, S, hidden]`` (already scaled and merged with the
    image features) -> last hidden states ``[B, S, hidden]``."""

    def __init__(self, cfg: GemmaTextConfig, *, device, dtype):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.layers = nn.ModuleList(
            GemmaDecoderLayer(cfg, **kw) for _ in range(cfg.num_hidden_layers))
        self.norm = L.RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, **kw)

    def forward(self, inputs_embeds: torch.Tensor, positions: torch.Tensor,
                attention_mask: Optional[torch.Tensor]) -> torch.Tensor:
        x = inputs_embeds
        mask = None
        if attention_mask is not None:
            # a position may attend to every valid (non-padding) position
            mask = attention_mask[:, None, None, :].bool()
        for layer in self.layers:
            x = layer(x, positions, mask)
        return self.norm(x)


class GemmaEmbedder(nn.Module):
    """Token table ``[vocab, hidden]``; the caller applies Gemma's sqrt(hidden) scale."""

    def __init__(self, cfg: GemmaTextConfig, *, device, dtype):
        super().__init__()
        self.embed_tokens = L.empty_param(cfg.vocab_size, cfg.hidden_size,
                                          device=device, dtype=dtype)

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        return F.embedding(input_ids, self.embed_tokens)
