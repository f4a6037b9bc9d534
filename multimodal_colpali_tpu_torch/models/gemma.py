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
from multimodal_colpali_tpu_torch.parallel.mesh import tp_head_plan


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
        # this rank's query and KV heads on a tensor-parallel mesh
        self.heads, self.kv_heads = cfg.num_attention_heads, cfg.num_key_value_heads
        self.q_proj = L.Dense(cfg.hidden_size, cfg.num_attention_heads * hd, **kw)
        self.k_proj = L.Dense(cfg.hidden_size, cfg.num_key_value_heads * hd, **kw)
        self.v_proj = L.Dense(cfg.hidden_size, cfg.num_key_value_heads * hd, **kw)
        self.o_proj = L.Dense(cfg.num_attention_heads * hd, cfg.hidden_size, **kw)

    def forward(self, x: torch.Tensor, positions: torch.Tensor,
                mask: Optional[torch.Tensor]) -> torch.Tensor:
        c = self.cfg
        b, s, _ = x.shape
        q = self.q_proj(x).view(b, s, self.heads, c.head_dim)
        k = self.k_proj(x).view(b, s, self.kv_heads, c.head_dim)
        v = self.v_proj(x).view(b, s, self.kv_heads, c.head_dim)
        q = L.rope(q, positions, theta=c.rope_theta)
        k = L.rope(k, positions, theta=c.rope_theta)
        out = L.attention(q, k, v, mask=mask, scale=c.head_dim ** -0.5)
        return self.o_proj(out.reshape(b, s, self.heads * c.head_dim))


class GemmaDecoderLayer(nn.Module):
    def __init__(self, cfg: GemmaTextConfig, *, device, dtype):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.input_layernorm = L.RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, **kw)
        self.self_attn = GemmaAttention(cfg, **kw)
        self.post_attention_layernorm = L.RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, **kw)
        self.mlp = GemmaMLP(cfg, **kw)
        self.tp = None       # (mesh, axis) once :meth:`shard_` made it a rank's part

    def shard_(self, mesh, axis: str = "model") -> None:
        """Make this layer one rank's part of a tensor-parallel layer over
        ``axis`` (``parallel.tp_head_plan``): whole query heads (``q_proj``
        columns, ``o_proj`` rows), a slice of the MLP's hidden units
        (``gate_proj`` / ``up_proj`` columns, ``down_proj`` rows). KV heads
        split where their count divides the axis; a single KV head (Gemma-2B's
        MQA) stays whole on every rank, where every query head reads it, and
        the trainer sums its gradients over the axis."""
        a, m, tp = self.self_attn, self.mlp, mesh.size(axis)
        _, nq, _, nkv = tp_head_plan(a.cfg, tp, mesh.index(axis))
        kv = "col" if nkv * tp == a.kv_heads else "sum"
        if kv == "sum" and a.kv_heads != 1:
            raise ValueError(f"{a.kv_heads} KV heads over {tp} model ranks: training splits the "
                             f"KV heads evenly or keeps a single one whole")
        for proj, split in ((a.q_proj, "col"), (a.k_proj, kv), (a.v_proj, kv),
                            (a.o_proj, "row"), (m.gate_proj, "col"), (m.up_proj, "col"),
                            (m.down_proj, "row")):
            proj.shard_(split, mesh, axis)
        a.heads, a.kv_heads = nq, nkv
        self.tp = (mesh, axis)

    def forward(self, x, positions, mask):
        x = x + self.self_attn(L.tp_input(self.input_layernorm(x), self.tp), positions, mask)
        return x + self.mlp(L.tp_input(self.post_attention_layernorm(x), self.tp))


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
