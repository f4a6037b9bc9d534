"""BERT encoder for bge-base-en-v1.5 dense text embeddings
(counterpart of ``multimodal_colpali_tpu/models/bert.py``).

bge pooling: the CLS row of the last layer, in float32, L2-normalized.
Module and parameter names follow the flax tree, so
``models/convert.params_from_flax`` maps one onto the other by name.

The rounding points are JAX's:

- every projection accumulates in float32 and adds its bias in float32
  before the one cast to the activation dtype (layers.py:29-36), which
  ``F.linear`` on bf16 (the port's ``layers.dense``) does not promise
  (:func:`dense_f32`);
- LayerNorm runs in float32 (layers.py:67-80);
- attention always gets the key-padding mask, so it takes the plain einsum
  path of ``layers.attention`` (layers.py:210-231), never K2, exactly as
  JAX's call takes its einsum branch.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from multimodal_colpali_tpu_torch._device import resolve_device
from multimodal_colpali_tpu_torch.models import layers as L
from multimodal_colpali_tpu_torch.models.configs import BertConfig
from multimodal_colpali_tpu_torch.ops.quant import bf16_matmul_f32


def dense_f32(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """``x @ weight.T + bias`` rounded once to x's dtype: the product
    accumulated and the bias added in float32 (layers.py:29-36). A bf16
    ``x`` multiplies bf16 operands into float32 (``ops/quant.bf16_matmul_f32``);
    any other dtype is widened to float32, which gives the same products."""
    x2 = x.reshape(-1, x.shape[-1])
    if x.dtype == torch.bfloat16:
        y = bf16_matmul_f32(x2, weight.to(torch.bfloat16))
    else:
        y = x2.float() @ weight.float().T
    y = (y + bias.float()).to(x.dtype)
    return y.reshape(*x.shape[:-1], weight.shape[0])


class BertDense(L.Dense):
    """A projection with JAX's rounding (:func:`dense_f32`)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return dense_f32(x, self.weight, self.bias)


class BertSelfAttention(nn.Module):
    def __init__(self, cfg: BertConfig, *, device, dtype):
        super().__init__()
        self.cfg = cfg
        h = cfg.hidden_size
        self.query = BertDense(h, h, device=device, dtype=dtype)
        self.key = BertDense(h, h, device=device, dtype=dtype)
        self.value = BertDense(h, h, device=device, dtype=dtype)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        b, s, _ = x.shape
        heads = c.num_attention_heads
        head_dim = c.hidden_size // heads
        q = self.query(x).reshape(b, s, heads, head_dim)
        k = self.key(x).reshape(b, s, heads, head_dim)
        v = self.value(x).reshape(b, s, heads, head_dim)
        out = L.attention(q, k, v, mask=mask, scale=head_dim ** -0.5)
        return out.reshape(b, s, c.hidden_size)


class BertLayer(nn.Module):
    """Post-LN layer: attention, residual, LN; exact-gelu MLP, residual, LN
    (bert.py:38-50)."""

    def __init__(self, cfg: BertConfig, *, device, dtype):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        h, inter, eps = cfg.hidden_size, cfg.intermediate_size, cfg.layer_norm_eps
        self.attention = BertSelfAttention(cfg, **kw)
        self.attention_output = BertDense(h, h, **kw)
        self.attention_layernorm = L.LayerNorm(h, eps, **kw)
        self.intermediate = BertDense(h, inter, **kw)
        self.output = BertDense(inter, h, **kw)
        self.output_layernorm = L.LayerNorm(h, eps, **kw)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        attn = self.attention_output(self.attention(x, mask))
        x = self.attention_layernorm(x + attn)
        h = F.gelu(self.intermediate(x), approximate="none")  # BERT's exact gelu
        return self.output_layernorm(x + self.output(h))


class BertEncoder(nn.Module):
    """input_ids / attention_mask ``[B, S]`` -> L2-normalized CLS embedding
    ``[B, hidden]`` in float32 (bert.py:53-78)."""

    def __init__(self, cfg: BertConfig, *, device="cuda", dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        device = resolve_device(device)
        kw = dict(device=device, dtype=dtype)
        h = cfg.hidden_size
        self.word_embeddings = L.empty_param(cfg.vocab_size, h, **kw)
        self.position_embeddings = L.empty_param(cfg.max_position_embeddings, h, **kw)
        self.token_type_embeddings = L.empty_param(cfg.type_vocab_size, h, **kw)
        self.embeddings_layernorm = L.LayerNorm(h, cfg.layer_norm_eps, **kw)
        self.layers = nn.ModuleList(BertLayer(cfg, **kw) for _ in range(cfg.num_hidden_layers))

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                token_type_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        s = input_ids.shape[1]
        # summed in the model dtype in JAX's order: (word + pos) + type
        x = (F.embedding(input_ids, self.word_embeddings)
             + self.position_embeddings[None, :s]
             + F.embedding(token_type_ids, self.token_type_embeddings))
        x = self.embeddings_layernorm(x)
        mask = attention_mask[:, None, None, :].bool()
        for layer in self.layers:
            x = layer(x, mask)
        cls = x[:, 0].float()
        return cls / torch.linalg.vector_norm(cls, dim=-1, keepdim=True).clamp_min(1e-12)
