"""Mllama (Llama-3.2-Vision) configs and vision tower (counterpart of
``multimodal_colpali_tpu/models/mllama.py``).

The tower is HF's ``MllamaVisionModel`` as the JAX package runs it, over
NHWC tile stacks ``[N, T, H, W, 3]`` (``T = max_num_tiles``, every slot run,
padding tiles included):

- a bias-free patch convolution per tile;
- the tanh-gated pre-tile embedding (one vector a tile slot, chosen by the
  aspect-ratio id), a class token per tile, the gated positional embedding
  (``(1 - tanh g) * per-patch + tanh g * per-(tile, patch)``);
- ``layernorm_pre``, then each tile's tokens zero-padded to a multiple of 8;
- 32 local layers (their selected outputs kept as intermediate features),
  ``layernorm_post``, the gated post-tile embedding, 8 tanh-gated global
  layers; every layer pre-LN with erf GELU and bias-free attention;
- output ``[final | intermediates (d-major, layer-minor)]`` without the
  padding rows, ``hidden * (1 + n_intermediates)`` channels.

The attention mask is HF's: only invalid->invalid pairs are blocked, so valid
queries also attend padding rows and masked tiles (mllama.py:326-330). Every
attention of the tower passes that explicit mask, so it is the plain masked
einsum with float32 logits and sums, as in JAX (no K2); from 2,048 tokens on
(the 4-tile tower's 6,432) it runs query block by query block
(:func:`blocked_masked_attention`), the same math per block, so the logits
of a whole image never exist at once. bf16 operands on the card multiply on
the tensor cores with float32 sums and output (``torch.bmm(...,
out_dtype=float32)``); float32 ones, and the CPU, in float32.

``gqa_attention`` is the cross-attention core of ``generation/mllama_mm``:
the einsum of ``layers.attention`` with the query heads of a KV group folded
into the query rows, so a cross pool is never repeated to the query heads.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from multimodal_colpali_tpu_torch.models import layers as L
from multimodal_colpali_tpu_torch.models.configs import LlamaTextConfig
from multimodal_colpali_tpu_torch.ops.attention import NEG

BLOCKED_FROM = 2048     # the tower's query blocking starts here (mllama.py:226)


@dataclasses.dataclass(frozen=True)
class MllamaVisionConfig:
    hidden_size: int = 1280
    intermediate_size: int = 5120
    num_hidden_layers: int = 32          # local (ungated) encoder
    num_global_layers: int = 8           # global (gated) encoder
    attention_heads: int = 16
    image_size: int = 560
    patch_size: int = 14
    max_num_tiles: int = 4
    norm_eps: float = 1e-5
    intermediate_layers_indices: Tuple[int, ...] = (3, 7, 15, 23, 30)
    # len(supported_aspect_ratios) for max_num_tiles = 4 (id 0 is padding)
    max_aspect_ratio_id: int = 8

    @property
    def grid(self) -> int:
        return self.image_size // self.patch_size

    @property
    def num_patches(self) -> int:
        """Tokens a tile, the class token included."""
        return self.grid * self.grid + 1

    @property
    def num_patches_padded(self) -> int:
        return (self.num_patches + 7) // 8 * 8

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.attention_heads

    @property
    def output_dim(self) -> int:
        return self.hidden_size * (1 + len(self.intermediate_layers_indices))

    @property
    def supported_aspect_ratios(self) -> Tuple[Tuple[int, int], ...]:
        """(rows, cols) layouts in HF's order (pairs with rows * cols <=
        max_num_tiles, lexicographic); aspect_ratio_id = index + 1."""
        return tuple((r, c) for r in range(1, self.max_num_tiles + 1)
                     for c in range(1, self.max_num_tiles + 1) if r * c <= self.max_num_tiles)

    def aspect_ratio_id(self, tiles: Tuple[int, int]) -> int:
        ratios = self.supported_aspect_ratios
        if tuple(tiles) not in ratios:
            raise ValueError(f"tile layout {tiles} not in the checkpoint's supported "
                             f"aspect ratios {ratios}")
        return ratios.index(tuple(tiles)) + 1


@dataclasses.dataclass(frozen=True)
class MllamaMMConfig:
    """The whole Llama-3.2-Vision generator. ``text`` describes only the
    self-attention layers (renumbered 0..n-1: a plain Llama);
    ``cross_attention_layers`` keeps the global indices of the interleaved
    stack, as HF's config records them."""

    vision: MllamaVisionConfig = dataclasses.field(default_factory=MllamaVisionConfig)
    text: LlamaTextConfig = dataclasses.field(default_factory=LlamaTextConfig.llama3_8b)
    cross_attention_layers: Tuple[int, ...] = (3, 8, 13, 18, 23, 28, 33, 38)
    image_token_id: int = 128256

    @property
    def total_layers(self) -> int:
        return self.text.num_hidden_layers + len(self.cross_attention_layers)

    @property
    def cross_schedule(self) -> Tuple[Tuple[int, int], ...]:
        """(global index, self layer it precedes) a cross layer: the
        ``interleave`` keys of ``engine.layer_stack``."""
        return tuple((g, g - n) for n, g in enumerate(sorted(self.cross_attention_layers)))

    @classmethod
    def llama32_11b_vision(cls) -> "MllamaMMConfig":
        """meta-llama/Llama-3.2-11B-Vision(-Instruct), the base of the
        reference's AdaptLLM biomed tune: 32 Llama-3.1-8B self layers and 8
        cross layers; ViT-H/14 at 560 px, 4 tiles; llama3 rope scaling."""
        text = dataclasses.replace(LlamaTextConfig.llama3_8b(),
                                   rope_llama3=(8.0, 1.0, 4.0, 8192))
        return cls(text=text)

    @classmethod
    def tiny(cls, vocab_size: int = 64) -> "MllamaMMConfig":
        return cls(
            vision=MllamaVisionConfig(
                hidden_size=32, intermediate_size=64, num_hidden_layers=4,
                num_global_layers=2, attention_heads=2, image_size=28, patch_size=14,
                max_num_tiles=2, intermediate_layers_indices=(0, 2),
                max_aspect_ratio_id=3),            # [[1,1],[1,2],[2,1]]
            text=dataclasses.replace(LlamaTextConfig.tiny_lm(vocab_size=vocab_size),
                                     num_hidden_layers=3, tie_word_embeddings=False),
            cross_attention_layers=(1, 4),          # a 5-layer stack: S C S S C
            image_token_id=vocab_size,              # the embed table has vocab + 8 rows
        )


def blocked_masked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             mask: Optional[torch.Tensor], scale: float,
                             block: int = 512) -> torch.Tensor:
    """Attention under a boolean ``mask [B, 1, L, T]`` (True = attend) one
    block of ``block`` queries at a time (mllama.py:173-206): per block the
    unblocked einsum's math (float32 logits x scale, the mask as -1e30,
    softmax, probabilities rounded to v's dtype, float32 sums), so the ``[L,
    T]`` logits never exist whole. q ``[B, L, H, D]``, k/v ``[B, T, H, D]``."""
    b, l, h, d = q.shape
    t = k.shape[1]
    # bf16 on the card: the products on the tensor cores with float32 sums and
    # output, what the einsum with float32 accumulation computes
    tc = q.is_cuda and q.dtype == k.dtype == v.dtype == torch.bfloat16
    if tc:      # [B * H, T, D], once for every block
        kh = k.permute(0, 2, 1, 3).reshape(b * h, t, d)
        vh = v.permute(0, 2, 1, 3).reshape(b * h, t, d)
    else:
        kf, vf = k.float(), v.float()
    outs = []
    for i in range(0, l, block):
        qb = q[:, i:i + block]
        s = qb.shape[1]
        if tc:
            qh = qb.permute(0, 2, 1, 3).reshape(b * h, s, d)
            logits = torch.bmm(qh, kh.transpose(1, 2), out_dtype=torch.float32).view(b, h, s, t)
        else:
            logits = torch.einsum("bshd,bthd->bhst", qb.float(), kf)
        logits.mul_(scale)
        if mask is not None:      # [B | 1, 1, L | 1, T]
            logits.masked_fill_(~(mask if mask.shape[2] == 1 else mask[:, :, i:i + block]), NEG)
        probs = torch.softmax(logits, dim=-1).to(v.dtype)
        del logits
        if tc:
            out = torch.bmm(probs.view(b * h, s, t), vh, out_dtype=torch.float32)
            out = out.view(b, h, s, d).permute(0, 2, 1, 3)
        else:
            out = torch.einsum("bhst,bthd->bshd", probs.float(), vf)
        outs.append(out.to(q.dtype))
    return torch.cat(outs, dim=1)


def gqa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  mask: Optional[torch.Tensor], scale: float,
                  block: Optional[int] = None) -> torch.Tensor:
    """``layers.attention(q, k, v, mask)`` for grouped-query heads without
    repeating K/V: q ``[B, S, Hq, D]`` over k/v ``[B, T, Hkv, D]``, the ``Hq /
    Hkv`` query heads of a group folded into the query rows, ``mask``
    broadcastable to ``[B, 1, S, T]``. Every logit and weight is the
    unfolded einsum's; ``block`` bounds the query rows (before folding) a
    pass holds."""
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    qg = q.reshape(b, s, hkv, g, d).permute(0, 1, 3, 2, 4).reshape(b, s * g, hkv, d)
    if mask is not None:
        mask = mask.bool()
        if mask.shape[2] != 1:    # a row a query: each query's g folded rows share it
            mask = mask[:, :, :, None, :].expand(-1, -1, -1, g, -1).reshape(
                mask.shape[0], 1, s * g, mask.shape[-1])
    out = blocked_masked_attention(qg, k, v, mask, scale, block=(block or s) * g)
    return out.reshape(b, s, g, hkv, d).permute(0, 1, 3, 2, 4).reshape(b, s, hq, d)


class MllamaVisionAttention(nn.Module):
    """Bias-free multi-head attention under an explicit mask
    (mllama.py:209-232)."""

    def __init__(self, cfg: MllamaVisionConfig, *, device, dtype):
        super().__init__()
        self.cfg = cfg
        h = cfg.hidden_size
        kw = dict(bias=False, device=device, dtype=dtype)
        self.q_proj = L.Dense(h, h, **kw)
        self.k_proj = L.Dense(h, h, **kw)
        self.v_proj = L.Dense(h, h, **kw)
        self.o_proj = L.Dense(h, h, **kw)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        b, s, _ = x.shape
        shp = (b, s, c.attention_heads, c.head_dim)
        q, k, v = (p(x).reshape(shp) for p in (self.q_proj, self.k_proj, self.v_proj))
        scale = c.head_dim ** -0.5
        if s >= BLOCKED_FROM:
            out = blocked_masked_attention(q, k, v, mask, scale)
        else:
            out = L.attention(q, k, v, mask=mask, scale=scale)
        return self.o_proj(out.reshape(b, s, -1))


class MllamaVisionLayer(nn.Module):
    """Pre-LN attention and erf-GELU MLP; a global layer gates each branch
    by ``tanh`` of its gate (mllama.py:235-259)."""

    def __init__(self, cfg: MllamaVisionConfig, gated: bool, *, device, dtype):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        h = cfg.hidden_size
        self.gated = gated
        self.input_layernorm = L.LayerNorm(h, cfg.norm_eps, **kw)
        self.self_attn = MllamaVisionAttention(cfg, **kw)
        self.post_attention_layernorm = L.LayerNorm(h, cfg.norm_eps, **kw)
        self.fc1 = L.Dense(h, cfg.intermediate_size, **kw)
        self.fc2 = L.Dense(cfg.intermediate_size, h, **kw)
        if gated:
            self.gate_attn = L.empty_param(1, **kw)
            self.gate_ffn = L.empty_param(1, **kw)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        y = self.self_attn(self.input_layernorm(x), mask)
        if self.gated:
            y = torch.tanh(self.gate_attn.to(y.dtype)) * y
        x = x + y
        y = self.fc2(F.gelu(self.fc1(self.post_attention_layernorm(x))))
        if self.gated:
            y = torch.tanh(self.gate_ffn.to(y.dtype)) * y
        return x + y


class MllamaVisionTower(nn.Module):
    """pixel_values ``[N, T, H, W, 3]`` (normalized NHWC, T =
    ``max_num_tiles``, unused slots zero), aspect_ratio_ids ``[N]``,
    aspect_ratio_mask ``[N, T]`` (1 = a real tile) -> ``[N, T * num_patches,
    output_dim]`` (mllama.py:262-361). Parameter names are the flax tree's
    (``models/convert.state_from_flax``)."""

    def __init__(self, cfg: MllamaVisionConfig, *, device, dtype):
        super().__init__()
        self.cfg = cfg
        kw = dict(device=device, dtype=dtype)
        d, t, p = cfg.hidden_size, cfg.max_num_tiles, cfg.num_patches
        n_ar = cfg.max_aspect_ratio_id + 1
        self.patch_embedding = nn.Module()
        self.patch_embedding.weight = L.empty_param(d, 3, cfg.patch_size, cfg.patch_size, **kw)
        self.pre_tile_embedding = L.empty_param(n_ar, t * d, **kw)
        self.pre_tile_gate = L.empty_param(1, **kw)
        self.class_embedding = L.empty_param(d, **kw)
        self.pos_embedding = L.empty_param(p, d, **kw)
        self.pos_gate = L.empty_param(1, **kw)
        self.tile_pos_embedding = L.empty_param(n_ar, t * p * d, **kw)
        self.layernorm_pre = L.LayerNorm(d, 1e-5, **kw)
        self.layernorm_post = L.LayerNorm(d, 1e-5, **kw)
        self.post_tile_embedding = L.empty_param(n_ar, t * d, **kw)
        self.post_tile_gate = L.empty_param(1, **kw)
        for i in range(cfg.num_hidden_layers):
            self.add_module(f"local_{i}", MllamaVisionLayer(cfg, False, **kw))
        for i in range(cfg.num_global_layers):
            self.add_module(f"global_{i}", MllamaVisionLayer(cfg, True, **kw))

    def forward(self, pixel_values: torch.Tensor, aspect_ratio_ids: torch.Tensor,
                aspect_ratio_mask: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        n, t = pixel_values.shape[:2]
        if t != c.max_num_tiles:
            raise ValueError(f"pixel_values must carry max_num_tiles={c.max_num_tiles} tile "
                             f"slots (zero-padded; aspect_ratio_mask marks the real ones), "
                             f"got {t}")
        p_real, p_pad, d = c.num_patches, c.num_patches_padded, c.hidden_size
        dt = pixel_values.dtype
        flat = pixel_values.reshape((n * t,) + tuple(pixel_values.shape[2:]))
        x = F.conv2d(flat.permute(0, 3, 1, 2), self.patch_embedding.weight.to(dt),
                     stride=c.patch_size)
        x = x.flatten(2).transpose(1, 2).reshape(n, t, -1, d)          # [N, T, g*g, D]
        ids = aspect_ratio_ids.long()
        pre = self.pre_tile_embedding[ids].reshape(n, t, 1, d)
        x = x + (torch.tanh(self.pre_tile_gate) * pre).to(dt)
        cls = self.class_embedding.to(dt)[None, None, None].expand(n, t, 1, d)
        x = torch.cat([cls, x], dim=2)                                  # [N, T, P, D]
        g = torch.tanh(self.pos_gate)
        x = x + ((1.0 - g) * self.pos_embedding)[None, None].to(dt)
        tile_pos = self.tile_pos_embedding[ids].reshape(n, t, p_real, d)
        x = x + (g * tile_pos).to(dt)
        x = self.layernorm_pre(x)

        # padding to a multiple of 8, and HF's mask: only invalid -> invalid
        # pairs are blocked
        x = F.pad(x, (0, 0, 0, p_pad - p_real))
        dev = x.device
        valid = (aspect_ratio_mask.to(dev).bool()[:, :, None]
                 & (torch.arange(p_pad, device=dev) < p_real)[None, None])
        inv = (~valid).reshape(n, t * p_pad)
        mask = ~(inv[:, :, None] & inv[:, None, :])[:, None]            # [N, 1, L, L]

        x = x.reshape(n, t * p_pad, d)
        keep = set(c.intermediate_layers_indices)
        inter = {}
        for i in range(c.num_hidden_layers):
            x = getattr(self, f"local_{i}")(x, mask)
            if i in keep:
                inter[i] = x
        x = self.layernorm_post(x)
        post = self.post_tile_embedding[ids].reshape(n, t, 1, d)
        x = x.reshape(n, t, p_pad, d) + (torch.tanh(self.post_tile_gate) * post).to(dt)
        x = x.reshape(n, t * p_pad, d)
        for i in range(c.num_global_layers):
            x = getattr(self, f"global_{i}")(x, mask)

        x = x.reshape(n, t, p_pad, d)[:, :, :p_real]
        feats = torch.stack([inter[i].reshape(n, t, p_pad, d)[:, :, :p_real]
                             for i in c.intermediate_layers_indices], dim=-1)
        out = torch.cat([x, feats.reshape(n, t, p_real, -1)], dim=-1)
        return out.reshape(n, t * p_real, c.output_dim)
