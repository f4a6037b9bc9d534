"""ColFlor retrieval model: Florence-2 (DaViT + BART encoder) + 128-d head
(counterpart of ``multimodal_colpali_tpu/models/florence2.py``).

- DaViT vision backbone, NHWC activations as in the JAX package: per stage a
  ``ConvEmbed`` downsampler, then pairs of a spatial block (depthwise-conv
  positional encoding, attention within ``window_size`` x ``window_size``
  windows, MLP) and a channel block (the same around grouped channel
  attention). Convolutions are ``torch.nn.functional.conv2d`` (the JAX
  package leaves them to XLA too). The window attention runs
  ``ops/window_attention.window_attention`` on the ``[windows x heads, S, D]``
  rows: K6 on a CUDA tensor, its plain version on a CPU one. (The JAX
  package takes that kernel only under ``MMCP_WINDOW_ATTENTION=1`` and else
  ``models/layers.attention``, whose numerics are the same; the port's
  ``layers.attention`` would send the call to K2.)
- Multimodal projector: learned 2-D position embeddings (columns before
  rows), the cosine temporal embedding of frame 0, a mean-pooled token ahead
  of the patch tokens, a bias-less projection and a LayerNorm.
- Language model: the BART encoder (learned positions with the +2 offset,
  ``layernorm_embedding``, post-LN layers, exact gelu); its attention has an
  explicit mask, so it takes the plain einsum path, as in the JAX package.
- Head: ``embedding_proj_layer``, L2-normalized and masked, in float32.

A batch without pixels runs the encoder in float32, as the JAX module does
(its embeddings take the pixels' dtype, else float32). Parameter names follow
the flax tree (``convs_0``, ``blocks_2_3_spatial``, ``window_attn``,
``row_embeddings``, ``layers.<i>``, ``embed_positions``, ...).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from multimodal_colpali_tpu_torch._device import resolve_device
from multimodal_colpali_tpu_torch.models import layers as L
from multimodal_colpali_tpu_torch.models.configs import (
    ColFlorModelConfig, Florence2TextConfig, Florence2VisionConfig)
from multimodal_colpali_tpu_torch.ops.window_attention import window_attention

_LN_EPS = 1e-5


class Conv2d(nn.Module):
    """A flax ``nn.Conv`` on NHWC activations: weight ``[cout, cin / groups,
    k, k]`` (the flax kernel ``[k, k, cin / groups, cout]``), symmetric
    integer padding."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1, padding: int = 0,
                 groups: int = 1, *, device, dtype):
        super().__init__()
        self.stride, self.padding, self.groups = stride, padding, groups
        self.weight = L.empty_param(cout, cin // groups, kernel, kernel, device=device, dtype=dtype)
        self.bias = L.empty_param(cout, device=device, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv2d(x.permute(0, 3, 1, 2), self.weight.to(x.dtype), self.bias.to(x.dtype),
                     stride=self.stride, padding=self.padding, groups=self.groups)
        return y.permute(0, 2, 3, 1).contiguous()


class ConvEmbed(nn.Module):
    def __init__(self, cfg: Florence2VisionConfig, stage: int, *, device, dtype):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        cin = 3 if stage == 0 else cfg.embed_dim[stage - 1]
        cout = cfg.embed_dim[stage]
        self.prenorm = cfg.patch_prenorm[stage]
        self.conv = Conv2d(cin, cout, cfg.patch_size[stage], cfg.patch_stride[stage],
                           cfg.patch_padding[stage], **kw)
        self.norm = L.LayerNorm(cin if self.prenorm else cout, _LN_EPS, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # [B, H, W, C]
        if self.prenorm:
            x = self.norm(x)
        x = self.conv(x)
        return x if self.prenorm else self.norm(x)


class DepthwiseCPE(nn.Module):
    """3x3 depthwise convolution positional encoding with its residual."""

    def __init__(self, dim: int, *, device, dtype):
        super().__init__()
        self.conv = Conv2d(dim, dim, 3, padding=1, groups=dim, device=device, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.conv(x)


def split_heads(proj: torch.Tensor, heads: int) -> list[torch.Tensor]:
    """q, k and v as ``[n_win * heads, S, hd]`` row blocks of the qkv
    projection's ``[n_win, S, 3 dim]`` output (``[n_win, S, 3, heads, hd]``):
    each is a copy, since the permuted rows are not a view."""
    n_win, s, three_dim = proj.shape
    hd = three_dim // 3 // heads
    rows = proj.reshape(n_win, s, 3, heads, hd).permute(2, 0, 3, 1, 4)
    return [rows[i].reshape(n_win * heads, s, hd) for i in range(3)]


def merge_heads(out: torch.Tensor, heads: int) -> torch.Tensor:
    """Window attention's ``[n_win * heads, S, hd]`` output back to
    ``[n_win, S, heads * hd]`` (a copy)."""
    rows, s, hd = out.shape
    n_win = rows // heads
    return out.reshape(n_win, heads, s, hd).transpose(1, 2).reshape(n_win, s, heads * hd)


class WindowAttention(nn.Module):
    def __init__(self, cfg: Florence2VisionConfig, stage: int, *, device, dtype):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.cfg = cfg
        self.dim, self.heads = cfg.embed_dim[stage], cfg.num_heads[stage]
        self.qkv = L.Dense(self.dim, 3 * self.dim, bias=cfg.qkv_bias, **kw)
        self.proj = L.Dense(self.dim, self.dim, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # [B, H, W, C]
        dim, heads, ws = self.dim, self.heads, self.cfg.window_size
        hd = dim // heads
        b, h, w, _ = x.shape
        pad_b, pad_r = (-h) % ws, (-w) % ws
        if pad_b or pad_r:   # the pad tokens are attended, unmasked (florence2.py:165-172)
            x = F.pad(x, (0, 0, 0, pad_r, 0, pad_b))
        hp, wp = h + pad_b, w + pad_r
        nh, nw = hp // ws, wp // ws
        s = ws * ws
        xw = x.reshape(b, nh, ws, nw, ws, dim).permute(0, 1, 3, 2, 4, 5).reshape(-1, s, dim)
        q, k, v = split_heads(self.qkv(xw), heads)
        out = merge_heads(window_attention(q, k, v, scale=hd ** -0.5), heads)
        out = self.proj(out)
        out = out.reshape(b, nh, nw, ws, ws, dim).permute(0, 1, 3, 2, 4, 5).reshape(b, hp, wp, dim)
        return out[:, :h, :w]


class ChannelAttention(nn.Module):
    """Grouped attention across channels (florence2.py:198-220): the logits of
    each group are ``[C', C']`` over the tokens, scaled by ``N ** -0.5``, in
    float32."""

    def __init__(self, cfg: Florence2VisionConfig, stage: int, *, device, dtype):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.dim, self.groups = cfg.embed_dim[stage], cfg.num_groups[stage]
        self.qkv = L.Dense(self.dim, 3 * self.dim, bias=cfg.qkv_bias, **kw)
        self.proj = L.Dense(self.dim, self.dim, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # [B, N, C]
        b, n, _ = x.shape
        g = self.groups
        qkv = self.qkv(x).reshape(b, n, 3, g, self.dim // g).permute(2, 0, 3, 4, 1)  # [3,B,g,C',N]
        q, k, v = qkv[0].float(), qkv[1].float(), qkv[2].float()
        logits = torch.einsum("bgcn,bgdn->bgcd", q, k) * float(n) ** -0.5
        out = torch.einsum("bgcd,bgdn->bgcn", torch.softmax(logits, dim=-1), v)
        out = out.permute(0, 3, 1, 2).reshape(b, n, self.dim).to(x.dtype)
        return self.proj(out)


class VisionMLP(nn.Module):
    def __init__(self, cfg: Florence2VisionConfig, stage: int, *, device, dtype):
        super().__init__()
        dim = cfg.embed_dim[stage]
        self.fc1 = L.Dense(dim, int(dim * cfg.mlp_ratio), device=device, dtype=dtype)
        self.fc2 = L.Dense(int(dim * cfg.mlp_ratio), dim, device=device, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x), approximate="none"))


class SpatialBlock(nn.Module):
    def __init__(self, cfg: Florence2VisionConfig, stage: int, *, device, dtype):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        dim = cfg.embed_dim[stage]
        self.conv1 = DepthwiseCPE(dim, **kw)
        self.norm1 = L.LayerNorm(dim, _LN_EPS, **kw)
        self.window_attn = WindowAttention(cfg, stage, **kw)
        self.conv2 = DepthwiseCPE(dim, **kw)
        self.norm2 = L.LayerNorm(dim, _LN_EPS, **kw)
        self.ffn = VisionMLP(cfg, stage, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # [B, H, W, C]
        b, h, w, dim = x.shape
        x = self.conv1(x)
        y = self.norm1(x.reshape(b, h * w, dim)).reshape(b, h, w, dim)
        x = self.conv2(x + self.window_attn(y))
        flat = x.reshape(b, h * w, dim)
        flat = flat + self.ffn(self.norm2(flat))
        return flat.reshape(b, h, w, dim)


class ChannelBlock(nn.Module):
    def __init__(self, cfg: Florence2VisionConfig, stage: int, *, device, dtype):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        dim = cfg.embed_dim[stage]
        self.conv1 = DepthwiseCPE(dim, **kw)
        self.norm1 = L.LayerNorm(dim, _LN_EPS, **kw)
        self.channel_attn = ChannelAttention(cfg, stage, **kw)
        self.conv2 = DepthwiseCPE(dim, **kw)
        self.norm2 = L.LayerNorm(dim, _LN_EPS, **kw)
        self.ffn = VisionMLP(cfg, stage, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # [B, H, W, C]
        b, h, w, dim = x.shape
        flat = self.conv1(x).reshape(b, h * w, dim)
        flat = flat + self.channel_attn(self.norm1(flat))
        flat = self.conv2(flat.reshape(b, h, w, dim)).reshape(b, h * w, dim)
        flat = flat + self.ffn(self.norm2(flat))
        return flat.reshape(b, h, w, dim)


class DaViTBackbone(nn.Module):
    """pixel_values ``[B, H, W, 3]`` -> last-stage features ``[B, h, w, C_last]``."""

    def __init__(self, cfg: Florence2VisionConfig, *, device, dtype):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.cfg = cfg
        for stage, depth in enumerate(cfg.depths):
            self.add_module(f"convs_{stage}", ConvEmbed(cfg, stage, **kw))
            for d in range(depth):
                self.add_module(f"blocks_{stage}_{d}_spatial", SpatialBlock(cfg, stage, **kw))
                self.add_module(f"blocks_{stage}_{d}_channel", ChannelBlock(cfg, stage, **kw))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for stage, depth in enumerate(self.cfg.depths):
            x = getattr(self, f"convs_{stage}")(x)
            for d in range(depth):
                x = getattr(self, f"blocks_{stage}_{d}_spatial")(x)
                x = getattr(self, f"blocks_{stage}_{d}_channel")(x)
        return x


class Florence2Projector(nn.Module):
    def __init__(self, cfg: ColFlorModelConfig, *, device, dtype):
        super().__init__()
        v = cfg.vision
        dim = v.embed_dim[-1]
        kw = dict(device=device, dtype=dtype)
        self.row_embeddings = L.empty_param(v.max_position_embeddings, dim // 2, **kw)
        self.column_embeddings = L.empty_param(v.max_position_embeddings, dim - dim // 2, **kw)
        self.image_projection = L.Dense(dim, v.projection_dim, bias=False, **kw)
        self.image_proj_norm = L.LayerNorm(v.projection_dim, _LN_EPS, **kw)

    def forward(self, feats: torch.Tensor) -> torch.Tensor:  # [B, h, w, C]
        b, h, w, dim = feats.shape
        # column embeddings first, then rows (florence2.py:303-306)
        pos = torch.cat([self.column_embeddings[None, :w].expand(h, w, dim - dim // 2),
                         self.row_embeddings[:h, None].expand(h, w, dim // 2)], dim=-1)
        x = (feats + pos.to(feats.dtype)[None]).reshape(b, h * w, dim)
        # the cosine temporal embedding of frame 0: sin(0) = 0 on even
        # channels, cos(0) = 1 on odd ones
        t0 = torch.zeros(dim, dtype=feats.dtype, device=feats.device)
        t0[1::2] = 1.0
        x = x + t0
        tokens = torch.cat([x.mean(dim=1, keepdim=True), x], dim=1)  # the pooled token first
        return self.image_proj_norm(self.image_projection(tokens))


class BartSelfAttention(nn.Module):
    def __init__(self, cfg: Florence2TextConfig, *, device, dtype):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.cfg = cfg
        d = cfg.d_model
        self.q_proj = L.Dense(d, d, **kw)
        self.k_proj = L.Dense(d, d, **kw)
        self.v_proj = L.Dense(d, d, **kw)
        self.out_proj = L.Dense(d, d, **kw)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        b, s, _ = x.shape
        heads = c.encoder_attention_heads
        hd = c.d_model // heads
        q = self.q_proj(x).view(b, s, heads, hd)
        k = self.k_proj(x).view(b, s, heads, hd)
        v = self.v_proj(x).view(b, s, heads, hd)
        out = L.attention(q, k, v, mask=mask, scale=hd ** -0.5)
        return self.out_proj(out.reshape(b, s, c.d_model))


class BartEncoderLayer(nn.Module):
    """Post-LN: LayerNorm after each residual sum (florence2.py:345-356)."""

    def __init__(self, cfg: Florence2TextConfig, *, device, dtype):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.self_attn = BartSelfAttention(cfg, **kw)
        self.self_attn_layer_norm = L.LayerNorm(cfg.d_model, cfg.layer_norm_eps, **kw)
        self.fc1 = L.Dense(cfg.d_model, cfg.encoder_ffn_dim, **kw)
        self.fc2 = L.Dense(cfg.encoder_ffn_dim, cfg.d_model, **kw)
        self.final_layer_norm = L.LayerNorm(cfg.d_model, cfg.layer_norm_eps, **kw)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        x = self.self_attn_layer_norm(x + self.self_attn(x, mask))
        h = self.fc2(F.gelu(self.fc1(x), approximate="none"))
        return self.final_layer_norm(x + h)


class ColFlorModel(nn.Module):
    def __init__(self, cfg: ColFlorModelConfig, *, device="cuda", dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        device = resolve_device(device)
        t = cfg.text
        kw = dict(device=device, dtype=dtype)
        self.embed_tokens = L.empty_param(t.vocab_size, t.d_model, **kw)
        self.vision_tower = DaViTBackbone(cfg.vision, **kw)
        self.multi_modal_projector = Florence2Projector(cfg, **kw)
        self.embed_positions = L.empty_param(t.max_position_embeddings + 2, t.d_model, **kw)
        self.layernorm_embedding = L.LayerNorm(t.d_model, t.layer_norm_eps, **kw)
        self.layers = nn.ModuleList(BartEncoderLayer(t, **kw) for _ in range(t.encoder_layers))
        self.embedding_proj_layer = L.Dense(t.d_model, cfg.embedding_dim, **kw)

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                pixel_values: Optional[torch.Tensor] = None) -> torch.Tensor:
        """input_ids/attention_mask ``[B, S]``; pixel_values ``[B, H, W, 3]``
        NHWC normalized -> ``[B, S, embedding_dim]`` float32."""
        c = self.cfg
        t = c.text
        is_img = input_ids == c.image_token_id
        dtype = pixel_values.dtype if pixel_values is not None else torch.float32
        # <image> ids are looked up as id 0, then overwritten (florence2.py:374-386)
        embeds = F.embedding(torch.where(is_img, torch.zeros_like(input_ids), input_ids),
                             self.embed_tokens).to(dtype)
        if t.scale_embedding:
            embeds = embeds * (t.d_model ** 0.5)
        if pixel_values is not None:
            tokens = self.multi_modal_projector(self.vision_tower(pixel_values))
            img_pos = (torch.cumsum(is_img.long(), dim=1) - 1).clamp(0, tokens.shape[1] - 1)
            gathered = torch.gather(tokens, 1,
                                    img_pos[..., None].expand(-1, -1, tokens.shape[-1]))
            embeds = torch.where(is_img[..., None], gathered, embeds)
        s = input_ids.shape[1]
        embeds = embeds + self.embed_positions[2: s + 2].to(dtype)[None]  # BART's +2 offset
        x = self.layernorm_embedding(embeds)
        mask = attention_mask[:, None, None, :].bool()
        for layer in self.layers:
            x = layer(x, mask)
        proj = self.embedding_proj_layer(x).float()
        proj = proj / torch.linalg.vector_norm(proj, dim=-1, keepdim=True).clamp_min(1e-12)
        return proj * attention_mask[..., None].float()
