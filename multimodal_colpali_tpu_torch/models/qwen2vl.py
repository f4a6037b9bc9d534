"""ColQwen2 / ColQwen2.5 retrieval model (counterpart of ``multimodal_colpali_tpu/models/qwen2vl.py``).

Qwen2-VL backbone + 128-d late-interaction head:

- vision tower: a bias-free linear patch embed over ``[2, 14, 14]`` blocks,
  2-D rotary embeddings (h-angles in the first quarter of the head, w-angles
  in the second), then the blocks and a 2 x 2 merger MLP into the LM width.
  The qwen2 variant (ColQwen2) has LayerNorms and a quick-GELU MLP and
  attends over all of an image's patches; the qwen2_5 variant (ColQwen2.5)
  has RMSNorms and a gated SiLU MLP, and attends within windows of
  ``window_size`` px except in ``fullatt_block_indexes``. Its windows are
  folded into the batch axis and go to ``fused_attention`` with ``kv_lens``
  (K2 on a CUDA device); a grid whose edge windows are smaller is padded to
  whole windows once, and its full blocks mask the padded keys with
  ``kv_valid`` (K2 again). ``_FORCE_WINDOW_MASK`` selects the
  block-diagonal mask over the whole sequence instead (the plain einsum),
  the same function, for tests;
- language model: a Qwen2 decoder (GQA with q/k/v biases, plain RMSNorm,
  SiLU-gated MLP) with multimodal rotary positions (``mrope_cos_sin``, in
  float32) under ``causal & attention_mask``, an explicit mask, so its
  attention takes the plain einsum path, as in the JAX package;
- head: ``embedding_proj_layer``, L2-normalized and masked, in float32.

A batch without pixels runs the language model in float32, as the JAX
module does. Parameter names follow the flax tree (``visual.blocks_<i>``,
``layers.<i>``, ``embed_tokens``, ``norm``, ``embedding_proj_layer``).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from multimodal_colpali_tpu_torch._device import resolve_device
from multimodal_colpali_tpu_torch.models import layers as L
from multimodal_colpali_tpu_torch.models.configs import (
    ColQwen2ModelConfig, Qwen2TextConfig, Qwen2VisionConfig)


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def _rotary(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """``x * cos + rotate_half(x) * sin`` in float32, cast back to x's dtype;
    cos/sin broadcast to x ``[B, S, H, D]``."""
    xf = x.float()
    return (xf * cos + _rotate_half(xf) * sin).to(x.dtype)


# -- vision tower --------------------------------------------------------------

def vision_rotary_cos_sin(cfg: Qwen2VisionConfig, grid_h: int, grid_w: int,
                          theta: float = 10000.0) -> Tuple[np.ndarray, np.ndarray]:
    """cos/sin ``[n_patches, head_dim]`` float32 of the 2-D rotary, patches in
    the processor's merge-group order (qwen2vl.py:215-240)."""
    m = cfg.spatial_merge_size
    hpos = np.arange(grid_h)[:, None].repeat(grid_w, 1)
    wpos = np.arange(grid_w)[None, :].repeat(grid_h, 0)

    def merge_order(p):
        p = p.reshape(grid_h // m, m, grid_w // m, m)
        return p.transpose(0, 2, 1, 3).reshape(-1)

    hpos, wpos = merge_order(hpos), merge_order(wpos)
    dim = cfg.head_dim // 2
    inv_freq = 1.0 / (theta ** (np.arange(0, dim, 2, dtype=np.float64) / dim))
    rot = np.concatenate([hpos[:, None] * inv_freq[None, :],
                          wpos[:, None] * inv_freq[None, :]], axis=-1)
    emb = np.concatenate([rot, rot], axis=-1)
    return np.cos(emb).astype(np.float32), np.sin(emb).astype(np.float32)


# Test knob: the block-diagonal mask over the whole sequence instead of the
# folded windows, even where every window is whole (qwen2vl.py:243).
_FORCE_WINDOW_MASK = False


def window_partition(cfg: Qwen2VisionConfig, grid_h: int, grid_w: int):
    """The Qwen2.5 window layout (qwen2vl.py:246-268) -> (window_index
    ``[n_units]``, the permutation of merge units into window order;
    unit_window_id ``[n_units]``, each unit's window in that order)."""
    m = cfg.spatial_merge_size
    llm_h, llm_w = grid_h // m, grid_w // m
    vmws = cfg.window_size // m // cfg.patch_size
    pad_h = (-llm_h) % vmws
    pad_w = (-llm_w) % vmws
    idx = np.arange(llm_h * llm_w).reshape(llm_h, llm_w)
    idxp = np.full((llm_h + pad_h, llm_w + pad_w), -100)
    idxp[:llm_h, :llm_w] = idx
    nwh, nww = (llm_h + pad_h) // vmws, (llm_w + pad_w) // vmws
    idxp = (idxp.reshape(nwh, vmws, nww, vmws)
            .transpose(0, 2, 1, 3).reshape(nwh * nww, vmws * vmws))
    window_index, unit_wid = [], []
    for w, row in enumerate(idxp):
        valid = row[row != -100]
        window_index.extend(valid.tolist())
        unit_wid.extend([w] * len(valid))
    return np.asarray(window_index, np.int32), np.asarray(unit_wid, np.int32)


def window_layout(cfg: Qwen2VisionConfig, grid_h: int, grid_w: int) -> Dict[str, object]:
    """How the qwen2_5 tower arranges a ``grid_h`` x ``grid_w`` grid
    (qwen2vl.py:356-423), as numpy arrays:

    - ``gather``: patch indices into window order (with the padded slots of
      ragged windows pointing at patch 0);
    - ``win`` = (windows, patches a window) for the fold, or None for the
      mask form; ``win_lens`` the valid patches of each window (ragged only);
    - ``full_valid``: the real (not padded) patches (ragged only);
    - ``mask``: the block-diagonal ``[S, S]`` mask (mask form only);
    - ``reverse``: merged tokens back to the image's order."""
    m2 = cfg.spatial_merge_size ** 2
    s = grid_h * grid_w
    win_idx, unit_wid = window_partition(cfg, grid_h, grid_w)
    unit_gather = win_idx.astype(np.int64)
    counts = np.bincount(unit_wid)
    out: Dict[str, object] = {"win": None, "win_lens": None, "full_valid": None,
                              "mask": None, "reverse": np.argsort(win_idx)}
    if _FORCE_WINDOW_MASK:
        patch_wid = np.repeat(unit_wid, m2)
        out["mask"] = patch_wid[:, None] == patch_wid[None, :]
    elif counts.min() == counts.max():
        out["win"] = (int(len(counts)), int(counts[0]) * m2)
    else:
        # ragged edge windows: pad each window to vmws^2 units once
        vmws = cfg.window_size // cfg.spatial_merge_size // cfg.patch_size
        u_max = vmws * vmws
        n_win = int(len(counts))
        offs = np.concatenate([[0], np.cumsum(counts)[:-1]])
        slot_src = np.full(n_win * u_max, -1, np.int64)
        for w in range(n_win):
            slot_src[w * u_max: w * u_max + counts[w]] = offs[w] + np.arange(counts[w])
        unit_gather = unit_gather[np.where(slot_src >= 0, slot_src, 0)]
        out["win"] = (n_win, u_max * m2)
        out["win_lens"] = (counts * m2).astype(np.int32)
        out["full_valid"] = (slot_src >= 0).repeat(m2)
        slot_of_pos = np.empty(s // m2, np.int64)
        slot_of_pos[slot_src[slot_src >= 0]] = np.nonzero(slot_src >= 0)[0]
        out["reverse"] = slot_of_pos[np.argsort(win_idx)]
    out["gather"] = (unit_gather[:, None] * m2 + np.arange(m2)[None]).reshape(-1)
    return out


class Qwen2VisionBlock(nn.Module):
    """One tower block, qwen2 or qwen2_5 (qwen2vl.py:271-324)."""

    def __init__(self, cfg: Qwen2VisionConfig, *, device, dtype):
        super().__init__()
        self.cfg = cfg
        kw = dict(device=device, dtype=dtype)
        e = cfg.embed_dim
        self.is_25 = cfg.variant == "qwen2_5"
        norm = L.LlamaRMSNorm if self.is_25 else L.LayerNorm
        self.norm1 = norm(e, 1e-6, **kw)
        self.norm2 = norm(e, 1e-6, **kw)
        self.qkv = L.Dense(e, 3 * e, **kw)
        self.attn_proj = L.Dense(e, e, **kw)
        if self.is_25:
            self.gate_proj = L.Dense(e, cfg.mlp_hidden, **kw)
            self.up_proj = L.Dense(e, cfg.mlp_hidden, **kw)
            self.down_proj = L.Dense(cfg.mlp_hidden, e, **kw)
        else:
            self.fc1 = L.Dense(e, cfg.mlp_hidden, **kw)
            self.fc2 = L.Dense(cfg.mlp_hidden, e, **kw)

    def forward(self, x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                mask: Optional[torch.Tensor] = None, win: Optional[Tuple[int, int]] = None,
                win_lens: Optional[torch.Tensor] = None,
                kv_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
        c = self.cfg
        b, s, _ = x.shape
        qkv = self.qkv(self.norm1(x)).view(b, s, 3, c.num_heads, c.head_dim)
        q, k, v = qkv.unbind(2)
        cosb, sinb = cos[None, :, None, :], sin[None, :, None, :]
        q, k = _rotary(q, cosb, sinb), _rotary(k, cosb, sinb)
        scale = c.head_dim ** -0.5
        if win is not None:
            # windows folded into the batch axis: [B * n_win, w, H, D]
            n_win, w = win

            def fold(t):
                return t.reshape(b * n_win, w, c.num_heads, c.head_dim)

            lens = None if win_lens is None else win_lens.repeat(b)
            attn = L.attention(fold(q), fold(k), fold(v), None, scale, kv_lens=lens)
        else:
            attn = L.attention(q, k, v, mask, scale, kv_valid=kv_valid)
        x = x + self.attn_proj(attn.reshape(b, s, c.embed_dim))
        y = self.norm2(x)
        if self.is_25:
            return x + self.down_proj(F.silu(self.gate_proj(y)) * self.up_proj(y))
        h = self.fc1(y)
        return x + self.fc2(h * torch.sigmoid(1.702 * h))


class Qwen2VisionTower(nn.Module):
    """Patches ``[B, P, patch_dim]`` -> merged features ``[B, P / 4, hidden]``
    (qwen2vl.py:327-440)."""

    def __init__(self, cfg: Qwen2VisionConfig, *, device, dtype):
        super().__init__()
        self.cfg = cfg
        kw = dict(device=device, dtype=dtype)
        m2 = cfg.spatial_merge_size ** 2
        self.patch_embed = L.Dense(cfg.patch_dim, cfg.embed_dim, bias=False, **kw)
        for i in range(cfg.depth):
            self.add_module(f"blocks_{i}", Qwen2VisionBlock(cfg, **kw))
        norm = L.LlamaRMSNorm if cfg.variant == "qwen2_5" else L.LayerNorm
        self.ln_q = norm(cfg.embed_dim, 1e-6, **kw)
        self.merger_fc1 = L.Dense(m2 * cfg.embed_dim, m2 * cfg.embed_dim, **kw)
        self.merger_fc2 = L.Dense(m2 * cfg.embed_dim, cfg.hidden_size, **kw)
        self._layouts: Dict[tuple, dict] = {}

    def _layout(self, grid_h: int, grid_w: int, device: torch.device) -> dict:
        """The grid's rotary tables and window layout as tensors on ``device``
        (made once a grid, device and mask mode)."""
        key = (grid_h, grid_w, str(device), _FORCE_WINDOW_MASK)
        if key in self._layouts:
            return self._layouts[key]
        c = self.cfg
        cos, sin = vision_rotary_cos_sin(c, grid_h, grid_w)
        out = {"win": None, "win_lens": None, "full_valid": None, "mask": None,
               "gather": None, "reverse": None}
        if c.variant == "qwen2_5":
            lay = window_layout(c, grid_h, grid_w)
            cos, sin = cos[lay["gather"]], sin[lay["gather"]]
            out["win"] = lay["win"]
            for name in ("win_lens", "full_valid", "mask", "gather", "reverse"):
                if lay[name] is not None:
                    out[name] = torch.from_numpy(np.ascontiguousarray(lay[name])).to(device)
            if out["mask"] is not None:
                out["mask"] = out["mask"][None, None]
        out["cos"] = torch.from_numpy(np.ascontiguousarray(cos)).to(device)
        out["sin"] = torch.from_numpy(np.ascontiguousarray(sin)).to(device)
        self._layouts[key] = out
        return out

    def forward(self, patches: torch.Tensor, grid_h: int, grid_w: int) -> torch.Tensor:
        c = self.cfg
        m2 = c.spatial_merge_size ** 2
        lay = self._layout(grid_h, grid_w, patches.device)
        x = self.patch_embed(patches)
        if lay["gather"] is not None:
            x = x[:, lay["gather"]]
        for i in range(c.depth):
            block = getattr(self, f"blocks_{i}")
            if c.variant == "qwen2_5" and i not in c.fullatt_block_indexes:
                x = block(x, lay["cos"], lay["sin"], lay["mask"], lay["win"], lay["win_lens"])
            else:
                x = block(x, lay["cos"], lay["sin"], kv_valid=lay["full_valid"])
        x = self.ln_q(x)
        b, s, _ = x.shape
        h = F.gelu(self.merger_fc1(x.reshape(b, s // m2, m2 * c.embed_dim)))
        out = self.merger_fc2(h)
        return out if lay["reverse"] is None else out[:, lay["reverse"]]


# -- language model --------------------------------------------------------------

def llama3_inv_freq(inv_freq: np.ndarray, scaling) -> np.ndarray:
    """HF's ``_compute_llama3_parameters`` (qwen2vl.py:445-458): long
    wavelengths divide by ``factor``, short ones pass through, the band
    between interpolates. ``scaling`` = (factor, low_freq_factor,
    high_freq_factor, original_max_position_embeddings)."""
    factor, low_f, high_f, old_len = scaling
    wavelen = 2.0 * np.pi / inv_freq
    low_wl, high_wl = old_len / low_f, old_len / high_f
    scaled = np.where(wavelen > low_wl, inv_freq / factor, inv_freq)
    smooth = (old_len / wavelen - low_f) / (high_f - low_f)
    smoothed = (1.0 - smooth) * scaled / factor + smooth * scaled
    medium = (wavelen >= high_wl) & (wavelen <= low_wl)
    return np.where(medium, smoothed, scaled).astype(np.float32)


def mrope_cos_sin(cfg: Qwen2TextConfig,
                  position_ids: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """position_ids ``[3, B, S]`` -> (cos, sin) ``[B, S, head_dim]`` float32,
    each channel taken from its temporal / height / width stream
    (qwen2vl.py:461-485); a config with ``rope_llama3`` (Llama-3.2-Vision)
    rescales ``inv_freq`` first."""
    half = cfg.head_dim // 2
    inv = 1.0 / (cfg.rope_theta ** (np.arange(0, half, dtype=np.float32) / half))
    scaling = getattr(cfg, "rope_llama3", None)
    if scaling is not None:
        inv = llama3_inv_freq(inv, scaling)
    inv = torch.from_numpy(np.asarray(inv, np.float32)).to(position_ids.device)
    ang = position_ids[..., None].float() * inv                  # [3, B, S, half]
    emb = torch.cat([ang, ang], dim=-1)                          # [3, B, S, head_dim]
    sec = np.zeros(cfg.head_dim, np.int64)
    bounds = np.cumsum(cfg.mrope_section)
    for c in range(half):
        sec[c] = sec[c + half] = int(np.searchsorted(bounds, c, side="right"))
    idx = torch.from_numpy(sec).to(position_ids.device)[None, None, None, :]
    idx = idx.expand(1, *emb.shape[1:])
    return torch.cos(emb).gather(0, idx)[0], torch.sin(emb).gather(0, idx)[0]


class Qwen2Attention(nn.Module):
    def __init__(self, cfg: Qwen2TextConfig, *, device, dtype):
        super().__init__()
        self.cfg = cfg
        kw = dict(device=device, dtype=dtype)
        hd = cfg.head_dim
        self.q_proj = L.Dense(cfg.hidden_size, cfg.num_attention_heads * hd, **kw)
        self.k_proj = L.Dense(cfg.hidden_size, cfg.num_key_value_heads * hd, **kw)
        self.v_proj = L.Dense(cfg.hidden_size, cfg.num_key_value_heads * hd, **kw)
        self.o_proj = L.Dense(cfg.num_attention_heads * hd, cfg.hidden_size, bias=False, **kw)

    def forward(self, x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                mask: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        b, s, _ = x.shape
        q = self.q_proj(x).view(b, s, c.num_attention_heads, c.head_dim)
        k = self.k_proj(x).view(b, s, c.num_key_value_heads, c.head_dim)
        v = self.v_proj(x).view(b, s, c.num_key_value_heads, c.head_dim)
        cosb, sinb = cos[:, :, None, :], sin[:, :, None, :]
        q, k = _rotary(q, cosb, sinb), _rotary(k, cosb, sinb)
        out = L.attention(q, k, v, mask, c.head_dim ** -0.5)
        return self.o_proj(out.reshape(b, s, c.num_attention_heads * c.head_dim))


class Qwen2DecoderLayer(nn.Module):
    def __init__(self, cfg: Qwen2TextConfig, *, device, dtype):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.input_layernorm = L.LlamaRMSNorm(cfg.hidden_size, cfg.rms_norm_eps, **kw)
        self.self_attn = Qwen2Attention(cfg, **kw)
        self.post_attention_layernorm = L.LlamaRMSNorm(cfg.hidden_size, cfg.rms_norm_eps, **kw)
        nb = dict(bias=False, **kw)
        self.gate_proj = L.Dense(cfg.hidden_size, cfg.intermediate_size, **nb)
        self.up_proj = L.Dense(cfg.hidden_size, cfg.intermediate_size, **nb)
        self.down_proj = L.Dense(cfg.intermediate_size, cfg.hidden_size, **nb)

    def forward(self, x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                mask: torch.Tensor) -> torch.Tensor:
        x = x + self.self_attn(self.input_layernorm(x), cos, sin, mask)
        y = self.post_attention_layernorm(x)
        return x + self.down_proj(F.silu(self.gate_proj(y)) * self.up_proj(y))


class ColQwen2Model(nn.Module):
    def __init__(self, cfg: ColQwen2ModelConfig, *, device="cuda", dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        device = resolve_device(device)
        t = cfg.text
        kw = dict(device=device, dtype=dtype)
        self.embed_tokens = L.empty_param(t.vocab_size, t.hidden_size, **kw)
        self.visual = Qwen2VisionTower(cfg.vision, **kw)
        self.layers = nn.ModuleList(Qwen2DecoderLayer(t, **kw)
                                    for _ in range(t.num_hidden_layers))
        self.norm = L.LlamaRMSNorm(t.hidden_size, t.rms_norm_eps, **kw)
        self.embedding_proj_layer = L.Dense(t.hidden_size, cfg.embedding_dim, **kw)

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                position_ids: torch.Tensor, pixel_values: Optional[torch.Tensor] = None,
                grid: Optional[Tuple[int, int]] = None) -> torch.Tensor:
        """input_ids/attention_mask ``[B, S]``, position_ids ``[3, B, S]``,
        pixel_values ``[B, P, patch_dim]`` normalized patches of a
        ``grid`` (default the config's bucket) -> ``[B, S, embedding_dim]``
        float32 (qwen2vl.py:532-582)."""
        c = self.cfg
        gh, gw = grid if grid is not None else (c.grid_h, c.grid_w)
        is_img = input_ids == c.image_token_id
        dtype = pixel_values.dtype if pixel_values is not None else torch.float32
        embeds = F.embedding(torch.where(is_img, torch.zeros_like(input_ids), input_ids),
                             self.embed_tokens).to(dtype)
        if pixel_values is not None:
            feats = self.visual(pixel_values, gh, gw)
            img_pos = (torch.cumsum(is_img.long(), dim=1) - 1).clamp(0, feats.shape[1] - 1)
            gathered = torch.gather(feats, 1, img_pos[..., None].expand(-1, -1, feats.shape[-1]))
            embeds = torch.where(is_img[..., None], gathered, embeds)
        cos, sin = mrope_cos_sin(c.text, position_ids)
        s = input_ids.shape[1]
        causal = torch.ones((s, s), dtype=torch.bool, device=input_ids.device).tril()
        mask = causal[None, None] & attention_mask[:, None, None, :].bool()
        x = embeds
        for layer in self.layers:
            x = layer(x, cos, sin, mask)
        proj = self.embedding_proj_layer(self.norm(x)).float()
        proj = proj / torch.linalg.vector_norm(proj, dim=-1, keepdim=True).clamp_min(1e-12)
        return proj * attention_mask[..., None].float()
