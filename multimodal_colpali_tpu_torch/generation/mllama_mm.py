"""Image-conditioned Llama-3.2-Vision (Mllama) generation, the old-model
tier's AdaptLLM/biomed-Llama-3.2-11B-Vision-Instruct (counterpart of
``multimodal_colpali_tpu/generation/mllama_mm.py``).

The text stack is a plain Llama (``lm``, a ``LlamaDecodeEngine`` over the
self-attention layers, renumbered) with gated cross-attention layers that
this engine injects through ``engine.layer_stack``'s ``interleave`` hooks:

- the tower (``models/mllama.MllamaVisionTower``: every one of the 4 tile
  slots of an image runs, padding tiles too, as in HF and JAX) and the
  linear ``multi_modal_projector`` give the cross states;
- the cross K/V are computed once from them (``k_norm`` applied) and used by
  the prefill and by every decode step: a generated token cross-attends all
  of its prompt's images;
- the prompt holds one ``<|image|>`` token an image, plain positions, fully
  causal; token p attends image i iff image i's marker sits at or before p
  and no later run of markers does (HF's rule), and only its real tiles. A
  row that attends no image (a leading BOS, text before the first marker)
  keeps uniform attention over every key and its cross MLP output is zeroed
  (HF's ``full_text_row_masked_out_mask``).

Cross attention passes an explicit mask, so it is the plain float32 einsum
(``models/mllama.gqa_attention``, the KV group folded into the query rows),
as JAX's ``layers.attention`` takes it; projections go through ``q_dense``
(K8a / K9 under int8 / int4 weights). The batchers carry per-slot pools of
each image's real-tile rows (:meth:`MllamaMMEngine.packed_cross_kv`) and run
the same blocks in their decode and verify steps (``generation/scheduler``).

Over an ``lm`` with a tensor-parallel mesh the cross blocks are cut as the
LM's layers are (``engine.tp_engine_params``): the rank's query and KV heads
of ``q/k/v_proj`` and a slice of the MLP's hidden units, ``o_proj`` and
``down_proj`` row-parallel (their products all-reduced over ``model``); the
norms and the tanh gates stay whole. The tower and the projector run whole
on every rank.

``pixel_values`` are tile stacks ``[B, T, H, W, 3]`` or ``[B, N, T, H, W, 3]``
(``image_rank = 4``: one image is ``[T, H, W, 3]``), as
:class:`MllamaImagePreprocessor` makes them.
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from multimodal_colpali_tpu_torch.generation.engine import (
    LlamaDecodeEngine, _dense, _ImageEngine, _lin, _rms_plain, _row, tp_engine_params)
from multimodal_colpali_tpu_torch.models.mllama import MllamaMMConfig, gqa_attention
from multimodal_colpali_tpu_torch.models.processing import _upload, image_device, normalize_on
from multimodal_colpali_tpu_torch.ingest.imageops import resize
from multimodal_colpali_tpu_torch.ops.quant import (
    is_quantized, is_quantized_int4, quantize_encoder_params, quantize_kernels)

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
# float32 logits one cross-attention pass may hold (1 GiB): a prefill blocks
# its queries to stay under it
CROSS_LOGITS_BUDGET = 1 << 28


class MllamaImagePreprocessor:
    """RGB images (uint8 arrays or tensors) -> ``[N, T, S, S, 3]`` float32 at
    the engine's static tile layout (mllama_mm.py:55-110), Pillow's BICUBIC
    by ``ingest/imageops`` on ``device`` or the pages' own, no Pillow.

    ``tiles=(1, 1)`` stretches the image to the square tile. A multi-tile
    layout resizes into the ``rows x cols`` canvas keeping the aspect,
    zero-pads the raw pixels bottom and right, then normalizes (padding lands
    at normalized black) and splits the canvas row-major into tiles; unused
    slots stay 0. A numpy array on the CPU, a tensor on a CUDA device."""

    def __init__(self, cfg: MllamaMMConfig, tiles: Tuple[int, int] = (1, 1),
                 device: Any = None):
        self.size = cfg.vision.image_size
        self.slots = cfg.vision.max_num_tiles
        self.tiles = (int(tiles[0]), int(tiles[1]))
        cfg.vision.aspect_ratio_id(self.tiles)      # validate
        self.device = device

    def _canvas(self, img: Any, dev: torch.device) -> torch.Tensor:
        """The raw ``[rows * S, cols * S, 3]`` canvas, float32 in 0..255."""
        rows, cols = self.tiles
        ch, cw = rows * self.size, cols * self.size
        t = _upload(img, dev).to(torch.uint8)
        if t.dim() == 2:                    # gray, as Pillow's convert("RGB")
            t = t[..., None].expand(-1, -1, 3)
        h, w = int(t.shape[0]), int(t.shape[1])
        if (rows, cols) == (1, 1):
            return (t if (h, w) == (ch, cw) else resize(t, (cw, ch), "bicubic")).float()
        scale = min(ch / h, cw / w)
        nh, nw = max(1, int(round(h * scale))), max(1, int(round(w * scale)))
        canvas = torch.zeros((ch, cw, 3), dtype=torch.float32, device=dev)
        canvas[:nh, :nw] = (t if (h, w) == (nh, nw) else resize(t, (nw, nh), "bicubic")).float()
        return canvas

    def __call__(self, images: Sequence[Any]):
        dev = image_device(images, self.device)
        rows, cols = self.tiles
        sz = self.size
        out = torch.zeros((len(images), self.slots, sz, sz, 3), dtype=torch.float32, device=dev)
        for n, img in enumerate(images):
            canvas = normalize_on(self._canvas(img, dev), CLIP_MEAN, CLIP_STD)
            out[n, :rows * cols] = (canvas.reshape(rows, sz, cols, sz, 3)
                                    .permute(0, 2, 1, 3, 4).reshape(rows * cols, sz, sz, 3))
        return out.numpy() if out.device.type == "cpu" else out


def _cast_tree(t: Any, device: torch.device, dtype: torch.dtype) -> Any:
    """Leaves onto ``device``, float32 ones cast to ``dtype``; quantized
    dicts pass as they are (their float32 scales stay float32)."""
    if is_quantized(t) or is_quantized_int4(t):
        return {k: v.to(device) for k, v in t.items()}
    if isinstance(t, dict):
        return {k: _cast_tree(v, device, dtype) for k, v in t.items()}
    return t.to(device, dtype) if t.dtype == torch.float32 else t.to(device)


class MllamaMMEngine(_ImageEngine):
    """Image-conditioned Llama-3.2-Vision generation on an ``MllamaMMConfig``.

    ``tower`` is the ``MllamaVisionTower`` and ``projector`` its tensors
    (``kernel [output_dim, hidden]``, ``bias``) on ``lm``'s device in its
    dtype, ``cross_layers`` the cross blocks' tree keyed by global index, as
    ``models/registry.load_mllama_mm`` makes them. Under the LM's int8 / int4
    weights the cross kernels take the same format (a tree that arrives
    quantized is used as it is). ``vision_dtype="int8"`` makes the tower's
    projections W8A8, in place. ``tiles=(rows, cols)`` is the static layout
    every image is packed into, one of the checkpoint's aspect ratios."""

    image_rank = 4              # one image is [T, H, W, 3]
    # decode cross-attends every step: the batchers keep per-slot cross pools
    cross_decode = True
    first_position = 0
    # the image context lives in the cross pools, not in prompt pages
    shares_prefix_pages = False

    def __init__(self, cfg: MllamaMMConfig, tower: torch.nn.Module, projector: Dict[str, Any],
                 cross_layers: Dict[str, Any], lm: LlamaDecodeEngine,
                 vision_dtype: str = "native", tiles: Tuple[int, int] = (1, 1)):
        if vision_dtype not in ("native", "int8"):
            raise ValueError(f"vision_dtype must be 'native' or 'int8', got {vision_dtype!r}")
        self.cfg = cfg
        self.tiles = (int(tiles[0]), int(tiles[1]))
        self.ar_id = cfg.vision.aspect_ratio_id(self.tiles)
        self.n_real_tiles = self.tiles[0] * self.tiles[1]
        self.lm = lm
        self.vision_tower = tower
        if vision_dtype == "int8":
            quantize_encoder_params(tower)
        self.projector = projector
        cross = _cast_tree(cross_layers, lm.device, lm.dtype)
        if lm.weight_dtype != "native":
            cross = quantize_kernels(cross, lm.weight_dtype)
        if lm.mesh is not None:
            cross, _ = tp_engine_params(
                cross, lm.model_cfg, lm.mesh,
                attention=lambda t: [t[str(g)]["cross_attn"] for g in cfg.cross_attention_layers])
        self.cross_params = cross

    @property
    def tokens_per_image(self) -> int:
        return 1                # one <|image|> marker an image

    @property
    def cross_tokens_per_image(self) -> int:
        """Cross keys an image in the prefill's states: every tile slot."""
        c = self.cfg.vision
        return c.max_num_tiles * c.num_patches

    @property
    def packed_cross_tokens_per_image(self) -> int:
        """Real-tile rows an image in a batcher's cross pool."""
        return self.n_real_tiles * self.cfg.vision.num_patches

    # -- vision ----------------------------------------------------------------

    def _tower(self, pix: torch.Tensor) -> torch.Tensor:
        """``[B, N, T, H, W, 3]`` -> features ``[B * N, T * P, output_dim]``
        at the engine's tile layout (slots past ``n_real_tiles`` padding)."""
        flat = pix.reshape((-1,) + tuple(pix.shape[2:])).to(self.lm.dtype)
        n, t = flat.shape[:2]
        dev = flat.device
        ids = torch.full((n,), self.ar_id, dtype=torch.int64, device=dev)
        ar_mask = (torch.arange(t, device=dev)[None] < self.n_real_tiles).expand(n, t)
        return self.vision_tower(flat, ids, ar_mask)

    def _project(self, feats: torch.Tensor, b: int) -> torch.Tensor:
        p = self.projector
        proj = _dense(feats, p["kernel"], p["bias"])
        return proj.reshape(b, -1, proj.shape[-1]).to(self.lm.dtype)

    def _cross_states(self, pix: torch.Tensor) -> torch.Tensor:
        """``[B, N, T, H, W, 3]`` -> projected cross states ``[B, N * T * P,
        text hidden]`` (mllama_mm.py:174-193)."""
        return self._project(self._tower(pix), pix.shape[0])

    def _cross_kv(self, states: torch.Tensor) -> Dict[int, Tuple[torch.Tensor, torch.Tensor]]:
        """Per cross layer (k, v) ``[B, Skv, Hkv, D]`` at ``lm.cfg``'s heads
        (a rank's over a mesh), ``k_norm`` applied."""
        c = self.lm.cfg
        b, skv, _ = states.shape
        out = {}
        for g in self.cfg.cross_attention_layers:
            lp = self.cross_params[str(g)]["cross_attn"]
            k = _lin(states, lp["k_proj"]).reshape(b, skv, c.num_key_value_heads, c.head_dim)
            k = _rms_plain(k, lp["k_norm"]["weight"], c.rms_norm_eps)
            v = _lin(states, lp["v_proj"]).reshape(b, skv, c.num_key_value_heads, c.head_dim)
            out[g] = (k, v)
        return out

    # -- the cross-attention decoder block ---------------------------------------

    def _cross_block(self, lp, x, ck, cv, mask, full_row):
        """HF ``MllamaCrossAttentionDecoderLayer`` (mllama_mm.py:210-240):
        gated cross attention and gated MLP; ``mask`` bool broadcastable to
        ``[B, 1, S, Skv]``, ``full_row [B, S, 1]`` (0: the row attends no
        image, its MLP output is zeroed) or None. At ``lm.cfg``'s heads; over
        a mesh ``o_proj`` and ``down_proj`` reduce over ``model``."""
        c = self.lm.cfg
        b, s, _ = x.shape
        y = _rms_plain(x, lp["input_layernorm"]["weight"], c.rms_norm_eps)
        q = _lin(y, lp["cross_attn"]["q_proj"]).reshape(b, s, c.num_attention_heads, c.head_dim)
        q = _rms_plain(q, lp["cross_attn"]["q_norm"]["weight"], c.rms_norm_eps)
        per_row = c.num_attention_heads * ck.shape[1]
        block = max(1, CROSS_LOGITS_BUDGET // per_row) if s * per_row > CROSS_LOGITS_BUDGET \
            else None
        att = gqa_attention(q, ck, cv, mask, c.head_dim ** -0.5, block=block)
        att = _row(att.reshape(b, s, -1), lp["cross_attn"]["o_proj"], c)
        x = x + torch.tanh(lp["gate_attn"].float()).to(x.dtype) * att
        y = _rms_plain(x, lp["post_attention_layernorm"]["weight"], c.rms_norm_eps)
        mlp = _row(F.silu(_lin(y, lp["mlp"]["gate_proj"])) * _lin(y, lp["mlp"]["up_proj"]),
                   lp["mlp"]["down_proj"], c)
        if full_row is not None:
            mlp = mlp * full_row.to(mlp.dtype)
        return x + torch.tanh(lp["gate_mlp"].float()).to(x.dtype) * mlp

    def _slots_of(self):
        """{self layer index: [(pool row, global index), ...]}: cross layers
        run before the self layer their global index precedes, in global
        order; pool rows follow ``cross_attention_layers``."""
        order = {g: i for i, g in enumerate(self.cfg.cross_attention_layers)}
        slots: Dict[int, list] = {}
        for g, self_j in self.cfg.cross_schedule:
            slots.setdefault(self_j, []).append((order[g], g))
        return slots

    def _interleave(self, ckv, mask, full_row):
        """``layer_stack`` hooks running every cross block over ``ckv``
        (mllama_mm.py:242-262)."""
        def make(entries):
            def hook(x):
                for _, g in entries:
                    x = self._cross_block(self.cross_params[str(g)], x, ckv[g][0], ckv[g][1],
                                          mask, full_row)
                return x
            return hook

        return {j: make(e) for j, e in self._slots_of().items()}

    def pool_hooks(self, ck: torch.Tensor, cv: torch.Tensor, clen: torch.Tensor):
        """The batchers' decode and verify hooks (scheduler.py:316-384):
        pools ``[n_cross, B, R, Hkv, D]`` with ``clen [B]`` rows in use a
        slot. An image slot attends its rows; a text slot runs the block
        under a uniform mask and keeps its input (HF skips the cross layers
        of a text-only request)."""
        has = clen > 0
        keys = torch.arange(ck.shape[2], device=ck.device)[None] < clen[:, None]
        amask = (keys | ~has[:, None])[:, None, None, :]

        def make(entries):
            def hook(h):
                for row, g in entries:
                    y = self._cross_block(self.cross_params[str(g)], h, ck[row], cv[row],
                                          amask, None)
                    h = torch.where(has[:, None, None], y, h)
                return h
            return hook

        return {j: make(e) for j, e in self._slots_of().items()}

    def _tile_pattern(self, device) -> torch.Tensor:
        """``[T * P]`` bool: an image's real-tile keys at the engine's layout."""
        c = self.cfg.vision
        return (torch.arange(c.max_num_tiles * c.num_patches, device=device)
                < self.n_real_tiles * c.num_patches)

    def _cross_masks(self, ids: torch.Tensor, mask: torch.Tensor, n_img: int):
        """HF's ``get_cross_attention_token_mask`` (mllama_mm.py:279-306) ->
        (key mask ``[B, 1, S, N * T * P]`` bool, full_row ``[B, S, 1]``
        float32): token p attends image i iff i's marker sits at or before p
        and no later group of markers does. A run of consecutive markers is
        one group; an image's span ends where the next group starts (JAX
        keeps every earlier image, ROADMAP F9; the two agree on the layout
        :meth:`build_mm_prompt` makes)."""
        is_img = (ids == self.cfg.image_token_id) & mask.bool()
        n_seen = torch.cumsum(is_img.long(), dim=1)
        prev = torch.cat([torch.zeros_like(is_img[:, :1]), is_img[:, :-1]], dim=1)
        group = torch.cumsum((is_img & ~prev).long(), dim=1)          # groups seen at p
        img_group = torch.stack([(group * (is_img & (n_seen == i + 1))).sum(dim=1)
                                 for i in range(n_img)], dim=1)       # [B, N]
        attends = ((torch.arange(n_img, device=ids.device)[None, None] < n_seen[:, :, None])
                   & (img_group[:, None, :] == group[:, :, None]))
        full_row = n_seen > 0
        keys = (attends[..., None] & self._tile_pattern(ids.device)[None, None, None]
                ).reshape(ids.shape + (-1,))
        # rows attending nothing keep uniform attention over all keys
        keys = keys | ~full_row[:, :, None]
        return keys[:, None], full_row[:, :, None].float()

    # -- prefill ---------------------------------------------------------------

    def prefill(self, ids, mask, pix, kc, vc):
        raise RuntimeError(
            "Mllama decode needs per-step cross-attention: prefill through "
            "prefill_cross and decode with the cross hooks (the batchers' cross "
            "pools do this); the plain prefill contract would drop the cross "
            "path from decode")

    def packed_cross_kv(self, ckv, n_img: int):
        """``{layer: (k, v) [B, N * T * P, Hkv, D]}`` -> the real-tile rows,
        stacked ``[n_cross, B, N * n_real * P, Hkv, D]`` twice: what a
        batcher's cross pool holds (decode never attends padding tiles)."""
        c = self.cfg.vision
        tp = c.max_num_tiles * c.num_patches
        p_real = self.packed_cross_tokens_per_image

        def pack(a):
            b = a.shape[0]
            return a.reshape((b, n_img, tp) + tuple(a.shape[2:]))[:, :, :p_real].reshape(
                (b, n_img * p_real) + tuple(a.shape[2:]))

        layers = self.cfg.cross_attention_layers
        return (torch.stack([pack(ckv[g][0]) for g in layers]),
                torch.stack([pack(ckv[g][1]) for g in layers]))

    def prefill_cross(self, ids: torch.Tensor, mask: torch.Tensor, pix: torch.Tensor, kc, vc,
                      kv_valid=None):
        """The causal prompt at plain positions with the cross blocks
        interleaved (mllama_mm.py:316-339), K/V into the caches' first ``s``
        rows -> (hidden, (k, v), positions, cross K/V per layer)."""
        eng = self.lm
        if pix.dim() == 5:
            pix = pix[:, None]
        ckv = self._cross_kv(self._cross_states(pix))
        amask, full_row = self._cross_masks(ids, mask, pix.shape[1])
        positions = torch.clamp(torch.cumsum(mask, dim=1) - 1, min=0)
        if kv_valid is None:
            kv_valid = mask.bool()
        hidden, kv = eng._chunk(eng.params, eng._embed(eng.params, ids), positions, kc, vc, 0,
                                kv_valid, interleave=self._interleave(ckv, amask, full_row))
        return hidden, kv, positions, ckv

    # -- generation --------------------------------------------------------------

    @torch.inference_mode()
    def generate(self, prompts: Sequence[Sequence[int]], pixel_values,
                 max_new_tokens: int = 32, temperature: float = 0.0, eos_id: int = -1,
                 pad_id: int = 0, seed: int = 0, bucket: int = 16, top_p: float = 1.0,
                 top_k: int = 0) -> List[List[int]]:
        """Continuations of prompts built by :meth:`build_mm_prompt`
        (mllama_mm.py:344-407): every decode step cross-attends all of its
        prompt's images, their real tiles only."""
        eng = self.lm
        s, ids, mask = self._padded(prompts, pad_id, bucket)
        b = len(prompts)
        pix = self._pixels(pixel_values)
        if pix.dim() == 5:
            pix = pix[:, None]
        kc, vc = eng._caches(b, s + max_new_tokens)
        kv_valid = torch.cat([mask.bool(), torch.ones((b, max_new_tokens), dtype=torch.bool,
                                                       device=eng.device)], dim=1)
        hidden, _, positions, ckv = self.prefill_cross(ids, mask, pix, kc, vc, kv_valid)
        dec_mask = self._tile_pattern(eng.device).repeat(pix.shape[1])[None, None, None]
        return eng._decode(hidden[:, -1], positions[:, -1], kc, vc, s, kv_valid,
                           max_new_tokens, temperature, eos_id, pad_id, seed, top_p, top_k,
                           interleave=self._interleave(ckv, dec_mask, None))

    @torch.inference_mode()
    def next_token_logits(self, prompts: Sequence[Sequence[int]], pixel_values,
                          pad_id: int = 0, bucket: int = 16) -> np.ndarray:
        """Prefill-only float32 logits ``[B, V]`` (mllama_mm.py:409-428), the
        server's constrained-decoding surface."""
        eng = self.lm
        s, ids, mask = self._padded(prompts, pad_id, bucket)
        kc, vc = eng._caches(len(prompts), s)
        hidden, _, _, _ = self.prefill_cross(ids, mask, self._pixels(pixel_values), kc, vc)
        return eng._logits(eng.params, hidden[:, -1]).cpu().numpy()

    def build_mm_prompt(self, text_ids: Sequence[int], bos_id: int = -1, n_images: int = 1,
                        newline_ids: Sequence[int] = ()) -> List[int]:
        """Mllama's layout (mllama_mm.py:430-450): an optional BOS, one
        ``<|image|>`` token an image, then the text and ``newline_ids``."""
        seq: List[int] = [] if bos_id < 0 else [bos_id]
        seq += [self.cfg.image_token_id] * max(1, n_images)
        return seq + list(text_ids) + list(newline_ids)
