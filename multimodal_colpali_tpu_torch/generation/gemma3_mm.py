"""Image-conditioned Gemma-3 generation: the reference's whole generator
(counterpart of ``multimodal_colpali_tpu/generation/gemma3_mm.py:47-309``).

The reference serves google/gemma-3-27b-it with the retrieved page images in
the prompt (vLLM; experiment 02 sends the top-5 pages). This engine puts the
images in front of the Gemma-3 LM:

- the SigLIP tower (``models/siglip.SiglipVisionTower``, an ``nn.Module``;
  its attention is K2 on a CUDA tensor), at 896 px 4,096 patches an image;
- the projector (HF ``Gemma3MultiModalProjector``): the patch grid
  average-pooled to ``mm_tokens_per_image`` soft tokens in float32, a Gemma
  ``(1 + w)`` RMSNorm at the vision eps, a bias-free float32 projection to
  the text width, cast to the LM dtype;
- the prompt attends causally, with the sliding/global interleave, except
  that the tokens of one image attend to each other both ways (the span
  pierces the sliding window, as HF's or-mask does); positions are
  0-indexed;
- decoding reuses the text engine's ``_chunk`` and ``_decode``: ``lm`` is the
  ``GemmaDecodeEngine`` that serves text beside this engine, quantized or
  not, so the LM's weights exist once on the card.

``pixel_values`` are normalized NHWC, ``[B, H, W, 3]`` or ``[B, N, H, W, 3]``
for N images a row; each image's soft tokens form their own span.
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence

import torch

from multimodal_colpali_tpu_torch.generation.engine import (
    GemmaDecodeEngine, _ImageEngine, _rms, attn_scale, layer_stack)
from multimodal_colpali_tpu_torch.models import layers as L
from multimodal_colpali_tpu_torch.ops.quant import quantize_encoder_params


class Gemma3MMEngine(_ImageEngine):
    """Image-conditioned Gemma-3 generation on a ``Gemma3MMConfig``.

    ``tower`` is the ``SiglipVisionTower`` of ``cfg.vision`` and
    ``projector`` its tensors (``mm_input_projection [v_hidden, t_hidden]``,
    ``mm_soft_emb_norm.weight``), both on ``lm``'s device in its dtype, as
    ``models/registry.load_gemma3_mm`` makes them. ``vision_dtype="int8"``
    makes the tower's projections W8A8 (``ops/quant``), in place."""

    # positions are 0-indexed, and causal prompts with fixed-length image
    # spans may share prefix pages (paged.py:127-137)
    first_position = 0
    shares_prefix_pages = True

    def __init__(self, cfg, tower: torch.nn.Module, projector: Dict[str, Any],
                 lm: GemmaDecodeEngine, vision_dtype: str = "native"):
        if vision_dtype not in ("native", "int8"):
            raise ValueError(f"vision_dtype must be 'native' or 'int8', got {vision_dtype!r}")
        self.cfg = cfg
        self.vision_tower = tower
        if vision_dtype == "int8":
            # W8A8 SigLIP (gemma3_mm.py:63-78): the tower's projections only,
            # in place; the projector stays in the LM's dtype
            quantize_encoder_params(tower)
        self.projector = projector
        self.lm = lm

    @property
    def tokens_per_image(self) -> int:
        return self.cfg.mm_tokens_per_image

    # -- vision ----------------------------------------------------------------

    def _project(self, vis: torch.Tensor, b: int) -> torch.Tensor:
        """Patches ``[B * N, P, v_hidden]`` -> soft tokens ``[B, N * mm_tokens,
        t_hidden]`` (gemma3_mm.py:88-119): the grid summed over windows of
        kernel x kernel patches in float32 and divided by their count, the
        (1 + w) RMSNorm, the float32 projection."""
        c, dtype = self.cfg, self.lm.dtype
        side = c.vision.image_size // c.vision.patch_size
        tokens_side = int(c.mm_tokens_per_image ** 0.5)
        kernel = side // tokens_side
        bn, _, v_h = vis.shape
        grid = vis.float().reshape(bn, tokens_side, kernel, tokens_side, kernel, v_h)
        pooled = (grid.sum(dim=(2, 4)) / float(kernel * kernel)).reshape(
            bn, c.mm_tokens_per_image, v_h).to(dtype)
        normed = _rms(pooled, self.projector["mm_soft_emb_norm"]["weight"],
                      c.vision.layer_norm_eps)
        proj = normed.float() @ self.projector["mm_input_projection"].float()
        return proj.reshape(b, -1, proj.shape[-1]).to(dtype)

    def _merge(self, ids: torch.Tensor, img: torch.Tensor) -> torch.Tensor:
        """Text embeddings times sqrt(hidden) with the soft tokens in the
        ``<image>`` slots, image after image (gemma3_mm.py:121-137); the
        image features are not rescaled."""
        eng = self.lm
        is_img = ids == self.cfg.image_token_id
        embeds = eng._embed(eng.params, torch.where(is_img, torch.zeros_like(ids), ids))
        img_pos = (torch.cumsum(is_img.long(), dim=1) - 1).clamp(0, img.shape[1] - 1)
        gathered = torch.gather(img, 1, img_pos[..., None].expand(-1, -1, img.shape[-1]))
        return torch.where(is_img[..., None], gathered, embeds)

    # -- prefill -----------------------------------------------------------------

    def _span_bidir(self, ids: torch.Tensor) -> torch.Tensor:
        """``[B, S, S]`` True where query i may attend key j through the
        image-span override: both are tokens of the same image (gemma3_mm.py:141-150)."""
        is_img = ids == self.cfg.image_token_id
        prev = torch.cat([torch.zeros_like(is_img[:, :1]), is_img[:, :-1]], dim=1)
        span = torch.cumsum((is_img & ~prev).long(), dim=1)
        span = torch.where(is_img, span, torch.full_like(span, -1))
        return is_img[:, :, None] & is_img[:, None, :] & (span[:, :, None] == span[:, None, :])

    def _prefill_embeds(self, ids: torch.Tensor, mask: torch.Tensor, x: torch.Tensor, kc, vc):
        """The prompt ``ids``/``mask [B, s]`` with embeddings ``x`` through
        every layer (gemma3_mm.py:152-185), K/V written into the caches'
        first ``s`` rows -> (hidden, (k, v) rows per layer, positions).
        Global layers attend to ``valid & (causal | span)``, sliding ones to
        ``valid & ((causal & in window) | span)``. The layers run at the
        heads ``lm.cfg`` gives (a rank's over a tensor-parallel mesh)."""
        eng = self.lm
        c = eng.cfg
        s = ids.shape[1]
        positions = torch.clamp(torch.cumsum(mask, dim=1) - 1, min=0)
        cols = torch.arange(s, device=ids.device)
        kv_valid = mask.bool()[:, None, None, :]
        causal = (cols[None, :] <= cols[:, None])[None, None]
        window = (cols[None, :] > cols[:, None] - c.sliding_window)[None, None]
        bidir = self._span_bidir(ids)[:, None]
        base = kv_valid & (causal | bidir)
        sliding = kv_valid & ((causal & window) | bidir)
        types = c.layer_types_resolved
        sc = attn_scale(c)

        def kv_write(i, k, v):
            kc[i][:, :s] = k
            vc[i][:, :s] = v
            return k, v

        def attend(i, q, k, v):
            m = sliding if types[i] == "sliding_attention" else base
            return L.attention(q, k, v, mask=m, scale=sc)

        hidden, kv = layer_stack(eng.params, c, x, positions, kv_write, attend)
        return hidden, kv, positions

    def build_mm_prompt(self, text_ids: Sequence[int], bos_id: int = 2, n_images: int = 1,
                        newline_ids: Sequence[int] = (), boi_id: int = -1,
                        eoi_id: int = -1) -> List[int]:
        """Gemma-3's layout (gemma3_mm.py:293-309): bos, then per image an
        optional ``<start_of_image>``, ``mm_tokens_per_image`` image tokens
        and an optional ``<end_of_image>``, then the text and ``newline_ids``."""
        c = self.cfg
        seq: List[int] = [bos_id]
        for _ in range(max(1, n_images)):
            if boi_id >= 0:
                seq.append(boi_id)
            seq += [c.image_token_id] * c.mm_tokens_per_image
            if eoi_id >= 0:
                seq.append(eoi_id)
        return seq + list(text_ids) + list(newline_ids)
