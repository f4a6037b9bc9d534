"""ColPali retrieval model (counterpart of ``multimodal_colpali_tpu/models/colpali.py``).

SigLIP tower -> projector -> Gemma prefix -> 128-d head, L2-normalized and
masked: per-token embeddings ``[B, S, embedding_dim]`` in float32, whose
MaxSim scores reproduce ``processor.score_multi_vector``.

Module and parameter names follow the flax tree (``layers_3`` becomes
``layers.3``; a flax ``kernel`` becomes a transposed ``weight``), so
``models/convert.params_from_flax`` maps one onto the other by name.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from multimodal_colpali_tpu_torch.models import layers as L
from multimodal_colpali_tpu_torch.models.configs import ColPaliModelConfig
from multimodal_colpali_tpu_torch.models.gemma import GemmaEmbedder, GemmaModel
from multimodal_colpali_tpu_torch.models.siglip import SiglipVisionTower


class ColPaliModel(nn.Module):
    def __init__(self, cfg: ColPaliModelConfig, *, device="cpu", dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        kw = dict(device=device, dtype=dtype)
        self.embed = GemmaEmbedder(cfg.text, **kw)
        self.vision_tower = SiglipVisionTower(cfg.vision, **kw)
        self.multi_modal_projector = L.Dense(cfg.vision.hidden_size,
                                             cfg.vision.projection_dim, **kw)
        self.language_model = GemmaModel(cfg.text, **kw)
        self.embedding_proj_layer = L.Dense(cfg.text.hidden_size, cfg.embedding_dim, **kw)

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                pixel_values: Optional[torch.Tensor] = None) -> torch.Tensor:
        """input_ids/attention_mask ``[B, S]``; pixel_values ``[B, H, W, 3]``
        NHWC normalized, in the model dtype -> ``[B, S, embedding_dim]`` float32."""
        c = self.cfg
        hidden = c.text.hidden_size
        is_img = input_ids == c.image_token_id
        embeds = self.embed(torch.where(is_img, torch.zeros_like(input_ids), input_ids))

        if pixel_values is not None:
            vis = self.vision_tower(pixel_values)
            img = self.multi_modal_projector(vis)
            img = img / torch.tensor(hidden ** 0.5, dtype=img.dtype, device=img.device)
            # Scatter the image features into the <image> slots in order
            # (colpali.py:50-58): slot s takes feature cumsum(is_img)[s] - 1.
            n_patches = img.shape[1]
            img_pos = (torch.cumsum(is_img.long(), dim=1) - 1).clamp(0, n_patches - 1)
            gathered = torch.gather(img, 1, img_pos[..., None].expand(-1, -1, img.shape[-1]))
            embeds = torch.where(is_img[..., None], gathered, embeds)

        # Gemma scales embeddings by sqrt(hidden); the image features were
        # divided by it above, so their net scale is 1 (colpali.py:63-65).
        embeds = (embeds.float() * hidden ** 0.5).to(embeds.dtype)
        positions = torch.cumsum(attention_mask, dim=1)  # 1-indexed, as HF
        h = self.language_model(embeds, positions, attention_mask)
        proj = self.embedding_proj_layer(h).float()
        proj = proj / torch.linalg.vector_norm(proj, dim=-1, keepdim=True).clamp_min(1e-12)
        return proj * attention_mask[..., None].float()
