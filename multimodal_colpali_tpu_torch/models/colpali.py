"""ColPali retrieval model (counterpart of ``multimodal_colpali_tpu/models/colpali.py``).

SigLIP tower -> projector -> Gemma prefix -> 128-d head, L2-normalized and
masked: per-token embeddings ``[B, S, embedding_dim]`` in float32, whose
MaxSim scores reproduce ``processor.score_multi_vector``.

Module and parameter names follow the flax tree (``layers_3`` becomes
``layers.3``; a flax ``kernel`` becomes a transposed ``weight``), so
``models/convert.params_from_flax`` maps one onto the other by name.

:func:`shard_model_for_tp` makes a model one rank's part of a tensor-parallel
ColPali (the JAX trainer's ``shard_params_for_tp``, parallel/mesh.py:112-133,
on module weights).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from multimodal_colpali_tpu_torch._device import resolve_device
from multimodal_colpali_tpu_torch.models import layers as L
from multimodal_colpali_tpu_torch.models.configs import ColPaliModelConfig
from multimodal_colpali_tpu_torch.models.gemma import GemmaEmbedder, GemmaModel
from multimodal_colpali_tpu_torch.models.siglip import SiglipVisionTower


class ColPaliModel(nn.Module):
    def __init__(self, cfg: ColPaliModelConfig, *, device="cuda", dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        device = resolve_device(device)
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


def shard_model_for_tp(model: ColPaliModel, mesh, axis: str = "model") -> ColPaliModel:
    """Make ``model`` (whole, on the mesh's device) this rank's part of a
    tensor-parallel ColPali over ``mesh``'s ``axis``, in place -> ``model``.

    Every SigLIP and Gemma layer keeps its rank's slices (``shard_`` of
    ``siglip.SiglipEncoderLayer`` and ``gemma.GemmaDecoderLayer``): column
    projections cut on the weight's dim 0 (``[out, in]``) with their bias,
    row projections on dim 1 with their bias whole, the attention's local
    head counts set. The embeddings, norms, projector and 128-d head stay
    replicated. The mesh and the axis are recorded on the model
    (``model.mesh``, ``model.tp_axis``; also for an axis of one rank, which
    cuts nothing), where the trainer, ``training/checkpoint`` and
    ``adamw_state_from_optax`` find them; :func:`layers.tp_plan` lists the
    split parameters. Sharding it again over the same axis does nothing;
    over another mesh or axis raises."""
    if getattr(model, "mesh", None) is not None:
        if model.mesh is mesh and model.tp_axis == axis:
            return model
        raise ValueError(f"the model is already on a mesh: {model.mesh}, axis "
                         f"{model.tp_axis!r}")
    mesh.check(model.embedding_proj_layer.weight)
    if mesh.size(axis) > 1:
        for layer in (*model.vision_tower.layers, *model.language_model.layers):
            layer.shard_(mesh, axis)
    model.mesh, model.tp_axis = mesh, axis
    return model
