"""Model configurations of the ColPali encoder (counterpart of
``multimodal_colpali_tpu/models/configs.py:15-42, :140-166``).

ColPali v1.x = SigLIP-So400m vision tower + Gemma-2B text tower + 128-d
projection. ``tiny()`` is the small configuration the parity tests and the
committed ``goldens/tiny-colpali*.npz`` use.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class SiglipVisionConfig:
    hidden_size: int = 1152
    intermediate_size: int = 4304
    num_hidden_layers: int = 27
    num_attention_heads: int = 16
    image_size: int = 448
    patch_size: int = 14
    layer_norm_eps: float = 1e-6
    projection_dim: int = 2048  # output dim of the multimodal projector

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2


@dataclasses.dataclass(frozen=True)
class GemmaTextConfig:
    vocab_size: int = 257216
    hidden_size: int = 2048
    intermediate_size: int = 16384
    num_hidden_layers: int = 18
    num_attention_heads: int = 8
    num_key_value_heads: int = 1
    head_dim: int = 256
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0


@dataclasses.dataclass(frozen=True)
class ColPaliModelConfig:
    vision: SiglipVisionConfig = dataclasses.field(default_factory=SiglipVisionConfig)
    text: GemmaTextConfig = dataclasses.field(default_factory=GemmaTextConfig)
    embedding_dim: int = 128
    image_token_id: int = 257152

    @classmethod
    def colpali_v1_3(cls) -> "ColPaliModelConfig":
        return cls()

    @classmethod
    def tiny(cls, vocab_size: int = 64) -> "ColPaliModelConfig":
        """Small config for tests and CPU parity."""
        return cls(
            vision=SiglipVisionConfig(
                hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                num_attention_heads=2, image_size=28, patch_size=14,
                projection_dim=16,
            ),
            text=GemmaTextConfig(
                vocab_size=vocab_size, hidden_size=16, intermediate_size=32,
                num_hidden_layers=2, num_attention_heads=2,
                num_key_value_heads=1, head_dim=8,
            ),
            embedding_dim=8,
            image_token_id=vocab_size - 1,
        )
