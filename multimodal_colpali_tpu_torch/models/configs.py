"""Model configurations of the ported retrievers and generator LMs
(counterparts of ``multimodal_colpali_tpu/models/configs.py:15-166`` and
``multimodal_colpali_tpu/models/idefics3.py:32-114``).

- ColPali v1.x = SigLIP-So400m vision tower + Gemma-2B text tower + 128-d
  projection.
- ColIdefics3 / ColSmol-256M = SigLIP-768 vision tower (512 px, patch 16),
  pixel shuffle x4 + projection, Llama text tower (576 wide, 30 layers,
  9 heads / 3 KV heads) + 128-d projection.
- ColFlor = Florence-2-base's DaViT vision backbone (768 px, windows of
  12 x 12) + projector + BART encoder (6 layers, 768 wide) + 128-d
  projection (``multimodal_colpali_tpu/models/florence2.py:35-93``).
- Gemma-3 text LMs (1B/4B/12B/27B), the generator the reference serves
  through vLLM (google/gemma-3-27b-it), and the whole multimodal generator
  (``Gemma3MMConfig``, configs.py:193-240): a SigLIP-So400m tower at 896 px
  (4,096 patches) average-pooled to 256 soft tokens an image, then the LM.
- BERT-base (``BertConfig``, configs.py:169-191): the bge-base-en-v1.5 dense
  text encoder of the text-RAG and multimodal-RAG modes.
- ColQwen2 / ColQwen2.5 (``ColQwen2ModelConfig``, qwen2vl.py:42-217): the
  Qwen2-VL vision tower (patches of 2 x 14 x 14, 2 x 2 merge; the 2.5
  variant with RMSNorm, a gated SiLU MLP and windows of 112 px) + a Qwen2
  decoder with mrope + 128-d projection.

Each ``tiny()`` is the small configuration the parity tests and the
committed ``goldens/tiny-*.npz`` use.
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
class Gemma3TextConfig:
    """Gemma-3 text architecture (configs.py:44-136). Differences from
    Gemma-1 (``GemmaTextConfig``), per HF ``Gemma3TextConfig``:

    - GQA with per-head q/k RMSNorm after the projections, before rope.
    - Interleaved attention: every ``sliding_window_pattern``-th layer is
      global (full causal), the rest attend only the last
      ``sliding_window`` tokens.
    - Dual rope bases: sliding layers use ``rope_local_base_freq``
      (10k, unscaled); global layers use ``rope_theta`` (1M) with linear
      position scaling (positions divided by ``rope_scaling_factor``).
    - Sandwich norms: post-attention and pre/post-feedforward RMSNorms
      wrap each residual branch.
    - Attention scale ``query_pre_attn_scalar ** -0.5`` (not head_dim).

    Defaults are the 27B text tower (hidden 5376, 62 layers, 32 q / 16 kv
    heads, head_dim 128, 5:1 sliding:global at window 1024).
    """

    vocab_size: int = 262208
    hidden_size: int = 5376
    intermediate_size: int = 21504
    num_hidden_layers: int = 62
    num_attention_heads: int = 32
    num_key_value_heads: int = 16
    head_dim: int = 128
    rms_norm_eps: float = 1e-6
    rope_theta: float = 1_000_000.0
    rope_local_base_freq: float = 10_000.0
    rope_scaling_factor: float = 8.0
    sliding_window: int = 1024
    sliding_window_pattern: int = 6
    layer_types: tuple = ()          # explicit override of the pattern
    query_pre_attn_scalar: float = 168.0   # 27B: hidden // n_heads

    is_gemma3 = True   # engine dispatch marker (layer_stack branches on it)

    @property
    def layer_types_resolved(self) -> tuple:
        """Per-layer "sliding_attention"/"full_attention", HF's pattern
        rule: layer i is global iff ``(i + 1) % sliding_window_pattern``
        is 0."""
        if self.layer_types:
            return tuple(self.layer_types)
        return tuple(
            "full_attention" if (i + 1) % self.sliding_window_pattern == 0
            else "sliding_attention"
            for i in range(self.num_hidden_layers))

    @classmethod
    def gemma3_27b(cls) -> "Gemma3TextConfig":
        return cls()

    # The smaller released family members (published HF config values).
    @classmethod
    def gemma3_1b(cls) -> "Gemma3TextConfig":
        return cls(vocab_size=262_144, hidden_size=1152,
                   intermediate_size=6912, num_hidden_layers=26,
                   num_attention_heads=4, num_key_value_heads=1,
                   head_dim=256, sliding_window=512,
                   rope_scaling_factor=1.0, query_pre_attn_scalar=256.0)

    @classmethod
    def gemma3_4b(cls) -> "Gemma3TextConfig":
        return cls(hidden_size=2560, intermediate_size=10240,
                   num_hidden_layers=34, num_attention_heads=8,
                   num_key_value_heads=4, head_dim=256,
                   query_pre_attn_scalar=256.0)

    @classmethod
    def gemma3_12b(cls) -> "Gemma3TextConfig":
        return cls(hidden_size=3840, intermediate_size=15360,
                   num_hidden_layers=48, num_attention_heads=16,
                   num_key_value_heads=8, head_dim=256,
                   query_pre_attn_scalar=256.0)

    @classmethod
    def tiny(cls, vocab_size: int = 64) -> "Gemma3TextConfig":
        """Small config for parity tests: both layer types present, a
        window small enough that realistic prompts exercise it."""
        return cls(
            vocab_size=vocab_size, hidden_size=16, intermediate_size=32,
            num_hidden_layers=4, num_attention_heads=2,
            num_key_value_heads=1, head_dim=8, sliding_window=8,
            sliding_window_pattern=2, query_pre_attn_scalar=8.0)


@dataclasses.dataclass(frozen=True)
class Gemma3MMConfig:
    """Gemma-3 multimodal (vision + LM), the generator the reference serves
    with image context (configs.py:193-240). The tower is plain SigLIP; the
    projector average-pools its patch grid to ``mm_tokens_per_image`` soft
    tokens (RMSNorm + a bias-free projection). Image tokens attend
    bidirectionally within their own image's span; everything else is causal,
    with the 5:1 sliding interleave. Defaults are the 27B."""

    vision: SiglipVisionConfig = dataclasses.field(
        default_factory=lambda: SiglipVisionConfig(
            hidden_size=1152, intermediate_size=4304, num_hidden_layers=27,
            num_attention_heads=16, image_size=896, patch_size=14))
    text: Gemma3TextConfig = dataclasses.field(default_factory=Gemma3TextConfig)
    image_token_id: int = 262144
    mm_tokens_per_image: int = 256

    @classmethod
    def gemma3_27b(cls) -> "Gemma3MMConfig":
        return cls()

    # 4b and 12b share the 27B's tower and 256-token projector; only the text
    # tower shrinks. 1b is text-only upstream and has no multimodal config.
    @classmethod
    def gemma3_4b(cls) -> "Gemma3MMConfig":
        return cls(text=Gemma3TextConfig.gemma3_4b())

    @classmethod
    def gemma3_12b(cls) -> "Gemma3MMConfig":
        return cls(text=Gemma3TextConfig.gemma3_12b())

    @classmethod
    def tiny(cls, vocab_size: int = 64) -> "Gemma3MMConfig":
        return cls(
            vision=SiglipVisionConfig(
                hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                num_attention_heads=2, image_size=28, patch_size=14),
            text=Gemma3TextConfig.tiny(vocab_size=vocab_size),
            image_token_id=vocab_size - 1,
            mm_tokens_per_image=1,
        )


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


@dataclasses.dataclass(frozen=True)
class Florence2VisionConfig:
    """The DaViT vision backbone of Florence-2-base (florence2.py:35-49)."""

    depths: tuple = (1, 1, 9, 1)
    embed_dim: tuple = (128, 256, 512, 1024)
    num_heads: tuple = (4, 8, 16, 32)
    num_groups: tuple = (4, 8, 16, 32)
    patch_size: tuple = (7, 3, 3, 3)
    patch_stride: tuple = (4, 2, 2, 2)
    patch_padding: tuple = (3, 1, 1, 1)
    patch_prenorm: tuple = (False, True, True, True)
    window_size: int = 12
    mlp_ratio: float = 4.0
    projection_dim: int = 768
    max_position_embeddings: int = 50
    qkv_bias: bool = True


@dataclasses.dataclass(frozen=True)
class Florence2TextConfig:
    """The BART encoder of Florence-2-base (florence2.py:52-61)."""

    vocab_size: int = 51289
    d_model: int = 768
    encoder_layers: int = 6
    encoder_attention_heads: int = 12
    encoder_ffn_dim: int = 3072
    max_position_embeddings: int = 1024
    scale_embedding: bool = False
    layer_norm_eps: float = 1e-5


@dataclasses.dataclass(frozen=True)
class ColFlorModelConfig:
    """ColFlor = DaViT + projector + BART encoder + 128-d head (florence2.py:64-93)."""

    vision: Florence2VisionConfig = dataclasses.field(default_factory=Florence2VisionConfig)
    text: Florence2TextConfig = dataclasses.field(default_factory=Florence2TextConfig)
    embedding_dim: int = 128
    image_token_id: int = 51200  # <image> placeholder in the expanded vocab
    image_size: int = 768

    @classmethod
    def colflor(cls) -> "ColFlorModelConfig":
        """ahmed-masry/ColFlor - the Florence-2-base encoder stack."""
        return cls()

    @classmethod
    def tiny(cls, vocab_size: int = 64) -> "ColFlorModelConfig":
        return cls(
            vision=Florence2VisionConfig(
                depths=(1, 1), embed_dim=(16, 32), num_heads=(2, 4),
                num_groups=(2, 4), patch_size=(7, 3), patch_stride=(4, 2),
                patch_padding=(3, 1), patch_prenorm=(False, True),
                window_size=4, mlp_ratio=4.0, projection_dim=24,
            ),
            text=Florence2TextConfig(vocab_size=vocab_size, d_model=24,
                                     encoder_layers=1, encoder_attention_heads=2,
                                     encoder_ffn_dim=48, max_position_embeddings=128),
            embedding_dim=8,
            image_token_id=vocab_size - 1,
            image_size=32,
        )


@dataclasses.dataclass(frozen=True)
class LlamaTextConfig:
    """The Llama decoder of SmolVLM (idefics3.py:32-80): GQA without biases,
    plain RMSNorm (``x / rms(x) * w``), SiLU-gated MLP, 1-D rotary."""

    vocab_size: int = 49280
    hidden_size: int = 576
    intermediate_size: int = 1536
    num_hidden_layers: int = 30
    num_attention_heads: int = 9
    num_key_value_heads: int = 3
    rms_norm_eps: float = 1e-5
    rope_theta: float = 100_000.0

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads


@dataclasses.dataclass(frozen=True)
class ColIdefics3ModelConfig:
    vision: SiglipVisionConfig = dataclasses.field(default_factory=lambda: SiglipVisionConfig(
        hidden_size=768, intermediate_size=3072, num_hidden_layers=12,
        num_attention_heads=12, image_size=512, patch_size=16))
    text: LlamaTextConfig = dataclasses.field(default_factory=LlamaTextConfig)
    embedding_dim: int = 128
    image_token_id: int = 49190
    scale_factor: int = 4

    @property
    def n_image_tokens(self) -> int:
        return self.vision.num_patches // (self.scale_factor ** 2)

    @classmethod
    def colsmol_256m(cls) -> "ColIdefics3ModelConfig":
        return cls()

    @classmethod
    def tiny(cls, vocab_size: int = 64) -> "ColIdefics3ModelConfig":
        """Small config for tests and CPU parity (idefics3.py:101-114)."""
        return cls(
            vision=SiglipVisionConfig(hidden_size=32, intermediate_size=64,
                                      num_hidden_layers=2, num_attention_heads=2,
                                      image_size=32, patch_size=8),
            text=LlamaTextConfig(vocab_size=vocab_size, hidden_size=24,
                                 intermediate_size=48, num_hidden_layers=2,
                                 num_attention_heads=2, num_key_value_heads=1,
                                 rope_theta=10000.0),
            embedding_dim=8,
            image_token_id=vocab_size - 1,
            scale_factor=2,
        )


@dataclasses.dataclass(frozen=True)
class BertConfig:
    """bge-base-en-v1.5: standard BERT-base (configs.py:169-191)."""

    vocab_size: int = 30522
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12

    @classmethod
    def bge_base(cls) -> "BertConfig":
        return cls()

    @classmethod
    def tiny(cls) -> "BertConfig":
        return cls(vocab_size=100, hidden_size=32, intermediate_size=64,
                   num_hidden_layers=2, num_attention_heads=2,
                   max_position_embeddings=64)


@dataclasses.dataclass(frozen=True)
class Qwen2VisionConfig:
    """The Qwen2-VL / Qwen2.5-VL vision tower (qwen2vl.py:42-74)."""

    depth: int = 32
    embed_dim: int = 1280
    hidden_size: int = 3584          # merger output = the LM's width
    num_heads: int = 16
    patch_size: int = 14
    temporal_patch_size: int = 2
    spatial_merge_size: int = 2
    mlp_ratio: float = 4.0
    in_channels: int = 3
    variant: str = "qwen2"           # "qwen2" | "qwen2_5"
    intermediate_size: int = 0       # the 2.5 MLP width (0 -> mlp_ratio * embed_dim)
    window_size: int = 112
    fullatt_block_indexes: tuple = (7, 15, 23, 31)

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads

    @property
    def patch_dim(self) -> int:
        return self.in_channels * self.temporal_patch_size * self.patch_size ** 2

    @property
    def mlp_hidden(self) -> int:
        return self.intermediate_size or int(self.embed_dim * self.mlp_ratio)


@dataclasses.dataclass(frozen=True)
class Qwen2TextConfig:
    """The Qwen2 decoder with mrope (qwen2vl.py:77-118): GQA with q/k/v
    biases, plain RMSNorm, SiLU-gated MLP. Defaults are Qwen2-VL-2B's."""

    vocab_size: int = 151936
    hidden_size: int = 1536
    intermediate_size: int = 8960
    num_hidden_layers: int = 28
    num_attention_heads: int = 12
    num_key_value_heads: int = 2
    rms_norm_eps: float = 1e-6
    rope_theta: float = 1_000_000.0
    mrope_section: tuple = (16, 24, 24)
    tie_word_embeddings: bool = True

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads


@dataclasses.dataclass(frozen=True)
class ColQwen2ModelConfig:
    """ColQwen2 = Qwen2-VL + 128-d head (qwen2vl.py:121-217); ``grid_h`` x
    ``grid_w`` patches is the static resolution bucket (54 x 54 = 756 px)."""

    vision: Qwen2VisionConfig = dataclasses.field(default_factory=Qwen2VisionConfig)
    text: Qwen2TextConfig = dataclasses.field(default_factory=Qwen2TextConfig)
    embedding_dim: int = 128
    image_token_id: int = 151655
    vision_start_token_id: int = 151652
    vision_end_token_id: int = 151653
    grid_h: int = 54
    grid_w: int = 54

    @classmethod
    def colqwen2_v1(cls) -> "ColQwen2ModelConfig":
        """vidore/colqwen2-v1.0: the Qwen2-VL-2B backbone."""
        return cls(vision=Qwen2VisionConfig(hidden_size=1536), text=Qwen2TextConfig())

    @classmethod
    def colqwen2_5_v0_2(cls) -> "ColQwen2ModelConfig":
        """vidore/colqwen2.5-v0.2: the Qwen2.5-VL-3B backbone."""
        return cls(
            vision=Qwen2VisionConfig(
                depth=32, embed_dim=1280, hidden_size=2048, num_heads=16,
                variant="qwen2_5", intermediate_size=3420,
                window_size=112, fullatt_block_indexes=(7, 15, 23, 31)),
            text=Qwen2TextConfig(
                vocab_size=151936, hidden_size=2048, intermediate_size=11008,
                num_hidden_layers=36, num_attention_heads=16,
                num_key_value_heads=2, rope_theta=1_000_000.0,
                mrope_section=(16, 24, 24)))

    @classmethod
    def tiny_25(cls, vocab_size: int = 64) -> "ColQwen2ModelConfig":
        return cls(
            vision=Qwen2VisionConfig(depth=3, embed_dim=32, hidden_size=24,
                                     num_heads=2, variant="qwen2_5",
                                     intermediate_size=64, window_size=56,
                                     fullatt_block_indexes=(1,)),
            text=Qwen2TextConfig(vocab_size=vocab_size, hidden_size=24,
                                 intermediate_size=48, num_hidden_layers=2,
                                 num_attention_heads=2, num_key_value_heads=1,
                                 rope_theta=10000.0, mrope_section=(1, 2, 3)),
            embedding_dim=8,
            image_token_id=vocab_size - 1,
            vision_start_token_id=vocab_size - 2,
            vision_end_token_id=vocab_size - 3,
            grid_h=8, grid_w=8)

    @classmethod
    def tiny(cls, vocab_size: int = 64) -> "ColQwen2ModelConfig":
        return cls(
            vision=Qwen2VisionConfig(depth=2, embed_dim=32, hidden_size=24,
                                     num_heads=2, mlp_ratio=2.0),
            text=Qwen2TextConfig(vocab_size=vocab_size, hidden_size=24,
                                 intermediate_size=48, num_hidden_layers=2,
                                 num_attention_heads=2, num_key_value_heads=1,
                                 rope_theta=10000.0, mrope_section=(1, 2, 3)),
            embedding_dim=8,
            image_token_id=vocab_size - 1,
            vision_start_token_id=vocab_size - 2,
            vision_end_token_id=vocab_size - 3,
            grid_h=4, grid_w=4)
