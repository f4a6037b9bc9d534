"""The ColPali encoder in PyTorch: configs, layers, towers, processor, registry."""

from multimodal_colpali_tpu_torch.models.colpali import ColPaliModel  # noqa: F401
from multimodal_colpali_tpu_torch.models.configs import (  # noqa: F401
    ColPaliModelConfig, GemmaTextConfig, SiglipVisionConfig)
from multimodal_colpali_tpu_torch.models.convert import params_from_flax  # noqa: F401
from multimodal_colpali_tpu_torch.models.processing import (  # noqa: F401
    ColPaliProcessor, pad_multivectors)
from multimodal_colpali_tpu_torch.models.registry import Retriever, load_retriever  # noqa: F401
