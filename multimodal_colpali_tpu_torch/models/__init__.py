"""The retrieval encoders, the bge text encoder and the generator LMs in
PyTorch: configs, layers, towers, processors, registry."""

from multimodal_colpali_tpu_torch.models.bert import BertEncoder  # noqa: F401
from multimodal_colpali_tpu_torch.models.colpali import ColPaliModel  # noqa: F401
from multimodal_colpali_tpu_torch.models.configs import (  # noqa: F401
    BertConfig, ColFlorModelConfig, ColIdefics3ModelConfig, ColPaliModelConfig,
    ColQwen2ModelConfig, Florence2TextConfig, Florence2VisionConfig, Gemma3TextConfig,
    GemmaTextConfig, LlamaTextConfig, Qwen2TextConfig, Qwen2VisionConfig, SiglipVisionConfig)
from multimodal_colpali_tpu_torch.models.convert import params_from_flax  # noqa: F401
from multimodal_colpali_tpu_torch.models.florence2 import ColFlorModel  # noqa: F401
from multimodal_colpali_tpu_torch.models.idefics3 import ColIdefics3Model  # noqa: F401
from multimodal_colpali_tpu_torch.models.processing import (  # noqa: F401
    ColPaliProcessor, pad_multivectors)
from multimodal_colpali_tpu_torch.models.processing_florence2 import (  # noqa: F401
    ColFlorProcessor)
from multimodal_colpali_tpu_torch.models.processing_idefics3 import (  # noqa: F401
    ColIdefics3Processor)
from multimodal_colpali_tpu_torch.models.processing_qwen2vl import (  # noqa: F401
    ColQwen2Processor)
from multimodal_colpali_tpu_torch.models.qwen2vl import ColQwen2Model  # noqa: F401
from multimodal_colpali_tpu_torch.models.registry import (  # noqa: F401
    GEMMA3_CONFIGS, Retriever, load_gemma3_lm, load_retriever)
from multimodal_colpali_tpu_torch.models.text_encoder import BgeEmbeddings  # noqa: F401
