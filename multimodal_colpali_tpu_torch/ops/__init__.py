"""Retrieval-path operators; each kernel sits beside its plain PyTorch version."""

from multimodal_colpali_tpu_torch.ops.attention import (  # noqa: F401
    attention_reference, fused_attention, fused_attention_cuda)
from multimodal_colpali_tpu_torch.ops.maxsim import (  # noqa: F401
    MASK_VALUE, maxsim_scores, maxsim_scores_cuda, maxsim_scores_reference)
from multimodal_colpali_tpu_torch.ops.preprocess import (  # noqa: F401
    normalize_images, normalize_images_reference, normalize_images_triton)
from multimodal_colpali_tpu_torch.ops.topk import topk_with_stable_ties  # noqa: F401
