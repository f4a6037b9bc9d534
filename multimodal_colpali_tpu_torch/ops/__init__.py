"""Operators of the retrieval and generation paths; each kernel sits beside its plain
PyTorch version. The generation operators (``quant``, ``int8_matmul``,
``int4_matmul``, ``paged_attention``) and ``window_attention`` (whose function
shares its module's name) are imported from their modules."""

from multimodal_colpali_tpu_torch.ops.attention import (  # noqa: F401
    attention_reference, fused_attention, fused_attention_cuda)
from multimodal_colpali_tpu_torch.ops.fused_layer import (  # noqa: F401
    fused_mlp_block, fused_mlp_block_cuda, fused_mlp_block_reference,
    fused_vit_attention_block, fused_vit_attention_block_cuda,
    fused_vit_attention_block_reference, fused_vit_layer, fused_vit_layer_cuda,
    fused_vit_layer_reference, layer_plan)
from multimodal_colpali_tpu_torch.ops.maxsim import (  # noqa: F401
    MASK_VALUE, maxsim_scores, maxsim_scores_cuda, maxsim_scores_int8, maxsim_scores_int8_cuda,
    maxsim_scores_int8_reference, maxsim_scores_reference, quantize_corpus_int8)
from multimodal_colpali_tpu_torch.ops.preprocess import (  # noqa: F401
    normalize_images, normalize_images_cuda, normalize_images_reference)
from multimodal_colpali_tpu_torch.ops.topk import topk_with_stable_ties  # noqa: F401
