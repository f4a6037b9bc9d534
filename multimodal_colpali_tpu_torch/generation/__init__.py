"""The generation tier in PyTorch: decode engine, continuous batchers, OpenAI
server, the HTTP client, and the message formatters and answer parser.

Counterparts of ``multimodal_colpali_tpu/generation/{engine,scheduler,paged,
speculative,server,client,messages,parse}.py`` for the text LMs of Gemma-1
(ColPali), Gemma-3, Qwen2(-VL) and Llama, and for image-conditioned
generation on the ColPali weights (``PaliGemmaEngine``), on Gemma-3's
(``Gemma3MMEngine``, ``generation/gemma3_mm.py``), on Qwen2-VL's
(``Qwen2VLMMEngine``, ``generation/qwen2vl_mm.py``) and on LLaVA-NeXT's
(``LlavaNextMMEngine``, ``generation/llava_next_mm.py``) and on
Llama-3.2-Vision's (``MllamaMMEngine``, ``generation/mllama_mm.py``: per-step
gated cross-attention, per-slot cross pools in every batcher), with
prompt-lookup speculative decoding (``generation/speculative.py``). The client
(``generation/client.py``) runs on the standard library.
"""

from multimodal_colpali_tpu_torch.generation.client import (  # noqa: F401
    ERROR_SENTINEL, get_response_context, get_responses, mcq_response_format,
    post_request_with_retries, post_request_with_retries_raising, resolve_endpoint,
    run_inference, run_sync)
from multimodal_colpali_tpu_torch.generation.engine import (  # noqa: F401
    LOGPROB_K, ByteTokenizer, GemmaDecodeEngine, LlamaDecodeEngine, ModuloTokenizer,
    PaliGemmaEngine, Qwen2DecodeEngine, filter_top_p_top_k, sample_per_slot)
from multimodal_colpali_tpu_torch.generation.gemma3_mm import Gemma3MMEngine  # noqa: F401
from multimodal_colpali_tpu_torch.generation.llava_next_mm import (  # noqa: F401
    LlavaNextImagePreprocessor, LlavaNextMMEngine)
from multimodal_colpali_tpu_torch.generation.messages import (  # noqa: F401
    build_choice_string, build_instruction_block, build_reference_from_metadata,
    document_to_context_entry, encode_image, encode_image_to_data_url, format_msgs,
    image_context_messages, pil_image_to_data_url)
from multimodal_colpali_tpu_torch.generation.mllama_mm import (  # noqa: F401
    MllamaImagePreprocessor, MllamaMMEngine)
from multimodal_colpali_tpu_torch.generation.paged import PagedContinuousBatcher  # noqa: F401
from multimodal_colpali_tpu_torch.generation.parse import (  # noqa: F401
    identity_perm, response_real_out)
from multimodal_colpali_tpu_torch.generation.qwen2vl_mm import (  # noqa: F401
    Qwen2VLImagePreprocessor, Qwen2VLMMEngine, mrope_positions_from_ids)
from multimodal_colpali_tpu_torch.generation.scheduler import (  # noqa: F401
    AdmissionQueueFull, ContinuousBatcher)
from multimodal_colpali_tpu_torch.generation.speculative import (  # noqa: F401
    SpeculativeContinuousBatcher, SpeculativePagedContinuousBatcher, speculative_generate)
from multimodal_colpali_tpu_torch.generation.server import (  # noqa: F401
    GenerationServer, extract_chat_content, render_chat_prompt)
