"""The generation tier in PyTorch: decode engine, continuous batchers, OpenAI
server, and the message formatters and answer parser.

Counterparts of ``multimodal_colpali_tpu/generation/{engine,scheduler,paged,
server,messages,parse}.py`` for the text LMs of Gemma-1 (ColPali) and
Gemma-3, and for image-conditioned generation on the ColPali weights
(``PaliGemmaEngine``) and on Gemma-3's (``Gemma3MMEngine``,
``generation/gemma3_mm.py``). Not ported yet: the HTTP client
(``generation/client.py``: it needs ``aiohttp``), speculative decoding and
the Qwen2-VL, LLaVA-NeXT and Mllama image engines.
"""

from multimodal_colpali_tpu_torch.generation.engine import (  # noqa: F401
    LOGPROB_K, ByteTokenizer, GemmaDecodeEngine, ModuloTokenizer, PaliGemmaEngine,
    filter_top_p_top_k, sample_per_slot)
from multimodal_colpali_tpu_torch.generation.gemma3_mm import Gemma3MMEngine  # noqa: F401
from multimodal_colpali_tpu_torch.generation.messages import (  # noqa: F401
    build_choice_string, build_instruction_block, build_reference_from_metadata,
    document_to_context_entry, encode_image, encode_image_to_data_url, format_msgs,
    image_context_messages, pil_image_to_data_url)
from multimodal_colpali_tpu_torch.generation.paged import PagedContinuousBatcher  # noqa: F401
from multimodal_colpali_tpu_torch.generation.parse import (  # noqa: F401
    identity_perm, response_real_out)
from multimodal_colpali_tpu_torch.generation.scheduler import (  # noqa: F401
    AdmissionQueueFull, ContinuousBatcher)
from multimodal_colpali_tpu_torch.generation.server import (  # noqa: F401
    GenerationServer, extract_chat_content, render_chat_prompt)
