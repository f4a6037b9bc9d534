"""The generation tier in PyTorch: decode engine, continuous batchers, OpenAI server.

Counterparts of ``multimodal_colpali_tpu/generation/{engine,scheduler,paged,server}.py``
for the text LMs of Gemma-1 (ColPali) and Gemma-3, and for image-conditioned
generation on the ColPali weights (``PaliGemmaEngine``) and on Gemma-3's
(``Gemma3MMEngine``, ``generation/gemma3_mm.py``). Speculative decoding and
the HTTP client are not ported yet.
"""

from multimodal_colpali_tpu_torch.generation.engine import (  # noqa: F401
    LOGPROB_K, ByteTokenizer, GemmaDecodeEngine, ModuloTokenizer, PaliGemmaEngine,
    filter_top_p_top_k, sample_per_slot)
from multimodal_colpali_tpu_torch.generation.gemma3_mm import Gemma3MMEngine  # noqa: F401
from multimodal_colpali_tpu_torch.generation.paged import PagedContinuousBatcher  # noqa: F401
from multimodal_colpali_tpu_torch.generation.scheduler import (  # noqa: F401
    AdmissionQueueFull, ContinuousBatcher)
from multimodal_colpali_tpu_torch.generation.server import (  # noqa: F401
    GenerationServer, extract_chat_content, render_chat_prompt)
