"""In-converter picture descriptions via a VLM endpoint (counterpart of
``multimodal_colpali_tpu/ingest/annotate.py``).

The reference's Docling converter attaches granite-vision picture
annotations at parse time (``do_picture_description`` with a custom prompt,
reference functions.py:93-99), so figure documents carry descriptive text
before indexing. This module drives the same capability through the
framework's generation client: extracted figures are described by any
OpenAI-compatible VLM endpoint (granite on vLLM, gpt-4o, or the fake test
server) during ``pdf_loader``.

The default prompt is the reference's verbatim (a behavioral asset -
changing it changes the descriptions and downstream retrieval).

Figures arrive as uint8 arrays; each is encoded as the JAX module encodes
it, a JPEG data URL at width 1024, through ``messages.pil_image_to_data_url``.
That encoding needs Pillow, imported only when a figure is described: the
rest of ingest runs without it.
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence

import numpy as np

# reference functions.py:97-99
DEFAULT_PICTURE_PROMPT = (
    "Describe the image in four sentences. Be consise, scientific and "
    "accurate. Provide numbers if it improves the description."
)


class VlmPictureAnnotator:
    """``picture_annotator`` hook: batch of figures -> descriptions.

    Fan-out runs through generation/client.get_responses (same backoff and
    concurrency cap as the summarization path); failures degrade to the
    client's error sentinel string rather than raising, so ingestion never
    dies on a flaky endpoint.
    """

    def __init__(self, model: str, vllm_port: int = 8006,
                 base_url: Optional[str] = None,
                 prompt: str = DEFAULT_PICTURE_PROMPT,
                 fixed_width: int = 1024):
        self.model = model
        self.vllm_port = vllm_port
        self.base_url = base_url
        self.prompt = prompt
        self.fixed_width = fixed_width

    def __call__(self, images: Sequence[Any]) -> List[str]:
        from PIL import Image

        from multimodal_colpali_tpu_torch.generation.client import get_responses, run_sync
        from multimodal_colpali_tpu_torch.generation.messages import pil_image_to_data_url

        messages = []
        for img in images:
            if not isinstance(img, Image.Image):
                img = Image.fromarray(np.asarray(img, np.uint8))
            url = pil_image_to_data_url(img, fixed_width=self.fixed_width)
            messages.append([{
                "role": "user",
                "content": [
                    {"type": "text", "text": self.prompt},
                    {"type": "image_url", "image_url": {"url": url}},
                ],
            }])
        if not messages:
            return []
        return run_sync(get_responses(self.model, self.vllm_port, messages,
                                      base_url=self.base_url))
