"""Framework-wide constants and the model registry (counterpart of
``multimodal_colpali_tpu/config.py``).

Mirrors the reference's configuration surface:
- ``EMBED_MODEL_ID`` / ``EMB_DIM`` / ``VECTOR_SIZE`` constants
  (reference 01_create_context_qdrant.py:68-70).
- The JSON-overridable ``DEFAULT_MODELS`` registry with per-model
  ``{model_name, model_short, port, text_vd, mm_vd, late_inter,
  late_inter_short}`` (reference 01_create_context_qdrant.py:52-56).
- ``DEFAULT_PRICES_GPT`` price table (reference functions.py:1957-1961).
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List

# Dense text embedding model (bge-base-en-v1.5 in the reference).
EMBED_MODEL_ID = "BAAI/bge-base-en-v1.5"
EMB_DIM = 768

# Late-interaction token-embedding dimensionality (ColPali family).
VECTOR_SIZE = 128

# Max image tokens per page for ColPali (PaliGemma 448x448, patch 14 ->
# 1024 image tokens + prefix text tokens; the reference observes ~1030).
COLPALI_MAX_PAGE_TOKENS = 1056  # padded to a multiple of 8 sublanes

DEFAULT_TOP_K = 5  # reference 02_experiment01.py:47

# Per-generator registry; ports are the local vLLM-compatible endpoints the
# reference exposes (reference 00_run_docker_containers.sh:26-39).
DEFAULT_MODELS: List[Dict[str, Any]] = [
    {
        "model_name": "google/gemma-3-27b-it",
        "model_short": "gemma3",
        "port": 8006,
        "text_vd": "RAG_TEXT",
        "mm_vd": "RAG_MM_gemma3",
        "late_inter": "vidore/colpali-v1.3",
        "late_inter_short": "colpali",
    },
]

DEFAULT_PRICES_GPT: List[Dict[str, Any]] = [
    {"model": "gpt-5", "price_1M_output": 10, "price_1M_input": 1.25},
    {"model": "gpt-5-mini", "price_1M_output": 2, "price_1M_input": 0.25},
    {"model": "gpt-5-nano", "price_1M_output": 0.4, "price_1M_input": 0.05},
]
DEFAULT_PRICE_DICT = {p["model"]: p["price_1M_output"] for p in DEFAULT_PRICES_GPT}


def load_models_config(path: str | None) -> List[Dict[str, Any]]:
    """Load the model registry from a JSON file, falling back to defaults."""
    if path and os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    return [dict(m) for m in DEFAULT_MODELS]
