"""Default prompt templates (a copy of ``multimodal_colpali_tpu/prompts.py``;
the reference ships these in prompts_used.pkl, keys documented at SURVEY.md
§2.1 "Prompt assets")."""

from __future__ import annotations

import pickle

DEFAULT_PROMPTS = {
    "img_summary": (
        "You are a biomedical figure analyst. Describe the scientific figure "
        "in detail: the entities shown (molecules, glycans, cells, organisms), "
        "axes and units, experimental conditions, and the relationship or "
        "trend the figure demonstrates. Be faithful; do not speculate."
    ),
    "text_summary": (
        "Summarize the following biomedical passage faithfully and concisely, "
        "keeping all named entities, quantities and conclusions: "
    ),
    "img_summary_query": (
        "Given the user question, describe what in this figure is relevant "
        "to answering it, citing the visual evidence."
    ),
    "text_summary_query": (
        "Given the user question, extract from the passage only the content "
        "relevant to answering it: "
    ),
    "rag_summary_query": (
        "Use the provided context snippets and figures judiciously to answer "
        "the question; if the context is insufficient, say so."
    ),
}


def save_default_prompts(path: str = "prompts_used.pkl") -> None:
    """Materialize the prompt asset in the reference's pickle format."""
    with open(path, "wb") as f:
        pickle.dump(DEFAULT_PROMPTS, f)


def load_prompts(path: str | None = None) -> dict:
    if path:
        try:
            with open(path, "rb") as f:
                return pickle.load(f)
        except (OSError, pickle.UnpicklingError):
            pass
    return dict(DEFAULT_PROMPTS)
