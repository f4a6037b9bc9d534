"""OpenAI-format multimodal message formatters (a copy of
``multimodal_colpali_tpu/generation/messages.py``).

Behavior parity with reference functions.py:450-453 (encode_image),
471-488 (format_msgs), 715-763 (encode_image_to_data_url,
build_choice_string, build_instruction_block, build_reference_from_metadata,
document_to_context_entry). The JAX module imports Pillow at its top; this
one imports it inside the functions that decode or resize images, so the
text formatters (and ``format_msgs``, which base64-encodes image files as
they are) work where Pillow is not installed.
"""

from __future__ import annotations

import base64
from io import BytesIO
from typing import Any, Dict, List, Optional


def encode_image(image_path: str) -> str:
    with open(image_path, "rb") as f:
        return base64.b64encode(f.read()).decode("utf-8")


def format_msgs(prompt: str, img_links: List[str], text: str = "") -> List[Dict]:
    """User message with text part + base64 image parts (JPEG data URLs)."""
    part: List[Dict[str, Any]] = [
        {"type": "text", "text": prompt if text == "" else prompt + text}
    ]
    for img_link in img_links:
        part.append({
            "type": "image_url",
            "image_url": {"url": f"data:image/jpeg;base64,{encode_image(img_link)}"},
        })
    return [{"role": "user", "content": part}]


def encode_image_to_data_url(image_path: str, fixed_width: int = 1024) -> Optional[str]:
    """Resize to fixed width (LANCZOS) and emit a PNG data URL."""
    from PIL import Image

    try:
        img = Image.open(image_path).convert("RGB")
    except Exception:
        return None
    w, h = img.size
    if w <= 0 or h <= 0:
        return None
    resized = img.resize((fixed_width, max(int(fixed_width * h / w), 1)),
                         resample=Image.LANCZOS)
    buf = BytesIO()
    resized.save(buf, format="PNG")
    return "data:image/png;base64," + base64.b64encode(buf.getvalue()).decode("utf-8")


def pil_image_to_data_url(img: Any, fixed_width: int = 1024, fmt: str = "JPEG") -> str:
    """In-memory variant used by the experiment-02 path
    (reference 05_experiment02.py:142-152: JPEG at width 1024)."""
    from PIL import Image

    w, h = img.size
    resized = img.convert("RGB").resize(
        (fixed_width, max(int(fixed_width * h / w), 1)), resample=Image.LANCZOS
    )
    buf = BytesIO()
    resized.save(buf, format=fmt)
    mime = "jpeg" if fmt.upper() == "JPEG" else fmt.lower()
    return f"data:image/{mime};base64," + base64.b64encode(buf.getvalue()).decode("utf-8")


def build_choice_string(answers: List[str]) -> str:
    return "\n".join(
        f"{letter}. {option}" for letter, option in zip(["A", "B", "C", "D"], answers)
    )


def build_instruction_block(question: str, answers: List[str]) -> str:
    return (
        "You are an expert biomedical researcher. Carefully read the question and the answer choices.\n"
        f"Question: {question}\nChoices:\n{build_choice_string(answers)}\n"
        "If contextual snippets are provided, use them judiciously. "
        "Respond with a single capital letter (A, B, C, or D)."
    )


def build_reference_from_metadata(metadata: Dict[str, Any]) -> str:
    doc = metadata.get("document_name") or metadata.get("file_name") or "doc"
    page = metadata.get("page_no") or metadata.get("page_id")
    return f"{doc}_pg_{page}" if page is not None else doc


def document_to_context_entry(doc: Any, score: float) -> Dict[str, Any]:
    """Document -> neutral context entry {type,text,image_path,reference,score}."""
    metadata = getattr(doc, "metadata", None) or {}
    doc_type = metadata.get("type", "text")
    return {
        "type": "image" if doc_type in {"image", "pdf_page"} else "text",
        "text": doc.page_content if doc_type in {"text", "table"} else "",
        "image_path": metadata.get("img_link"),
        "reference": build_reference_from_metadata(metadata),
        "score": score,
    }


def image_context_messages(images: List[Any], fixed_width: int = 1024) -> List[Dict]:
    """Retrieved page images (PIL) -> message content parts
    (reference 05_experiment02.py:155-166)."""
    return [
        {"type": "image_url", "image_url": {"url": pil_image_to_data_url(im, fixed_width)}}
        for im in images
    ]
