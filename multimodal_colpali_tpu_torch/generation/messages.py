"""OpenAI-format multimodal message formatters (a copy of
``multimodal_colpali_tpu/generation/messages.py``).

Behavior parity with reference functions.py:450-453 (encode_image),
471-488 (format_msgs), 715-763 (encode_image_to_data_url,
build_choice_string, build_instruction_block, build_reference_from_metadata,
document_to_context_entry) and 05_experiment02.py:142-166 (the page images'
JPEG data URLs). The JAX module does its image work with Pillow; this one
needs no Pillow: files decode through ``imageops.decode_image`` (PNG, and
JPEG through the port's decoder), images resize with ``imageops.resize``
(Pillow's LANCZOS pixels; a CUDA tensor on its device), PNGs encode with
``imageops.encode_png`` (Pillow's pixels, not its bytes: every row
Up-filtered) and JPEGs with ``rasterize.encode_jpeg`` (Pillow's bytes at its
defaults). PIL images are still accepted, read through their own
``convert("RGB")``.
"""

from __future__ import annotations

import base64
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from multimodal_colpali_tpu_torch.ingest.imageops import decode_image, encode_png, resize


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


def _to_width(img: Any, fixed_width: int) -> np.ndarray:
    """A PIL image, uint8 ``[H, W, 3]`` array or tensor -> its LANCZOS resize
    to ``fixed_width`` (height ``max(int(fixed_width * h / w), 1)``) as a host
    array."""
    if not isinstance(img, (np.ndarray, torch.Tensor)) and hasattr(img, "convert"):
        img = np.asarray(img.convert("RGB"))
    h, w = int(img.shape[0]), int(img.shape[1])
    out = resize(img, (fixed_width, max(int(fixed_width * h / w), 1)), "lanczos")
    return out.cpu().numpy() if isinstance(out, torch.Tensor) else out


def _data_url(rgb: np.ndarray, fmt: str) -> str:
    if fmt.upper() == "JPEG":
        from multimodal_colpali_tpu_torch.ingest.rasterize import encode_jpeg

        data, mime = encode_jpeg(rgb), "jpeg"
    elif fmt.upper() == "PNG":
        data, mime = encode_png(rgb), "png"
    else:
        raise ValueError(f"data URLs are JPEG or PNG, not {fmt!r}")
    return f"data:image/{mime};base64," + base64.b64encode(data).decode("utf-8")


def encode_image_to_data_url(image_path: str, fixed_width: int = 1024,
                             device: Any = None) -> Optional[str]:
    """An image file resized to ``fixed_width`` (LANCZOS) -> a PNG data URL,
    or None where the file does not read or decode. With a CUDA ``device``
    the resize runs there (the same pixels as the host's)."""
    try:
        with open(image_path, "rb") as f:
            rgb = decode_image(f.read())
    except OSError:
        return None
    if rgb is None or 0 in rgb.shape[:2]:
        return None
    if device is not None and torch.device(device).type == "cuda":
        rgb = torch.from_numpy(rgb).to(device)
    return _data_url(_to_width(rgb, fixed_width), "PNG")


def pil_image_to_data_url(img: Any, fixed_width: int = 1024, fmt: str = "JPEG") -> str:
    """An in-memory page (PIL image, uint8 array or tensor) -> a data URL at
    ``fixed_width``, JPEG by default (reference 05_experiment02.py:142-152)."""
    return _data_url(_to_width(img, fixed_width), fmt)


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
    """Retrieved page images (PIL, arrays or tensors) -> message content parts
    (reference 05_experiment02.py:155-166)."""
    return [
        {"type": "image_url", "image_url": {"url": pil_image_to_data_url(im, fixed_width)}}
        for im in images
    ]
