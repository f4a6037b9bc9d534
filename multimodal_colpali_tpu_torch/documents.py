"""Document model for the ingestion/indexing layers (a copy of
``multimodal_colpali_tpu/documents.py``, which the port cannot import
without importing JAX).

The reference uses ``langchain_core.documents.Document`` with the metadata
schema assembled in ``data_preparation`` (reference functions.py:311-323,
344-357, 380-393):

    {document_name, document_id, document_link, type in {text, table, image,
     pdf_page}, page_no, ref, caption, img_link}

langchain is not a dependency here; this is a minimal, schema-compatible
stand-in that round-trips to plain dicts (for payload storage in the vector
store) and is hashable enough for test fixtures.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional


METADATA_KEYS = (
    "document_name",
    "document_id",
    "document_link",
    "type",
    "page_no",
    "ref",
    "caption",
    "img_link",
)

DOC_TYPES = ("text", "table", "image", "pdf_page")


@dataclasses.dataclass
class Document:
    """A chunk of a source document plus its retrieval metadata."""

    page_content: str
    metadata: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def to_dict(self) -> Dict[str, Any]:
        return {"page_content": self.page_content, "metadata": dict(self.metadata)}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Document":
        return cls(page_content=d["page_content"], metadata=dict(d.get("metadata", {})))

    def copy(self) -> "Document":
        return Document(self.page_content, dict(self.metadata))


def make_metadata(
    document_name: str,
    document_id: str,
    document_link: str = "",
    type: str = "text",
    page_no: int = 1,
    ref: str = "",
    caption: str = "",
    img_link: str = "",
) -> Dict[str, Any]:
    """Build a metadata dict with the reference schema, validating ``type``."""
    if type not in DOC_TYPES:
        raise ValueError(f"type must be one of {DOC_TYPES}, got {type!r}")
    return {
        "document_name": document_name,
        "document_id": document_id,
        "document_link": document_link,
        "type": type,
        "page_no": int(page_no),
        "ref": ref,
        "caption": caption,
        "img_link": img_link,
    }


def validate_metadata(metadata: Dict[str, Any]) -> Optional[str]:
    """Return an error string if ``metadata`` violates the schema, else None."""
    missing = [k for k in METADATA_KEYS if k not in metadata]
    if missing:
        return f"missing metadata keys: {missing}"
    if metadata["type"] not in DOC_TYPES:
        return f"bad type {metadata['type']!r}"
    return None
