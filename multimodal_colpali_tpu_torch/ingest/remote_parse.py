"""Remote document-parse service client (docling-serve seam; counterpart of
``multimodal_colpali_tpu/ingest/remote_parse.py``).

The reference can offload PDF conversion to a docling-serve HTTP endpoint
with a 10-retry loop (``conv_docs1``/``pdf_loader1``,
functions.py:1357-1449). This keeps that seam: POST the PDF to a conversion
service, retry on failure, fall back to the native local parser when no
endpoint is configured or retries are exhausted.

The JAX module posts with httpx; this one with the standard library's
``urllib`` and a multipart body built by hand (one ``file`` part, as httpx
sends it), so the port needs no HTTP package.
"""

from __future__ import annotations

import http.client
import json
import os
import time
import urllib.request
from typing import Any, Dict, List, Optional, Sequence, Tuple

from multimodal_colpali_tpu_torch.documents import Document
from multimodal_colpali_tpu_torch.ingest.pdf_loader import data_preparation
from multimodal_colpali_tpu_torch.ingest.rasterize import PdfDocument


# HTML5 form encoding of a quoted parameter, as httpx writes it: quote and
# backslash escaped, control characters (but ESC) percent-encoded
_FORM_ESCAPES = {'"': "%22", "\\": "\\\\",
                 **{chr(c): f"%{c:02X}" for c in range(0x20) if c != 0x1B}}


def multipart_file(field: str, filename: str, content: bytes,
                   content_type: str) -> Tuple[bytes, str]:
    """A ``multipart/form-data`` body holding one file -> (body, the
    Content-Type header with its boundary)."""
    boundary = os.urandom(16).hex()
    quoted = "".join(_FORM_ESCAPES.get(ch, ch) for ch in filename)
    head = (f"--{boundary}\r\n"
            f'Content-Disposition: form-data; name="{field}"; filename="{quoted}"\r\n'
            f"Content-Type: {content_type}\r\n\r\n").encode()
    body = head + content + f"\r\n--{boundary}--\r\n".encode()
    return body, f"multipart/form-data; boundary={boundary}"


def _post_pdf(url: str, fname: str, content: bytes, timeout: float) -> Dict[str, Any]:
    body, ctype = multipart_file("file", fname, content, "application/pdf")
    req = urllib.request.Request(url, data=body, method="POST",
                                 headers={"Content-Type": ctype})
    with urllib.request.urlopen(req, timeout=timeout) as r:   # raises on 4xx/5xx
        return json.loads(r.read())


def conv_docs1(
    papers: Sequence[str],
    filenames: Sequence[str],
    doi_links: Sequence[str],
    service_url: Optional[str] = None,
    retries: int = 10,
    backoff: float = 2.0,
) -> List[Dict[str, Any]]:
    """Convert PDFs via the remote service; native fallback per document.

    Remote protocol: POST /v1/convert with the file; response JSON carries
    ``pages: [{text: str}]`` (the subset of docling-serve's output the
    pipeline consumes). Each entry returned matches the local ``conversion``
    record shape consumed by data_preparation.
    """
    out = []
    for paper, fname, link in zip(papers, filenames, doi_links):
        remote_pages: Optional[List[str]] = None
        if service_url:
            for attempt in range(retries):
                try:
                    with open(paper, "rb") as f:
                        content = f.read()
                    reply = _post_pdf(service_url.rstrip("/") + "/v1/convert", fname,
                                      content, timeout=300)
                    remote_pages = [p.get("text", "") for p in reply.get("pages", [])]
                    break
                except (OSError, http.client.HTTPException, ValueError) as e:
                    print(f"remote convert attempt {attempt + 1}/{retries} failed: {e}")
                    time.sleep(backoff)
        doc = PdfDocument(paper)
        if remote_pages is not None:
            doc = _TextOverrideDocument(doc, remote_pages)
        out.append({"filename": fname, "link": link, "document": doc})
    return out


class _TextOverrideDocument:
    """PdfDocument wrapper whose text layer comes from the remote service
    (rasters stay native)."""

    def __init__(self, doc: PdfDocument, pages_text: List[str]):
        self._doc = doc
        self._pages_text = pages_text
        self.name = doc.name

    def __len__(self):
        return len(self._doc)

    def render(self, *a, **k):
        return self._doc.render(*a, **k)

    def page_size(self, *a, **k):
        return self._doc.page_size(*a, **k)

    def extract_text(self, index: int) -> str:
        if index < len(self._pages_text):
            return self._pages_text[index]
        return self._doc.extract_text(index)

    def has_text(self, index: int = 0) -> bool:
        return len(self.extract_text(index).strip()) > 0


def pdf_loader1(
    papers: Sequence[str],
    doi_links: Sequence[str],
    filenames: Sequence[str],
    vd_dir: str,
    vd_tokenizer,
    service_url: Optional[str] = None,
    device: Any = "cuda",
) -> Tuple[List[Document], List[Document]]:
    """Remote-parse variant of pdf_loader (reference functions.py:1432-1449);
    page rasters are resized on ``device``."""
    conversion = conv_docs1(papers, filenames, doi_links, service_url=service_url)
    docs_multi = data_preparation(conversion, vd_dir, vd_tokenizer, device=device)
    docs_text = data_preparation(conversion, vd_dir, vd_tokenizer,
                                 only_text=True, page_images=False, device=device)
    return docs_multi, docs_text
