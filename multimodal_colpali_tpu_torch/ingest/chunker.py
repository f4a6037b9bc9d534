"""Token-budget text chunker - the HybridChunker-equivalent.

The port's copy of ``multimodal_colpali_tpu/ingest/chunker.py``: the same code, numpy
and the standard library only.

The reference chunks converted documents with Docling's
``HybridChunker(tokenizer=vd_tokenizer)`` (functions.py:301): paragraphs are
packed into chunks not exceeding the embedding model's token budget, split
on sentence boundaries when a single paragraph overflows. This reproduces
that contract with any object exposing ``.encode(text) -> ids`` (an HF
tokenizer or the built-in SimpleTokenizer).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, List, Sequence


@dataclasses.dataclass
class Chunk:
    text: str
    page_no: int
    ref: str


class HybridChunker:
    def __init__(self, tokenizer: Any, max_tokens: int = 512):
        self.tokenizer = tokenizer
        self.max_tokens = max_tokens

    def _count(self, text: str) -> int:
        try:
            return len(self.tokenizer.encode(text, add_special_tokens=False))
        except TypeError:
            return len(self.tokenizer.encode(text))

    def _sentences(self, paragraph: str) -> List[str]:
        parts = re.split(r"(?<=[.!?])\s+", paragraph.strip())
        return [p for p in parts if p]

    def chunk_pages(self, pages: Sequence[str]) -> List[Chunk]:
        """Chunk per-page text; each chunk carries its page number and a
        ``#/texts/{i}`` ref mirroring the docling cref format
        (reference functions.py:306)."""
        chunks: List[Chunk] = []
        counter = 0
        for page_no, page_text in enumerate(pages, start=1):
            paragraphs = [p.strip() for p in re.split(r"\n\s*\n|\n", page_text) if p.strip()]
            buf: List[str] = []
            buf_tokens = 0

            def flush():
                nonlocal buf, buf_tokens, counter
                if buf:
                    chunks.append(Chunk(
                        text="\n".join(buf), page_no=page_no,
                        ref=f"#/texts/{counter}",
                    ))
                    counter += 1
                    buf, buf_tokens = [], 0

            for para in paragraphs:
                t = self._count(para)
                if t > self.max_tokens:
                    flush()
                    # split an oversized paragraph on sentences
                    cur: List[str] = []
                    cur_t = 0
                    for sent in self._sentences(para):
                        st = self._count(sent)
                        if cur and cur_t + st > self.max_tokens:
                            chunks.append(Chunk(" ".join(cur), page_no, f"#/texts/{counter}"))
                            counter += 1
                            cur, cur_t = [], 0
                        cur.append(sent)
                        cur_t += st
                    if cur:
                        chunks.append(Chunk(" ".join(cur), page_no, f"#/texts/{counter}"))
                        counter += 1
                    continue
                if buf and buf_tokens + t > self.max_tokens:
                    flush()
                buf.append(para)
                buf_tokens += t
            flush()
        return chunks
