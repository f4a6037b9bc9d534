"""Template-correlation OCR for scanned (image-only) PDF pages.

The port's copy of ``multimodal_colpali_tpu/ingest/ocr.py``: the same code, numpy
and the standard library only.

Fills the capability the reference gets from EasyOCR inside Docling
(reference functions.py:78-80, gated by ``check_ocr`` at
functions.py:133-148): when a PDF has no text layer, recover machine-printed
text from the page raster so text chunks still reach the text/multimodal
collections. Without this, a scanned PDF silently degrades text_RAG/mm_RAG
to nothing.

Design - classical matched-filter OCR for machine-rendered glyphs:

1. binarize the page raster;
2. segment lines by row-ink projection, characters by column-ink projection
   (with pitch-based splitting of touching glyphs - the renderer's cell is
   wider than its advance, so tall glyphs like T/X/V can touch);
3. classify every character patch against a glyph atlas in ONE batched
   correlation: ``[n_chars, cell_px] @ [cell_px, n_classes]`` - a matmul,
   the same math shape the device scoring path uses, kept host-side because
   ingestion is off the hot path and pages arrive one at a time.

The default atlas is the native rasterizer's own 8x13 bitmap font
(``rasterize.font_atlas``), upsampled with exactly the integer-index scheme
``mmpdf.cpp::draw_glyph`` uses - rendering and recognition share one font
resource, like a real OCR stack shares its training font bank. Custom
atlases (e.g. harvested from another font at the same cell geometry) can be
passed in.

The atlas carries distinct glyphs for uppercase, lowercase (x-height forms
with ascenders/descenders), and every digit, so recognition is case- and
digit-exact. Because lowercase lines start their ink at a different atlas
row than capitals (x-height row 4 vs cap row 1) and descenders extend to
row 12, line decoding hypothesizes (cell height, first-ink-row) layout
pairs and keeps the best-correlating one (``_layout_candidates``).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

# Geometry constants of the rendering model (mmpdf.cpp::show_text/draw_glyph):
# a glyph cell is ``S`` px tall and ``S * 8/13`` wide, the pen advance is
# ``S / 2``, ink starts at atlas row/col 1, and the typical letter occupies
# atlas rows 1..11 of 13.
_CELL_ROWS, _CELL_COLS = 13, 8
_INK_ROWS = 11.0


class TemplateOcr:
    """Glyph-atlas matched-filter recognizer. Callable as ``ocr_fn``."""

    def __init__(self, atlas: Optional[np.ndarray] = None,
                 charset: Optional[Sequence[str]] = None,
                 ink_threshold: int = 128, dpi: float = 144.0):
        if atlas is None:
            from multimodal_colpali_tpu_torch.ingest.rasterize import font_atlas

            atlas = font_atlas()
        self.atlas = np.asarray(atlas, bool)          # [n_glyphs, 13, 8]
        chars = charset or [chr(c) for c in range(32, 127)]
        if len(chars) != self.atlas.shape[0]:
            raise ValueError("charset length must match atlas glyph count")
        self.ink_threshold = ink_threshold
        self.dpi = dpi
        # Drop blank glyphs (space etc.) from the classifier; spacing is
        # recovered geometrically. Ambiguous duplicate glyphs keep only the
        # first (canonical) class so argmax output is deterministic.
        keys: Dict[bytes, int] = {}
        self._classes: List[int] = []
        for i in range(self.atlas.shape[0]):
            bitmap = self.atlas[i]
            if not bitmap.any():
                continue
            key = np.packbits(bitmap).tobytes()
            if key not in keys:
                keys[key] = i
                self._classes.append(i)
        self._chars = np.array([chars[i] for i in self._classes])
        self._template_cache: Dict[Tuple[int, int], np.ndarray] = {}
        # Widest left bearing in the atlas (in atlas columns): bounds the
        # grid-phase search when a line starts with a narrow glyph ('i',
        # 'l', '!' start their ink well inside the cell).
        self._max_left_bearing = max(
            int(np.flatnonzero(self.atlas[i].any(axis=0))[0])
            for i in self._classes)

    # -- rendering-model helpers -------------------------------------------

    def _templates(self, ih: int) -> np.ndarray:
        """Atlas glyphs upsampled to an ih-px full cell ([n, ih, cell_w])
        with draw_glyph's integer index map (srow = py*13//ih,
        scol = px*8//iw)."""
        if ih not in self._template_cache:
            full_w = max(int(round(ih * _CELL_COLS / _CELL_ROWS)), 3)
            rows = np.arange(ih) * _CELL_ROWS // ih
            cols = np.arange(full_w) * _CELL_COLS // full_w
            t = self.atlas[self._classes][:, rows][:, :, cols]
            self._template_cache[ih] = t.astype(np.float32)
        return self._template_cache[ih]

    @staticmethod
    def _spans(mask: np.ndarray, min_gap: int = 1) -> List[Tuple[int, int]]:
        """Contiguous True runs of a 1-D mask -> [(start, end_inclusive)]."""
        idx = np.flatnonzero(mask)
        if idx.size == 0:
            return []
        breaks = np.flatnonzero(np.diff(idx) > min_gap)
        starts = np.concatenate([[idx[0]], idx[breaks + 1]])
        ends = np.concatenate([idx[breaks], [idx[-1]]])
        return list(zip(starts.tolist(), ends.tolist()))

    # -- recognition ---------------------------------------------------------

    @staticmethod
    def _drawn_height(ih: int, row0: int = 1, row1: int = 11) -> int:
        """Ink rows painted in an ih-px cell by glyphs spanning atlas rows
        ``row0..row1``, per draw_glyph's ``srow = py*13//ih`` truncation."""
        import math

        return (math.ceil((row1 + 1) * ih / _CELL_ROWS)
                - math.ceil(row0 * ih / _CELL_ROWS))

    # A text line's ink span depends on which atlas rows its glyphs occupy:
    # capitals/ascenders start at row 1, x-height lowercase at row 4, digits
    # at row 2; descenders (g j p q y) reach row 12. Each family inverts the
    # observed ink height to a different cell height AND a different top
    # offset, so hypotheses are (cell_height, first_ink_row) pairs.
    # (2, 12): digit tops (row 2) or merged i/j dots through descenders
    # (row 12) with no ascender present - e.g. "juju 9", "go 42 jumps".
    _ROW_FAMILIES = ((1, 11), (1, 12), (4, 11), (4, 12), (2, 11), (2, 10),
                     (2, 12))

    def _layout_candidates(self, h: int) -> List[Tuple[int, int]]:
        """(cell height, first atlas ink row) hypotheses whose drawn ink
        height inverts to ``h`` (exact truncation inversions plus the
        continuous-estimate neighbors)."""
        out = set()
        for row0, row1 in self._ROW_FAMILIES:
            span = row1 + 1 - row0
            base = int(round(h * _CELL_ROWS / span))
            cands = {ih for ih in range(max(base - 2, 4), base + 3)
                     if self._drawn_height(ih, row0, row1) == h}
            cands |= {base - 1, base, base + 1}
            out |= {(ih, row0) for ih in cands if ih >= 4}
        return sorted(out)

    def _decode_grid(self, ink: np.ndarray, top: int, ih: int, iw: int,
                     p0: int, pitch: float, n_cells: int) -> Tuple[float, str]:
        """Classify the cells of one grid hypothesis -> (mean IoU, text).

        Sequential left-to-right decode with exact bleed cancellation: the
        glyph cell (S*8/13) is wider than the advance (S/2), so a glyph's
        right edge overflows into the next cell's window. Rendering is
        deterministic, so after classifying cell k the classified template's
        overflow pixels are erased from cell k+1's patch before scoring -
        without this, a trailing edge turns spaces into ghost characters and
        biases round glyphs ('O') toward left-heavy ones ('D')."""
        templates = self._templates(ih)            # [C, ih, cell_w]
        cell_w = templates.shape[2]
        tmpl_win = templates[:, :, :iw].reshape(len(self._classes), -1)
        nb = tmpl_win.sum(axis=1)[None, :]
        ink_thresh = max(3.0, ih / 5.0)

        scores_kept: List[float] = []
        chars: List[str] = []
        carry = np.zeros((ih, iw), np.float32)     # bleed from cell k-1
        for k in range(n_cells):
            left = p0 + int(round(k * pitch))
            cell = np.zeros((ih, iw), np.float32)
            ys0, xs0 = max(top, 0), max(left, 0)
            ys1 = min(top + ih, ink.shape[0])
            xs1 = min(left + iw, ink.shape[1])
            if ys1 > ys0 and xs1 > xs0:
                cell[ys0 - top: ys1 - top, xs0 - left: xs1 - left] = \
                    ink[ys0:ys1, xs0:xs1]
            cell = np.maximum(cell - carry, 0.0)
            carry[:] = 0.0

            patch = cell.reshape(-1)
            na = patch.sum()
            if na < ink_thresh:
                chars.append(" ")
                continue
            inter = patch @ tmpl_win.T
            iou = inter / np.maximum(na + nb[0] - inter, 1.0)
            best = int(iou.argmax())
            if iou[best] < 0.2:                    # unmatchable junk
                chars.append(" ")
                continue
            chars.append(str(self._chars[best]))
            scores_kept.append(float(iou[best]))
            # overflow of the classified glyph into the next window
            step = int(round((k + 1) * pitch)) - int(round(k * pitch))
            if step < cell_w:
                over = templates[best, :, step:]
                carry[:, : over.shape[1]] = over
        if not scores_kept:
            return 0.0, ""
        return float(np.mean(scores_kept)), "".join(chars).rstrip()

    def _read_line(self, ink: np.ndarray, y0: int, y1: int, ih: int,
                   row0: int = 1) -> Tuple[float, str]:
        """Decode one line at layout hypothesis (cell height ``ih``, first
        ink at atlas row ``row0``) -> (mean IoU of the best grid phase,
        text).

        The renderer is monospace (advance = S/2 regardless of glyph), so
        instead of segmenting touching glyphs apart - impossible when wide
        glyphs like 'T' overlap the next cell - the line is decoded on the
        pitch grid directly. The grid phase is ambiguous by the first
        glyph's in-cell ink offset (0 up to the atlas's widest left bearing
        - e.g. 'i'/'l' start at atlas col 3), so every physical phase is
        decoded and the best mean IoU wins.
        """
        import math

        pitch = ih / 2.0                       # renderer advance = S/2
        # Compare on the advance window plus one column, not the full cell
        # (S*8/13): wider would swallow the next glyph's left edge.
        iw = min(max(int(math.ceil(pitch)) + 1, 3),
                 max(int(round(ih * _CELL_COLS / _CELL_ROWS)), 3))
        pad = math.ceil(row0 * ih / _CELL_ROWS)  # first-ink-row offset
        top = y0 - pad
        cols = np.flatnonzero(ink[y0:y1 + 1].any(axis=0))
        if cols.size == 0:
            return 0.0, ""
        x_min, x_max = int(cols[0]), int(cols[-1])

        best: Tuple[float, str] = (0.0, "")
        max_phase = (self._max_left_bearing + 0.5) * ih / _CELL_ROWS
        for d in range(int(math.ceil(max_phase)) + 1):
            p0 = x_min - d
            n_cells = int((x_max - p0) // pitch) + 1
            got = self._decode_grid(ink, top, ih, iw, p0, pitch, n_cells)
            if got[0] > best[0]:
                best = got
        return best

    # Scanned pages carry speckle noise; a text row must have at least this
    # much ink to count, and implausible line heights are skipped (an
    # unbounded "line" over a noisy page would blow up hypothesis search).
    MIN_ROW_INK = 3
    MAX_LINE_HEIGHT = 300

    def recognize(self, image, return_score: bool = False):
        """Page raster (PIL image or [H, W, 3]/[H, W] uint8) -> text.

        ``return_score=True`` also returns the mean per-line best IoU -
        ~0.9 when the page is rendered from this atlas's font, well below
        that on any other font (AutoOcr's dialect-detection signal)."""
        arr = np.asarray(image)
        if arr.ndim == 3:
            arr = arr.mean(axis=-1)
        ink = arr < self.ink_threshold
        # Despeckle: kill isolated ink pixels (no 4-neighbor ink) - cheap
        # morphological opening that preserves glyph strokes.
        n4 = np.zeros_like(ink)
        n4[1:, :] |= ink[:-1, :]
        n4[:-1, :] |= ink[1:, :]
        n4[:, 1:] |= ink[:, :-1]
        n4[:, :-1] |= ink[:, 1:]
        ink = ink & n4

        # Merge detached-dot spans: the i/j dot sits at atlas row 2 with
        # row 3 empty, so the row-ink projection splits an all-lowercase
        # line into a thin dot span floating just above the body span.
        # A span at most a quarter the height of its neighbor, separated
        # by at most a quarter-height gap, is part of the same line - real
        # adjacent text lines have comparable heights and larger gaps.
        raw = self._spans(ink.sum(axis=1) >= self.MIN_ROW_INK)
        spans: List[Tuple[int, int]] = []
        for s in raw:
            if spans:
                p0, p1 = spans[-1]
                gap = s[0] - p1 - 1
                h_prev, h_cur = p1 - p0 + 1, s[1] - s[0] + 1
                small, big = min(h_prev, h_cur), max(h_prev, h_cur)
                if small <= max(2, big // 4) and gap <= max(2, big // 4):
                    spans[-1] = (p0, s[1])
                    continue
            spans.append(s)

        lines: List[str] = []
        line_scores: List[float] = []
        for y0, y1 in spans:
            if y1 - y0 + 1 > self.MAX_LINE_HEIGHT:
                continue  # not machine-printed text at a sane size
            # The glyph cell height and vertical alignment are ambiguous
            # from ink height alone (integer truncation, case mix,
            # descenders); decode under each layout hypothesis and keep the
            # one with the best mean correlation.
            decoded = [self._read_line(ink, y0, y1, ih, row0)
                       for ih, row0 in self._layout_candidates(y1 - y0 + 1)]
            if decoded:
                score, text = max(decoded, key=lambda t: t[0])
                if text:
                    lines.append(text)
                    line_scores.append(score)
        text = "\n".join(lines)
        if return_score:
            return text, (float(np.mean(line_scores)) if line_scores else 0.0)
        return text

    def __call__(self, pdf_path: str) -> List[str]:
        """``ocr_fn`` surface for pdf_loader: PDF path -> per-page texts."""
        from multimodal_colpali_tpu_torch.ingest.rasterize import PdfDocument

        doc = PdfDocument(pdf_path)
        return [self.recognize(np.asarray(doc.render(i, dpi=self.dpi)))
                for i in range(len(doc))]


def ocr_pdf(pdf_path: str, dpi: float = 144.0) -> List[str]:
    """One-shot helper: per-page OCR texts with the default atlas."""
    return TemplateOcr(dpi=dpi)(pdf_path)
