"""Table-structure extraction from the PDF text layout.

The port's copy of ``multimodal_colpali_tpu/ingest/tables.py``: the same code, numpy
and the standard library only.

Fills the capability the reference gets from Docling's TableFormer model
(reference functions.py:85-93, ACCURATE mode): ``data_preparation`` there
emits ``type=table`` documents whose content is the table as markdown with
the caption prepended (functions.py:344-357). Without a table stage, table
content silently vanishes from the text/multimodal collections.

Structure is recovered from the native rasterizer's positioned text runs
(``PdfDocument.extract_runs``) plus, when available, its ruled lines
(``PdfDocument.extract_rules``). Two detection passes:

1. **Ruled regions** (the borderless/irregular-table signal TableFormer
   ACCURATE owns in the reference): >=2 horizontal rules sharing an
   x-extent bound a region whose rows form a table even when cell
   alignment is ragged; vertical rules inside the region directly define
   the column separators.
2. **Aligned grids**: maximal blocks of consecutive rows whose x-interval
   projection yields >= 2 column bands. Bands come from a row-coverage
   histogram with a small crossing allowance, so

   - a header cell SPANNING several columns doesn't bridge the gutters
     (its text lands in the first column it covers - markdown has no
     colspan);
   - right-aligned / centered (irregular) columns align by interval
     overlap, not by shared x starts;
   - a short continuation row whose runs sit inside single bands is a
     MULTI-LINE CELL and merges into the row above;
   - flowing two-column body text is rejected by table-ness guards
     (median cell length, words per cell) - reading order owns page
     columns (native/src/mmpdf.cpp ReadingOrder), this module owns grids.

A learned layout model can replace this behind the same surface; the
document schema is already exact (documents.py).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

Run = Tuple[float, float, float, str]   # (x, y, font size, text)
Rule = Tuple[float, float, float, float]  # (x0, y0, x1, y1), y-down


@dataclasses.dataclass
class DetectedTable:
    """One table: cell grid plus the layout info needed downstream."""

    cells: List[List[str]]          # [n_rows][n_cols], "" for missing
    bbox: Tuple[float, float, float, float]  # x0, y0, x1, y1 (page units)
    caption: str = ""

    def to_markdown(self) -> str:
        """Pipe-table markdown, header = first row (the reference exports
        pandas ``to_markdown`` of the TableFormer dataframe; same shape)."""
        if not self.cells:
            return ""
        widths = [max(len(r[c]) for r in self.cells)
                  for c in range(len(self.cells[0]))]

        def fmt(row: Sequence[str]) -> str:
            return "| " + " | ".join(c.ljust(w) for c, w in zip(row, widths)) + " |"

        lines = [fmt(self.cells[0]),
                 "|" + "|".join("-" * (w + 2) for w in widths) + "|"]
        lines += [fmt(r) for r in self.cells[1:]]
        return "\n".join(lines)


def _x_end(run: Run) -> float:
    """Estimated advance end (0.5 em per char, the mmpdf model)."""
    x, _, size, text = run
    return x + len(text) * 0.5 * size


def _cluster_rows(runs: Sequence[Run]) -> List[List[Run]]:
    """Group runs into visual rows by y; rows sorted top-down, cells by x."""
    rows: List[List[Run]] = []
    for run in sorted(runs, key=lambda r: (r[1], r[0])):
        tol = max(run[2], 4.0) * 0.4
        if rows and abs(rows[-1][0][1] - run[1]) <= tol:
            rows[-1].append(run)
        else:
            rows.append([run])
    return rows


def _median(vals: Sequence[float], default: float = 0.0) -> float:
    if not vals:
        return default
    s = sorted(vals)
    return s[len(s) // 2]


def _column_bands(block: Sequence[Sequence[Run]], ms: float,
                  x_tol: float) -> List[Tuple[float, float]]:
    """Column bands from the row-coverage histogram of the block's run
    intervals. A bin is a gutter when FEW rows cover it (a spanning cell
    may cross); sub-threshold gutters (intra-cell word spaces) merge."""
    allruns = [r for row in block for r in row]
    if not allruns:
        return []
    x0 = min(r[0] for r in allruns)
    x1 = max(_x_end(r) for r in allruns)
    binw = max(0.25 * ms, 1.0)
    nb = int((x1 - x0) / binw) + 1
    cov = [0] * nb
    for row in block:
        seen = [False] * nb
        for r in row:
            b0 = max(0, int((r[0] - x0) / binw))
            b1 = min(nb - 1, int((_x_end(r) - x0) / binw))
            for b in range(b0, b1 + 1):
                seen[b] = True
        for b, s in enumerate(seen):
            if s:
                cov[b] += 1
    cross_allow = max(1, len(block) // 3)
    gap_min = max(x_tol, 0.5 * ms)
    bands: List[Tuple[float, float]] = []
    b = 0
    while b < nb:
        if cov[b] <= cross_allow:
            b += 1
            continue
        e = b
        while e < nb and cov[e] > cross_allow:
            e += 1
        lo, hi = x0 + b * binw, x0 + e * binw
        # merge across sub-gutter gaps (word spaces inside a cell)
        if bands and lo - bands[-1][1] < gap_min:
            bands[-1] = (bands[-1][0], hi)
        else:
            bands.append((lo, hi))
        b = e
    return bands


def _band_of(run: Run, bands: Sequence[Tuple[float, float]],
             tol: float) -> Tuple[int, int]:
    """(first, last) band index the run overlaps; (-1, -1) if none."""
    rx0, rx1 = run[0], _x_end(run)
    first = last = -1
    for c, (b0, b1) in enumerate(bands):
        if rx1 > b0 - tol and rx0 < b1 + tol:
            if first < 0:
                first = c
            last = c
    return first, last


def _block_extent(block: Sequence[Sequence[Run]]) -> Tuple[float, float]:
    xs0 = [r[0] for row in block for r in row]
    xs1 = [_x_end(r) for row in block for r in row]
    return min(xs0), max(xs1)


def _looks_like_text(block: Sequence[Sequence[Run]],
                     bands: Sequence[Tuple[float, float]],
                     x_tol: float) -> bool:
    """Flowing (multi-column) body text, not a table: long cells, or many
    word-runs per cell (OCR layouts emit one run per word)."""
    cell_chars: List[int] = []
    cell_runs: List[int] = []
    for row in block:
        per_band: dict = {}
        for r in row:
            c, _ = _band_of(r, bands, x_tol)
            per_band.setdefault(c, []).append(r)
        for rs in per_band.values():
            cell_chars.append(sum(len(r[3]) for r in rs) + len(rs) - 1)
            cell_runs.append(len(rs))
    if not cell_chars:
        return True
    if _median([float(c) for c in cell_chars]) > 18:
        return True
    if sum(cell_runs) / len(cell_runs) > 2.5:
        return True
    return False


def _build_cells(block: Sequence[Sequence[Run]],
                 continuation: Sequence[bool],
                 bands: Sequence[Tuple[float, float]],
                 x_tol: float) -> List[List[str]]:
    """Assign runs to (row, column) cells. Spanning runs land in the first
    band they cover; continuation rows merge into the row above."""
    cells: List[List[str]] = []
    for row, is_cont in zip(block, continuation):
        if not is_cont or not cells:
            cells.append([""] * len(bands))
        line = cells[-1]
        for r in sorted(row, key=lambda q: q[0]):
            c, _ = _band_of(r, bands, x_tol)
            if c < 0:
                c = 0
            line[c] = (line[c] + " " + r[3]).strip()
    return cells


def _bbox_of(block: Sequence[Sequence[Run]]) -> Tuple[float, float, float, float]:
    ys = [r[1] for row in block for r in row]
    sz = max(block[-1][0][2], 4.0)
    x0, x1 = _block_extent(block)
    return (x0, min(ys) - sz, x1, max(ys) + sz * 0.4)


def _detect_ruled(rows: List[List[Run]], rules: Sequence[Rule],
                  min_rows: int, min_cols: int, x_tol: float,
                  consumed: List[bool]) -> List[DetectedTable]:
    """Pass 1: regions bounded by >=2 horizontal rules sharing an x-extent
    are tables even when alignment is ragged (the TableFormer ACCURATE
    role for borderless/irregular tables, reference functions.py:85-93)."""
    hr = [r for r in rules if abs(r[3] - r[1]) <= 1.5
          and abs(r[2] - r[0]) >= 24.0]
    vr = [r for r in rules if abs(r[2] - r[0]) <= 1.5
          and abs(r[3] - r[1]) >= 8.0]
    # group horizontal rules by x-extent (within 10% of their length)
    groups: List[List[Rule]] = []
    for r in sorted(hr, key=lambda q: q[1]):
        tol = 0.1 * max(abs(r[2] - r[0]), 1.0) + x_tol
        for g in groups:
            if abs(g[0][0] - r[0]) <= tol and abs(g[0][2] - r[2]) <= tol:
                g.append(r)
                break
        else:
            groups.append([r])
    tables: List[DetectedTable] = []
    for g in groups:
        ys = sorted(q[1] for q in g)
        if len(ys) < 2 or ys[-1] - ys[0] < 4.0:
            continue
        gx0, gx1 = min(q[0] for q in g), max(q[2] for q in g)
        ytop, ybot = ys[0], ys[-1]
        members = [
            k for k, row in enumerate(rows)
            if not consumed[k]
            and all(ytop - 1.0 < r[1] < ybot + 1.0 for r in row)
            and all(r[0] >= gx0 - 2 * x_tol and _x_end(r) <= gx1 + 2 * x_tol
                    for r in row)
        ]
        if len(members) < min_rows:
            continue
        block = [rows[k] for k in members]
        ms = max(_median([r[2] for row in block for r in row], 10.0), 4.0)
        inner_v = sorted(q[0] for q in vr
                         if gx0 - x_tol < q[0] < gx1 + x_tol
                         and q[1] < ybot and q[3] > ytop)
        if inner_v:
            edges = [gx0] + [x for x in inner_v
                             if gx0 + x_tol < x < gx1 - x_tol] + [gx1]
            bands = [(edges[i], edges[i + 1]) for i in range(len(edges) - 1)]
        else:
            bands = _column_bands(block, ms, x_tol)
        if len(bands) < min_cols:
            continue
        continuation = [len(row) < min_cols for row in block]
        if continuation[0]:
            continuation[0] = False
        cells = _build_cells(block, continuation, bands, x_tol)
        if len(cells) < min_rows:
            continue
        for k in members:
            consumed[k] = True
        caption = _find_caption(rows, members[0], members[-1] + 1, ms)
        x0, y0, x1, y1 = _bbox_of(block)
        bbox = (min(x0, gx0), min(y0, ytop - 1), max(x1, gx1), max(y1, ybot + 1))
        tables.append(DetectedTable(cells=cells, bbox=bbox, caption=caption))
    return tables


def detect_tables(runs: Sequence[Run], min_rows: int = 2,
                  min_cols: int = 2, x_tol: float = 3.0,
                  rules: Optional[Sequence[Rule]] = None) -> List[DetectedTable]:
    """Find table blocks among a page's text runs (+ optional ruled lines)."""
    rows = _cluster_rows(runs)
    consumed = [False] * len(rows)
    tables: List[DetectedTable] = []
    if rules:
        tables += _detect_ruled(rows, rules, min_rows, min_cols, x_tol,
                                consumed)

    def _is_caption_row(row: Sequence[Run]) -> bool:
        text = " ".join(r[3] for r in sorted(row, key=lambda q: q[0]))
        return text.strip().lower().startswith("table")

    i = 0
    while i < len(rows):
        if consumed[i] or len(rows[i]) < min_cols or _is_caption_row(rows[i]):
            i += 1
            continue
        ms = max(rows[i][0][2], 4.0)
        block = [rows[i]]
        continuation = [False]
        bands = _column_bands(block, ms, x_tol)
        j = i + 1
        while j < len(rows) and not consumed[j]:
            # rows must be vertically adjacent (same table, not two tables)
            size = max(block[-1][0][2], 4.0)
            if rows[j][0][1] - block[-1][0][1] > 3.0 * size:
                break
            if _is_caption_row(rows[j]):
                break
            if len(rows[j]) >= min_cols:
                cand = block + [rows[j]]
                cand_bands = _column_bands(cand, ms, x_tol)
                bx0, bx1 = _block_extent(cand)
                inside = all(r[0] >= bx0 - x_tol and _x_end(r) <= bx1 + x_tol
                             for r in rows[j])
                if len(cand_bands) >= min_cols and inside:
                    block = cand
                    continuation.append(False)
                    bands = cand_bands
                    j += 1
                    continue
                break
            # short row: a multi-line-cell continuation iff every run sits
            # inside ONE existing column band (a paragraph line below the
            # table spans several bands and must terminate the block)
            if len(bands) >= min_cols and all(
                (lambda fc, lc: fc >= 0 and fc == lc)(
                    *_band_of(r, bands, x_tol)) for r in rows[j]):
                block = block + [rows[j]]
                continuation.append(True)
                j += 1
                continue
            break
        core_rows = sum(1 for c in continuation if not c)
        if core_rows >= min_rows and len(bands) >= min_cols \
                and not _looks_like_text(block, bands, x_tol):
            cells = _build_cells(block, continuation, bands, x_tol)
            caption = _find_caption(rows, i, j, max(block[-1][0][2], 4.0))
            tables.append(DetectedTable(cells=cells, bbox=_bbox_of(block),
                                        caption=caption))
            i = j
        else:
            i += 1
    tables.sort(key=lambda t: t.bbox[1])
    return tables


def _find_caption(rows: List[List[Run]], start: int, end: int,
                  size: float) -> str:
    """Nearest neighbor row starting with 'table'. The row's runs are
    joined left-to-right: native text layers carry whole-line runs, but
    OCR-recovered layouts (scanned pages) emit one run per word."""
    for idx in (start - 1, end):
        if 0 <= idx < len(rows):
            text = " ".join(r[3] for r in sorted(rows[idx],
                                                 key=lambda r: r[0])).strip()
            if text.lower().startswith("table"):
                return text
    return ""
