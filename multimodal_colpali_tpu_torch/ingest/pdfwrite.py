"""Tiny PDF writer - test fixture generator for the native rasterizer.

The port's copy of ``multimodal_colpali_tpu/ingest/pdfwrite.py``, numpy and the
standard library only, with one addition: ``PdfWriter`` also embeds a JPEG
(bytes, written with the DCTDecode filter), such as
``ingest/rasterize.encode_jpeg`` makes, so that PDFs with JPEG figures are
written where Pillow is missing.

Produces valid classic-xref PDFs with Helvetica text lines and optional
embedded FlateDecode RGB or DCTDecode images, exercising the exact subset
``native/src/mmpdf.cpp`` implements. Used by tests and by the synthetic
corpus generator in bench.py; not a user-facing component.
"""

from __future__ import annotations

import zlib
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np


def _esc(s: str) -> str:
    return s.replace("\\", r"\\").replace("(", r"\(").replace(")", r"\)")


class PdfWriter:
    def __init__(self, width: float = 612, height: float = 792):
        self.width = width
        self.height = height
        self.pages: List[dict] = []

    def add_page(
        self,
        text_lines: Optional[Sequence[str]] = None,
        image: Optional[Union[np.ndarray, bytes]] = None,   # [H, W, 3] uint8 or a JPEG
        image_rect: Tuple[float, float, float, float] = (100, 400, 300, 200),
        font_size: float = 12,
        start_y: Optional[float] = None,
        runs: Optional[Sequence[Tuple[float, float, str]]] = None,
        lines: Optional[Sequence[Tuple[float, float, float, float]]] = None,
    ) -> None:
        """``runs``: positioned text as (x, y-from-bottom, text) triples -
        each becomes its own BT/Td/Tj block (for table-layout fixtures).
        ``lines``: stroked segments (x0, y0, x1, y1, y-from-bottom) - ruled
        borders for table fixtures."""
        self.pages.append({
            "text": list(text_lines or []),
            "image": image,
            "image_rect": image_rect,
            "font_size": font_size,
            "start_y": start_y if start_y is not None else self.height - 72,
            "runs": list(runs or []),
            "lines": list(lines or []),
        })

    def tobytes(self) -> bytes:
        objs: List[bytes] = []  # 1-indexed

        def add(obj: bytes) -> int:
            objs.append(obj)
            return len(objs)

        font_id = add(b"<< /Type /Font /Subtype /Type1 /BaseFont /Helvetica >>")

        page_ids = []
        kids_placeholder = add(b"PLACEHOLDER_PAGES")  # patched later
        for page in self.pages:
            content = []
            res_parts = [f"/Font << /F1 {font_id} 0 R >>"]
            if page["text"]:
                content.append(b"BT /F1 %.1f Tf" % page["font_size"])
                y = page["start_y"]
                content.append(b"%.1f %.1f Td" % (72, y))
                first = True
                for line in page["text"]:
                    if not first:
                        content.append(b"0 %.1f Td" % (-page["font_size"] * 1.4))
                    content.append(b"(%s) Tj" % _esc(line).encode("latin-1", "replace"))
                    first = False
                content.append(b"ET")
            for x, y, text in page.get("runs", []):
                content.append(
                    b"BT /F1 %.1f Tf %.1f %.1f Td (%s) Tj ET"
                    % (page["font_size"], x, y,
                       _esc(text).encode("latin-1", "replace"))
                )
            for x0, y0, x1, y1 in page.get("lines", []):
                content.append(b"%.1f %.1f m %.1f %.1f l S" % (x0, y0, x1, y1))
            if page["image"] is not None:
                img_id = add(_image_xobject(page["image"]))
                res_parts.append(f"/XObject << /Im1 {img_id} 0 R >>")
                x, y, cw, ch = page["image_rect"]
                content.append(
                    b"q %.1f 0 0 %.1f %.1f %.1f cm /Im1 Do Q" % (cw, ch, x, y)
                )
            stream = b"\n".join(content)
            cont_id = add(
                b"<< /Length %d >>\nstream\n%s\nendstream" % (len(stream), stream)
            )
            page_id = add(
                b"<< /Type /Page /Parent %d 0 R /MediaBox [0 0 %.1f %.1f] "
                b"/Resources << %s >> /Contents %d 0 R >>"
                % (kids_placeholder, self.width, self.height,
                   " ".join(res_parts).encode(), cont_id)
            )
            page_ids.append(page_id)

        kids = " ".join(f"{pid} 0 R" for pid in page_ids)
        objs[kids_placeholder - 1] = (
            b"<< /Type /Pages /Kids [%s] /Count %d >>" % (kids.encode(), len(page_ids))
        )
        catalog_id = add(b"<< /Type /Catalog /Pages %d 0 R >>" % kids_placeholder)

        out = bytearray(b"%PDF-1.4\n%\xe2\xe3\xcf\xd3\n")
        offsets = [0]
        for i, obj in enumerate(objs, start=1):
            offsets.append(len(out))
            out += b"%d 0 obj\n" % i
            out += obj
            out += b"\nendobj\n"
        xref_off = len(out)
        out += b"xref\n0 %d\n" % (len(objs) + 1)
        out += b"0000000000 65535 f \n"
        for off in offsets[1:]:
            out += b"%010d 00000 n \n" % off
        out += (
            b"trailer\n<< /Size %d /Root %d 0 R >>\nstartxref\n%d\n%%%%EOF\n"
            % (len(objs) + 1, catalog_id, xref_off)
        )
        return bytes(out)

    def save(self, path: str) -> None:
        with open(path, "wb") as f:
            f.write(self.tobytes())


def _image_xobject(image: Union[np.ndarray, bytes]) -> bytes:
    """An image XObject: a JPEG's bytes as they are (DCTDecode), an array
    zlib-compressed (FlateDecode)."""
    if isinstance(image, (bytes, bytearray)):
        w, h, ncomp = jpeg_size(image)
        space = b"/DeviceGray" if ncomp == 1 else b"/DeviceRGB"
        return (b"<< /Type /XObject /Subtype /Image /Width %d /Height %d "
                b"/ColorSpace %s /BitsPerComponent 8 "
                b"/Filter /DCTDecode /Length %d >>\nstream\n%s\nendstream"
                % (w, h, space, len(image), bytes(image)))
    img = np.ascontiguousarray(image, dtype=np.uint8)
    h, w, _ = img.shape
    data = zlib.compress(img.tobytes())
    return (b"<< /Type /XObject /Subtype /Image /Width %d /Height %d "
            b"/ColorSpace /DeviceRGB /BitsPerComponent 8 "
            b"/Filter /FlateDecode /Length %d >>\nstream\n%s\nendstream"
            % (w, h, len(data), data))


def jpeg_size(data: bytes) -> Tuple[int, int, int]:
    """(width, height, components) from a JPEG's frame header."""
    i = 2
    while i + 9 < len(data):
        if data[i] != 0xFF:
            raise ValueError("not a JPEG marker segment")
        marker = data[i + 1]
        if marker in (0xC0, 0xC1, 0xC2, 0xC3, 0xC9, 0xCA, 0xCB):
            h, w = int.from_bytes(data[i + 5:i + 7], "big"), int.from_bytes(data[i + 7:i + 9], "big")
            return w, h, data[i + 9]
        i += 2 + int.from_bytes(data[i + 2:i + 4], "big")
    raise ValueError("no JPEG frame header")


def make_sample_pdf(
    path: str,
    n_pages: int = 3,
    lines_per_page: int = 20,
    with_images: bool = True,
    seed: int = 0,
    title: str = "Glycan structures in biology",
) -> None:
    """A synthetic 'paper' exercising text + images, for tests and benches."""
    rng = np.random.default_rng(seed)
    w = PdfWriter()
    for p in range(n_pages):
        lines = [f"{title} - page {p + 1}"]
        for i in range(lines_per_page):
            lines.append(
                f"Paragraph {i}: glycans such as sialyl-Lewis-x bind selectins "
                f"(sample sentence {rng.integers(0, 10_000)})."
            )
        img = None
        if with_images:
            img = (rng.integers(0, 255, (60, 80, 3))).astype(np.uint8)
        w.add_page(text_lines=lines, image=img)
    w.save(path)


class PdfWriterXrefStream:
    """A SECOND, deliberately different PDF dialect (VERDICT r2 #2: the
    ingest stack must not be validated only against ``PdfWriter``'s own
    output). Differences from ``PdfWriter``:

    - PDF 1.5 cross-reference STREAM (binary /W rows) instead of a classic
      xref table;
    - catalog/pages/font/page dicts packed into an object STREAM (/ObjStm,
      type-2 xref entries) instead of direct objects;
    - FlateDecode-compressed content streams;
    - text positioned with ``Tm`` matrices and shown as ``TJ`` arrays with
      kern adjustments that split words across string segments (the
      matplotlib/report-writer style), instead of ``Td``/``Tj`` lines.
    """

    def __init__(self, width: float = 595, height: float = 842):
        self.width = width
        self.height = height
        self.pages: List[dict] = []

    def add_page(self, text_lines: Optional[Sequence[str]] = None,
                 image: Optional[np.ndarray] = None,
                 image_rect: Tuple[float, float, float, float] = (90, 380, 280, 180),
                 font_size: float = 11,
                 runs: Optional[Sequence[Tuple[float, float, str]]] = None) -> None:
        """``runs``: positioned text as (x, y-from-bottom, text) triples,
        each shown as a kern-split ``Tm`` + ``TJ`` block (the matplotlib
        style) - for multi-column layout fixtures in this dialect."""
        self.pages.append({"text": list(text_lines or []), "image": image,
                           "image_rect": image_rect, "font_size": font_size,
                           "runs": list(runs or [])})

    @staticmethod
    def _tj_segments(line: str) -> bytes:
        """Split the line into TJ segments at word boundaries with small
        kern adjustments INSIDE words where possible - no segment boundary
        may be interpretable as a space."""
        parts = []
        for i, word in enumerate(line.split(" ")):
            if i:
                parts.append(b"(%s)" % _esc(" ").encode())
            if len(word) > 4:   # kern-split the word itself
                parts.append(b"(%s) -14 (%s)"
                             % (_esc(word[:3]).encode("latin-1", "replace"),
                                _esc(word[3:]).encode("latin-1", "replace")))
            else:
                parts.append(b"(%s)" % _esc(word).encode("latin-1", "replace"))
        return b"[" + b" ".join(parts) + b"] TJ"

    def tobytes(self) -> bytes:
        # object numbering: 1 = catalog, 2 = pages, 3 = font (all inside the
        # objstm), then per page: page dict (objstm) + content stream
        # (direct) + optional image stream (direct), then objstm, then the
        # xref stream itself.
        n_pages = len(self.pages)
        catalog_n, pages_n, font_n = 1, 2, 3
        page_ns = [4 + i for i in range(n_pages)]
        next_n = 4 + n_pages
        content_ns, image_ns = [], []
        for page in self.pages:
            content_ns.append(next_n)
            next_n += 1
            if page["image"] is not None:
                image_ns.append(next_n)
                next_n += 1
            else:
                image_ns.append(None)
        objstm_n = next_n
        xref_n = next_n + 1

        # packed (object-stream) members
        packed: List[Tuple[int, bytes]] = [
            (catalog_n, b"<< /Type /Catalog /Pages %d 0 R >>" % pages_n),
            (pages_n, b"<< /Type /Pages /Kids [%s] /Count %d >>"
             % (" ".join(f"{n} 0 R" for n in page_ns).encode(), n_pages)),
            (font_n, b"<< /Type /Font /Subtype /Type1 /BaseFont /Courier >>"),
        ]
        for i, page in enumerate(self.pages):
            res = [b"/Font << /F1 %d 0 R >>" % font_n]
            if image_ns[i] is not None:
                res.append(b"/XObject << /Im1 %d 0 R >>" % image_ns[i])
            packed.append((page_ns[i],
                           b"<< /Type /Page /Parent %d 0 R /MediaBox [0 0 %.1f %.1f] "
                           b"/Resources << %s >> /Contents %d 0 R >>"
                           % (pages_n, self.width, self.height,
                              b" ".join(res), content_ns[i])))

        header = b""
        body = b""
        for num, data in packed:
            header += b"%d %d " % (num, len(body))
            body += data + b"\n"
        objstm_payload = header + body
        objstm_data = zlib.compress(objstm_payload)
        objstm_obj = (b"<< /Type /ObjStm /N %d /First %d /Filter /FlateDecode "
                      b"/Length %d >>\nstream\n%s\nendstream"
                      % (len(packed), len(header), len(objstm_data), objstm_data))

        # direct objects: content (+ image) streams, objstm, xref stream
        direct: List[Tuple[int, bytes]] = []
        for i, page in enumerate(self.pages):
            fs = page["font_size"]
            content = []
            y = self.height - 64
            for line in page["text"]:
                content.append(b"BT /F1 %.1f Tf 1 0 0 1 %.1f %.1f Tm %s ET"
                               % (fs, 64.0, y, self._tj_segments(line)))
                y -= fs * 1.5
            for x, ry, text in page.get("runs", []):
                content.append(b"BT /F1 %.1f Tf 1 0 0 1 %.1f %.1f Tm %s ET"
                               % (fs, x, ry, self._tj_segments(text)))
            if page["image"] is not None:
                img = np.ascontiguousarray(page["image"], dtype=np.uint8)
                h, w, _ = img.shape
                idata = zlib.compress(img.tobytes())
                direct.append((image_ns[i],
                               b"<< /Type /XObject /Subtype /Image /Width %d "
                               b"/Height %d /ColorSpace /DeviceRGB "
                               b"/BitsPerComponent 8 /Filter /FlateDecode "
                               b"/Length %d >>\nstream\n%s\nendstream"
                               % (w, h, len(idata), idata)))
                x, yy, cw, ch = page["image_rect"]
                content.append(b"q %.1f 0 0 %.1f %.1f %.1f cm /Im1 Do Q"
                               % (cw, ch, x, yy))
            cdata = zlib.compress(b"\n".join(content))
            direct.append((content_ns[i],
                           b"<< /Filter /FlateDecode /Length %d >>\n"
                           b"stream\n%s\nendstream" % (len(cdata), cdata)))
        direct.append((objstm_n, objstm_obj))

        out = bytearray(b"%PDF-1.5\n%\xe2\xe3\xcf\xd3\n")
        offsets: dict = {}
        for num, data in sorted(direct):
            offsets[num] = len(out)
            out += b"%d 0 obj\n" % num
            out += data
            out += b"\nendobj\n"

        # xref stream: /W [1 4 2]; type 0 free, 1 direct, 2 in-objstm
        size = xref_n + 1
        rows = bytearray()
        for num in range(size):
            if num == 0:
                rows += b"\x00" + (0).to_bytes(4, "big") + (65535).to_bytes(2, "big")
            elif num in offsets:
                rows += b"\x01" + offsets[num].to_bytes(4, "big") + (0).to_bytes(2, "big")
            elif num == xref_n:
                rows += b"\x01" + (0).to_bytes(4, "big") + (0).to_bytes(2, "big")  # patched
            else:
                idx = next(j for j, (n, _) in enumerate(packed) if n == num)
                rows += b"\x02" + objstm_n.to_bytes(4, "big") + idx.to_bytes(2, "big")
        xref_off = len(out)
        rows[xref_n * 7 + 1: xref_n * 7 + 5] = xref_off.to_bytes(4, "big")
        xdata = zlib.compress(bytes(rows))
        out += b"%d 0 obj\n" % xref_n
        out += (b"<< /Type /XRef /Size %d /W [1 4 2] /Root %d 0 R "
                b"/Filter /FlateDecode /Length %d >>\nstream\n%s\nendstream\nendobj\n"
                % (size, catalog_n, len(xdata), xdata))
        out += b"startxref\n%d\n%%%%EOF\n" % xref_off
        return bytes(out)

    def save(self, path: str) -> None:
        with open(path, "wb") as f:
            f.write(self.tobytes())
