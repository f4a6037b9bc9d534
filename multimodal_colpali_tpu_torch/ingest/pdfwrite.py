"""Tiny PDF writer - test fixture generator for the native rasterizer.

The port's copy of ``multimodal_colpali_tpu/ingest/pdfwrite.py``, numpy and the
standard library only, with one addition: ``PdfWriter`` also embeds a JPEG
(bytes, written with the DCTDecode filter), and :func:`encode_jpeg` makes one,
so that PDFs with JPEG figures are written where Pillow is missing.

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


# The JPEG standard's example quantization tables (Annex K.1), natural order.
_LUMA_Q = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99])
_CHROMA_Q = np.full(64, 99)
_CHROMA_Q[[0, 1, 2, 3, 8, 9, 10, 11, 16, 17, 18, 24, 25]] = [17, 18, 24, 47, 18, 21, 26, 66,
                                                            24, 26, 56, 47, 66]
# zig-zag index -> natural index
_ZIGZAG = np.array(sorted(range(64), key=lambda n: (n // 8 + n % 8,
                                                    n // 8 if (n // 8 + n % 8) % 2 else n % 8)))
# Huffman code lengths: the standard's counts (Annex K.3) for the DC
# categories 0-11 and for all 162 AC symbols (EOB, ZRL, run/size)
_DC_BITS = [0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0]
_AC_BITS = [0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 125]
_AC_SYMBOLS = sorted([0x00, 0xF0] + [r << 4 | s for r in range(16) for s in range(1, 11)],
                     key=lambda v: (v != 0, (v >> 4) + (v & 15), v))


def _huffman_codes(bits: Sequence[int], symbols: Sequence[int]) -> dict:
    """Canonical codes {symbol: (code, length)} for a DHT's counts."""
    codes, code, k = {}, 0, 0
    for length, n in enumerate(bits, start=1):
        for _ in range(n):
            codes[symbols[k]] = (code, length)
            code += 1
            k += 1
        code <<= 1
    return codes


def encode_jpeg(pixels: np.ndarray, quality: int = 90, sampling: Tuple[int, int] = (2, 2),
                restart_interval: int = 0) -> bytes:
    """A baseline JFIF JPEG of a uint8 ``[H, W, 3]`` (YCbCr, luma sampled
    ``sampling`` = (horizontal, vertical) times the chroma) or ``[H, W]``
    (gray) array, with the standard's tables scaled to ``quality`` as libjpeg
    does, and an RSTn marker every ``restart_interval`` MCUs if positive."""
    arr = np.asarray(pixels, np.uint8)
    height, width = arr.shape[:2]
    if arr.ndim == 2:
        planes, factors = [arr.astype(np.float64)], [(1, 1)]
    else:
        r, g, b = (arr[..., k].astype(np.float64) for k in range(3))
        planes = [0.299 * r + 0.587 * g + 0.114 * b,
                  -0.168736 * r - 0.331264 * g + 0.5 * b + 128,
                  0.5 * r - 0.418688 * g - 0.081312 * b + 128]
        factors = [tuple(sampling), (1, 1), (1, 1)]
    hmax, vmax = max(f[0] for f in factors), max(f[1] for f in factors)
    mcus_x, mcus_y = -(-width // (8 * hmax)), -(-height // (8 * vmax))
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    tables = [np.clip((q * scale + 50) // 100, 1, 255) for q in (_LUMA_Q, _CHROMA_Q)]
    u = np.arange(8)
    dct = np.cos((2 * u[None, :] + 1) * u[:, None] * np.pi / 16) / 2
    dct[0] /= np.sqrt(2)
    coefs = []   # per component: [blocks_y, blocks_x, 64] quantized, zig-zag order
    for k, (plane, (h, v)) in enumerate(zip(planes, factors)):
        fh, fv = hmax // h, vmax // v
        full = np.pad(plane, ((0, mcus_y * 8 * vmax - height), (0, mcus_x * 8 * hmax - width)),
                      mode="edge")
        down = full.reshape(full.shape[0] // fv, fv, full.shape[1] // fh, fh).mean(axis=(1, 3))
        blocks = down.reshape(down.shape[0] // 8, 8, down.shape[1] // 8, 8).transpose(0, 2, 1, 3)
        freq = dct @ (blocks - 128) @ dct.T
        q = tables[min(k, 1)].reshape(8, 8)
        coefs.append(np.round(freq / q).astype(np.int64).reshape(*freq.shape[:2], 64)[..., _ZIGZAG])

    dc_codes = _huffman_codes(_DC_BITS, list(range(12)))
    ac_codes = _huffman_codes(_AC_BITS, _AC_SYMBOLS)
    out = bytearray()
    acc, nacc = 0, 0

    def put(code: int, length: int) -> None:
        nonlocal acc, nacc
        acc, nacc = (acc << length) | code, nacc + length
        while nacc >= 8:
            nacc -= 8
            byte = (acc >> nacc) & 0xFF
            out.append(byte)
            if byte == 0xFF:
                out.append(0)
        acc &= (1 << nacc) - 1

    def put_value(value: int, table: dict, symbol_run: int = -1) -> None:
        size = int(abs(value)).bit_length()
        symbol = size if symbol_run < 0 else (symbol_run << 4) | size
        put(*table[symbol])
        if size:
            put(value if value > 0 else value + (1 << size) - 1, size)

    last_dc = [0] * len(planes)
    for m in range(mcus_x * mcus_y):
        if restart_interval and m and m % restart_interval == 0:
            if nacc:
                put((1 << (8 - nacc)) - 1, 8 - nacc)
            out += bytes([0xFF, 0xD0 + (m // restart_interval - 1) % 8])
            last_dc = [0] * len(planes)
        my, mx = divmod(m, mcus_x)
        for k, (h, v) in enumerate(factors):
            dc_t, ac_t = (dc_codes, ac_codes)
            for by in range(v):
                for bx in range(h):
                    zz = coefs[k][my * v + by, mx * h + bx]
                    put_value(int(zz[0]) - last_dc[k], dc_t)
                    last_dc[k] = int(zz[0])
                    run = 0
                    for c in zz[1:]:
                        if c == 0:
                            run += 1
                            continue
                        while run > 15:
                            put(*ac_t[0xF0])
                            run -= 16
                        put_value(int(c), ac_t, run)
                        run = 0
                    if run:
                        put(*ac_t[0x00])
    if nacc:
        put((1 << (8 - nacc)) - 1, 8 - nacc)
    data = bytes(out)

    def segment(marker: int, payload: bytes) -> bytes:
        return bytes([0xFF, marker]) + (len(payload) + 2).to_bytes(2, "big") + payload

    n = len(planes)
    head = b"\xff\xd8" + segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    for t, table in enumerate(tables[:n]):
        head += segment(0xDB, bytes([t]) + bytes(int(x) for x in table[_ZIGZAG]))
    head += segment(0xC0, bytes([8]) + height.to_bytes(2, "big") + width.to_bytes(2, "big")
                    + bytes([n]) + b"".join(bytes([k + 1, h << 4 | v, min(k, 1)])
                                            for k, (h, v) in enumerate(factors)))
    head += segment(0xC4, bytes([0x00]) + bytes(_DC_BITS) + bytes(range(12)))
    head += segment(0xC4, bytes([0x10]) + bytes(_AC_BITS) + bytes(_AC_SYMBOLS))
    if restart_interval:
        head += segment(0xDD, restart_interval.to_bytes(2, "big"))
    head += segment(0xDA, bytes([n]) + b"".join(bytes([k + 1, 0x00]) for k in range(n))
                    + bytes([0, 63, 0]))
    return head + data + b"\xff\xd9"


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
