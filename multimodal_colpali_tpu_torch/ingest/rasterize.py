"""PDF rasterization & text extraction via the native mmpdf C++ library
(counterpart of ``multimodal_colpali_tpu/ingest/rasterize.py``).

Replaces the reference's poppler path: ``convert_pdfs_to_images`` /
``convert_pdf_dir_to_images`` (reference functions.py:678-713) rasterized
via ``pdf2image.convert_from_path``; here the same surface is served by the
port's own copy of ``native/src/mmpdf.cpp`` (built by
``_build.build_native``) through ctypes, with the same on-disk layout
``{stem}_{page:03d}.png`` (reference functions.py:689).

Where the JAX module returns ``PIL.Image`` pages, this one returns uint8
``[H, W, 3]`` arrays. JPEG (DCTDecode) images decode through the port's
own decoder, built into the library in place of libjpeg; an image it cannot
decode (a corrupt stream, or a kind it does not support, such as arithmetic
coding) is left out of the page, as mmpdf leaves it out with libjpeg, and
``render`` / ``extract_images`` warn with the document and page, and count
it (:func:`skipped_jpeg_images`). ``mmpdf_render_page`` runs with the interpreter lock
released (a ctypes call), so rasterizing threads overlap. The conversion
functions take ``device``: on a CUDA device each raster is uploaded and
resized there (``resize_image`` through ``imageops``, pixels equal to the
host's), and only the PNGs come back to the host.
"""

from __future__ import annotations

import ctypes
import os
import threading
import warnings
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from multimodal_colpali_tpu_torch._build import build_native
from multimodal_colpali_tpu_torch._device import resolve_device
from multimodal_colpali_tpu_torch.ingest.imageops import write_png
from multimodal_colpali_tpu_torch.ingest.preprocess import resize_image_on

_LIB: Optional[ctypes.CDLL] = None
_LIB_LOCK = threading.Lock()
_SKIPPED = [0]   # JPEG images left out, in this process


def skipped_jpeg_images() -> int:
    """How many JPEG images this process could not decode and left out."""
    with _LIB_LOCK:
        return _SKIPPED[0]


def get_lib() -> ctypes.CDLL:
    """The mmpdf library with its entry points typed (built at first use)."""
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            _LIB = _typed_lib()
        return _LIB


def _typed_lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build_native()))
    lib.mmpdf_jpeg_failures.restype = ctypes.c_int
    lib.mmpdf_jpeg_failures.argtypes = []
    lib.mmpdf_open.restype = ctypes.c_void_p
    lib.mmpdf_open.argtypes = [ctypes.c_char_p, ctypes.c_size_t]
    lib.mmpdf_close.argtypes = [ctypes.c_void_p]
    lib.mmpdf_page_count.restype = ctypes.c_int
    lib.mmpdf_page_count.argtypes = [ctypes.c_void_p]
    lib.mmpdf_render_page.restype = ctypes.POINTER(ctypes.c_uint8)
    lib.mmpdf_render_page.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_double,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
    ]
    lib.mmpdf_extract_text.restype = ctypes.c_void_p
    lib.mmpdf_extract_text.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.mmpdf_page_width.restype = ctypes.c_double
    lib.mmpdf_page_width.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.mmpdf_page_height.restype = ctypes.c_double
    lib.mmpdf_page_height.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.mmpdf_free.argtypes = [ctypes.c_void_p]

    class _ImageDesc(ctypes.Structure):
        _fields_ = [("w", ctypes.c_int), ("h", ctypes.c_int),
                    ("x0", ctypes.c_double), ("y0", ctypes.c_double),
                    ("x1", ctypes.c_double), ("y1", ctypes.c_double),
                    ("rgb", ctypes.POINTER(ctypes.c_uint8))]

    lib._ImageDesc = _ImageDesc
    lib.mmpdf_extract_images.restype = ctypes.POINTER(_ImageDesc)
    lib.mmpdf_extract_images.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                         ctypes.POINTER(ctypes.c_int)]
    lib.mmpdf_free_images.argtypes = [ctypes.POINTER(_ImageDesc), ctypes.c_int]

    class _TextRun(ctypes.Structure):
        _fields_ = [("x", ctypes.c_double), ("y", ctypes.c_double),
                    ("size", ctypes.c_double), ("text", ctypes.c_char_p)]

    lib._TextRun = _TextRun
    lib.mmpdf_extract_runs.restype = ctypes.POINTER(_TextRun)
    lib.mmpdf_extract_runs.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                       ctypes.POINTER(ctypes.c_int)]
    lib.mmpdf_free_runs.argtypes = [ctypes.POINTER(_TextRun), ctypes.c_int]

    class _Rule(ctypes.Structure):
        _fields_ = [("x0", ctypes.c_double), ("y0", ctypes.c_double),
                    ("x1", ctypes.c_double), ("y1", ctypes.c_double)]

    lib._Rule = _Rule
    lib.mmpdf_extract_rules.restype = ctypes.POINTER(_Rule)
    lib.mmpdf_extract_rules.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                        ctypes.POINTER(ctypes.c_int)]
    lib.mmpdf_font_atlas.restype = ctypes.POINTER(ctypes.c_uint8)
    lib.mmpdf_font_atlas.argtypes = []
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.mmjpeg_decode_rgb.restype = ctypes.c_int
    lib.mmjpeg_decode_rgb.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.POINTER(u8p),
                                      ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    lib.mmjpeg_encode.restype = ctypes.c_int
    lib.mmjpeg_encode.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 7 + [
        ctypes.POINTER(u8p), ctypes.POINTER(ctypes.c_size_t)]
    lib.mmjpeg_free.argtypes = [ctypes.c_void_p]
    return lib


def decode_jpeg(blob: bytes) -> Optional[np.ndarray]:
    """JPEG bytes -> uint8 ``[H, W, 3]`` RGB through the port's decoder
    (``native/jpeg/jpegdec.cpp``, libjpeg-turbo's pixels: what Pillow's
    ``Image.open(...).convert("RGB")`` gives), or None where it does not
    decode."""
    lib = get_lib()
    out = ctypes.POINTER(ctypes.c_uint8)()
    w, h = ctypes.c_int(), ctypes.c_int()
    if lib.mmjpeg_decode_rgb(bytes(blob), len(blob), ctypes.byref(out), ctypes.byref(w),
                             ctypes.byref(h)) != 0:
        return None
    try:
        return np.ctypeslib.as_array(out, (h.value, w.value, 3)).copy()
    finally:
        lib.mmjpeg_free(out)


def encode_jpeg(pixels: np.ndarray, quality: int = 75, sampling: Tuple[int, int] = (2, 2),
                restart_interval: int = 0) -> bytes:
    """uint8 ``[H, W, 3]`` RGB or ``[H, W]`` gray -> baseline JFIF JPEG bytes
    at ``quality`` through the port's encoder (``native/jpeg/jpegenc.cpp``,
    libjpeg-turbo's compression path): YCbCr with the luma sampled
    ``sampling`` = (horizontal, vertical) times the chroma, 1-4 each with a
    product of at most 8, and an RSTn marker every ``restart_interval`` MCUs
    if positive. With the defaults these are the bytes of Pillow's
    ``save(format="JPEG")`` (4:2:0, the standard Huffman tables); Pillow's
    ``subsampling`` 1 (4:2:2) is ``sampling=(2, 1)`` and 0 (4:4:4) ``(1, 1)``."""
    a = np.ascontiguousarray(pixels)
    ncomp = 1 if a.ndim == 2 else (a.shape[2] if a.ndim == 3 else 0)
    if a.dtype != np.uint8 or ncomp not in (1, 3) or 0 in a.shape[:2]:
        raise ValueError(f"encode_jpeg takes uint8 [H, W, 3] or [H, W] images, not {a.dtype} "
                         f"{a.shape}")
    h_samp, v_samp = (int(x) for x in sampling)
    lib = get_lib()
    out = ctypes.POINTER(ctypes.c_uint8)()
    n = ctypes.c_size_t()
    if lib.mmjpeg_encode(a.ctypes.data, a.shape[1], a.shape[0], ncomp, int(quality), h_samp,
                         v_samp, int(restart_interval), ctypes.byref(out), ctypes.byref(n)) != 0:
        raise ValueError(f"JPEG encoding of a {a.shape} image at sampling {sampling}, restart "
                         f"interval {restart_interval} failed (at most 65,535 pixels a side, "
                         f"sampling 1-4 with a product of at most 8)")
    try:
        return ctypes.string_at(out, n.value)
    finally:
        lib.mmjpeg_free(out)


def font_atlas() -> "np.ndarray":
    """The rasterizer's built-in 8x13 glyph bitmaps as a bool array.

    Returns [95, 13, 8] for ASCII 32..126 (index = ord(ch) - 32), row-major
    top-to-bottom, column 0 = leftmost. Shared with the OCR stage so
    rendering and recognition agree on glyph shapes.
    """
    lib = get_lib()
    raw = ctypes.string_at(lib.mmpdf_font_atlas(), 95 * 13)
    rows = np.frombuffer(raw, dtype=np.uint8).reshape(95, 13)
    return (rows[..., None] & (0x80 >> np.arange(8))[None, None, :]) != 0


class PdfDocument:
    """A parsed PDF: page count, page rasters, text layer."""

    def __init__(self, path_or_bytes):
        if isinstance(path_or_bytes, (str, Path)):
            with open(path_or_bytes, "rb") as f:
                data = f.read()
            self.name = os.path.basename(str(path_or_bytes))
        else:
            data = bytes(path_or_bytes)
            self.name = "document.pdf"
        self._lib = get_lib()
        self._data = data  # keep alive
        self._h = self._lib.mmpdf_open(data, len(data))
        if not self._h:
            raise ValueError(f"could not parse PDF {self.name!r}")

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.mmpdf_close(self._h)
            self._h = None

    def __len__(self) -> int:
        return self._lib.mmpdf_page_count(self._h)

    def page_size(self, index: int) -> tuple:
        return (self._lib.mmpdf_page_width(self._h, index),
                self._lib.mmpdf_page_height(self._h, index))

    def _check_jpegs(self, failures_before: int, index: int, what: str) -> None:
        """Warn if JPEG images failed to decode since ``failures_before`` (the
        library's count for this thread)."""
        n = self._lib.mmpdf_jpeg_failures() - failures_before
        if n:
            with _LIB_LOCK:
                _SKIPPED[0] += n
            warnings.warn(f"{self.name} page {index + 1}: {n} JPEG image(s) could not be "
                          f"decoded and were left out of the {what}", RuntimeWarning,
                          stacklevel=3)

    def render(self, index: int, dpi: float = 144.0) -> np.ndarray:
        """The page as a uint8 ``[H, W, 3]`` RGB array."""
        w = ctypes.c_int(0)
        h = ctypes.c_int(0)
        before = self._lib.mmpdf_jpeg_failures()
        buf = self._lib.mmpdf_render_page(self._h, index, dpi,
                                          ctypes.byref(w), ctypes.byref(h))
        self._check_jpegs(before, index, "raster")
        if not buf:
            raise IndexError(f"page {index} out of range")
        try:
            arr = np.ctypeslib.as_array(buf, shape=(h.value, w.value, 3)).copy()
        finally:
            self._lib.mmpdf_free(buf)
        return arr

    def extract_text(self, index: int) -> str:
        ptr = self._lib.mmpdf_extract_text(self._h, index)
        if not ptr:
            return ""
        try:
            return ctypes.string_at(ptr).decode("utf-8", "replace")
        finally:
            self._lib.mmpdf_free(ptr)

    def extract_images(self, index: int):
        """Embedded raster figures of a page -> [(uint8 [h, w, 3], bbox)], bbox in
        PDF units (x0, y0, x1, y1, top-left origin)."""
        count = ctypes.c_int(0)
        before = self._lib.mmpdf_jpeg_failures()
        arr = self._lib.mmpdf_extract_images(self._h, index, ctypes.byref(count))
        self._check_jpegs(before, index, "extracted images")
        out = []
        try:
            for i in range(count.value):
                d = arr[i]
                buf = np.ctypeslib.as_array(d.rgb, shape=(d.h, d.w, 3)).copy()
                out.append((buf, (d.x0, d.y0, d.x1, d.y1)))
        finally:
            if count.value:
                self._lib.mmpdf_free_images(arr, count.value)
        return out

    def extract_runs(self, index: int):
        """Positioned text runs -> [(x, y, size, text)] in PDF units,
        top-left origin. The layout signal for table detection."""
        count = ctypes.c_int(0)
        arr = self._lib.mmpdf_extract_runs(self._h, index, ctypes.byref(count))
        out = []
        try:
            for i in range(count.value):
                r = arr[i]
                out.append((r.x, r.y, r.size,
                            (r.text or b"").decode("utf-8", "replace")))
        finally:
            if count.value:
                self._lib.mmpdf_free_runs(arr, count.value)
        return out

    def extract_rules(self, index: int):
        """Ruled lines -> [(x0, y0, x1, y1)] in PDF units, top-left origin:
        near-axis stroked segments and thin filled rects (table borders /
        booktabs rules). Second structure signal for ``detect_tables``."""
        count = ctypes.c_int(0)
        arr = self._lib.mmpdf_extract_rules(self._h, index, ctypes.byref(count))
        out = []
        try:
            for i in range(count.value):
                r = arr[i]
                out.append((r.x0, r.y0, r.x1, r.y1))
        finally:
            if count.value:
                self._lib.mmpdf_free(arr)
        return out

    def has_text(self, index: int = 0) -> bool:
        """check_ocr probe: does page ``index`` carry a text layer?

        (The reference's ``check_ocr`` at functions.py:133-148 intends this
        but always returns False due to the ``len(text)>=0`` bug; this
        implements the intended semantics.)
        """
        return len(self.extract_text(index).strip()) > 0


def resized_page(doc: PdfDocument, index: int, dpi: float, device: torch.device):
    """Page ``index`` resized by ``resize_image`` on ``device``: a host array
    on the CPU, a tensor on a CUDA device (the raster uploaded first)."""
    return resize_image_on(doc.render(index, dpi=dpi), device)


def convert_pdfs_to_images(
    papers: List[str], vd_dir: str, dpi: float = 144.0, subdir: str = "pg_images",
    device: Any = "cuda",
) -> Dict[str, List[str]]:
    """Rasterize PDFs to ``{vd_dir}/{subdir}/{stem}_{page:03d}.png``.

    Surface-compatible with reference functions.py:678-694 (which resizes
    through ``resize_image`` before saving; we do the same, on ``device``).
    """
    device = resolve_device(device)
    out_dir = Path(vd_dir) / subdir
    out_dir.mkdir(parents=True, exist_ok=True)
    saved: Dict[str, List[str]] = {}
    for paper in papers:
        doc = PdfDocument(paper)
        stem = Path(paper).stem
        paths = []
        for i in range(len(doc)):
            p = out_dir / f"{stem}_{i + 1:03d}.png"
            write_png(p, resized_page(doc, i, dpi, device))
            paths.append(str(p))
        saved[stem] = paths
    return saved


def pdf_names(pdf_dir: str) -> List[str]:
    """The PDFs of a directory, by name, in ``convert_pdf_dir_to_images``'
    order."""
    return [n for n in sorted(os.listdir(pdf_dir)) if n.lower().endswith(".pdf")]


def resized_pages(path: str, dpi: float = 144.0, device: Any = "cuda") -> List[Any]:
    """One PDF's pages as ``convert_pdf_dir_to_images`` gives them."""
    device = resolve_device(device)
    doc = PdfDocument(path)
    return [resized_page(doc, i, dpi, device) for i in range(len(doc))]


def convert_pdf_dir_to_images(pdf_dir: str, dpi: float = 144.0,
                              device: Any = "cuda") -> Dict[str, List[Any]]:
    """In-memory variant: {filename: [pages]} (reference functions.py:697-713),
    each page a uint8 ``[H, W, 3]`` array on the CPU, a tensor on ``device``
    otherwise."""
    device = resolve_device(device)
    return {name: resized_pages(os.path.join(pdf_dir, name), dpi, device)
            for name in pdf_names(pdf_dir)}
