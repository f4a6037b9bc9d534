"""The image operations of ingest, without Pillow.

The JAX package's ingest hands ``PIL.Image`` objects from stage to stage:
it resizes pages with LANCZOS (``resize_image``), glyph crops with BILINEAR
(the conv OCR), model inputs with BICUBIC (the processors), crops tables
and writes and reads PNGs. The port works on uint8 arrays, HWC RGB or HW
gray, and carries its own counterparts of those calls:

- :func:`resize` is Pillow's ``Resample.c`` taken literally, so its pixels
  equal ``Image.resize``'s byte for byte: the same filter coefficients
  (``precompute_coeffs``: support scaled by ``max(in / out, 1)``, windows
  from ``int(center - support + 0.5)``, weights normalized by their sum and
  rounded to 22 fractional bits, half away from zero), the same
  accumulator (``1 << 21`` plus the products, ``>> 22``, clipped to 0-255),
  the horizontal pass first and the vertical second with a uint8 image
  between them, and no pass along an axis whose size does not change.
  A numpy array is resized on the host in int64 (the plain version). A
  torch tensor is resized on its device in float64: every product is an
  integer below 2^30 and every partial sum far below 2^53, so the float64
  sums are exact and equal the int64 ones. Float32 is not exact.
- :func:`crop` is ``Image.crop`` (the region outside the image reads 0).
- :func:`write_png` / :func:`read_png`: 8-bit gray, RGB and RGBA PNGs,
  not interlaced. The writer filters every row with Up; the reader takes
  all five filter types. Anything else raises.
"""

from __future__ import annotations

import functools
import math
import struct
import zlib
from typing import Any, Optional, Sequence, Tuple

import numpy as np
import torch

PRECISION_BITS = 32 - 8 - 2


def _bilinear(x: float) -> float:
    if x < 0.0:
        x = -x
    if x < 1.0:
        return 1.0 - x
    return 0.0


def _bicubic(x: float) -> float:
    a = -0.5
    if x < 0.0:
        x = -x
    if x < 1.0:
        return ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    if x < 2.0:
        return (((x - 5) * x + 8) * x - 4) * a
    return 0.0


def _sinc(x: float) -> float:
    if x == 0.0:
        return 1.0
    x = x * math.pi
    return math.sin(x) / x


def _lanczos(x: float) -> float:
    if -3.0 <= x < 3.0:
        return _sinc(x) * _sinc(x / 3)
    return 0.0


# name -> (filter, support), Resample.c's BILINEAR, BICUBIC and LANCZOS
FILTERS = {"bilinear": (_bilinear, 1.0), "bicubic": (_bicubic, 2.0), "lanczos": (_lanczos, 3.0)}


@functools.lru_cache(maxsize=512)
def coefficients(in_size: int, out_size: int, name: str) -> Tuple[np.ndarray, np.ndarray]:
    """Resample.c's ``precompute_coeffs`` and ``normalize_coeffs_8bpc`` for
    one axis -> (first input index of each output ``[out]``, int64 weights
    ``[out, ksize]``, zero past each window). The weights come from Python's
    ``math.sin`` in Pillow's order of operations, one output at a time."""
    filt, fsupport = FILTERS[name]
    scale = float(in_size) / out_size
    filterscale = max(scale, 1.0)
    support = fsupport * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    first = np.zeros(out_size, np.int64)
    kk = np.zeros((out_size, ksize), np.int64)
    one = float(1 << PRECISION_BITS)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        ss = 1.0 / filterscale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        ws = [filt((x + xmin - center + 0.5) * ss) for x in range(xmax)]
        ww = 0.0
        for w in ws:
            ww += w
        for x, w in enumerate(ws):
            if ww != 0.0:
                w /= ww
            kk[xx, x] = int(-0.5 + w * one) if w < 0 else int(0.5 + w * one)
        first[xx] = xmin
    first.setflags(write=False)
    kk.setflags(write=False)
    return first, kk


def _taps(in_size: int, out_size: int, name: str) -> Tuple[np.ndarray, np.ndarray]:
    """-> (input index of each tap ``[out, ksize]``, clamped into the image
    where the weight is 0, int64 weights ``[out, ksize]``)."""
    first, kk = coefficients(in_size, out_size, name)
    idx = np.minimum(first[:, None] + np.arange(kk.shape[1]), in_size - 1)
    return idx, kk


def _pass_host(a: np.ndarray, axis: int, out_size: int, name: str) -> np.ndarray:
    """One pass over uint8 ``a`` [H, W, C] along ``axis``, in int64 (the
    resampled axis moved to the front, so each tap gathers whole rows)."""
    x = np.moveaxis(a, axis, 0)
    idx, kk = _taps(x.shape[0], out_size, name)
    acc = np.full((out_size,) + x.shape[1:], 1 << (PRECISION_BITS - 1), np.int64)
    x = np.ascontiguousarray(x)
    for k in range(kk.shape[1]):
        acc += x[idx[:, k]].astype(np.int64) * kk[:, k, None, None]
    out = np.clip(acc >> PRECISION_BITS, 0, 255).astype(np.uint8)
    return np.ascontiguousarray(np.moveaxis(out, 0, axis))


@functools.lru_cache(maxsize=512)
def _taps_on(in_size: int, out_size: int, name: str, device: torch.device):
    idx, kk = _taps(in_size, out_size, name)
    return (torch.from_numpy(idx).to(device),
            torch.from_numpy(kk.astype(np.float64)).to(device))


def _pass_device(x: torch.Tensor, axis: int, out_size: int, name: str) -> torch.Tensor:
    """One pass over float64 ``x`` [H, W, C] holding uint8 values."""
    idx, kk = _taps_on(x.shape[axis], out_size, name, x.device)
    shape = [1, 1, 1]
    shape[axis] = out_size
    out = list(x.shape)
    out[axis] = out_size
    acc = torch.full(out, float(1 << (PRECISION_BITS - 1)), dtype=torch.float64,
                     device=x.device)
    for k in range(kk.shape[1]):
        acc.addcmul_(x.index_select(axis, idx[:, k]), kk[:, k].reshape(shape))
    # exact integers: the division by 2^22 is exact and floor is the shift
    return acc.div_(float(1 << PRECISION_BITS)).floor_().clamp_(0, 255)


def resize(img: Any, size: Tuple[int, int], name: str = "bicubic") -> Any:
    """``Image.resize(size, filter)`` on a uint8 ``[H, W, 3]`` or ``[H, W]``
    array or tensor -> the same type at ``size`` = (width, height). An array
    is resized on the host (int64), a tensor on its device (float64)."""
    if name not in FILTERS:
        raise ValueError(f"unknown filter {name!r}; one of {sorted(FILTERS)}")
    w, h = int(size[0]), int(size[1])
    if w < 1 or h < 1:
        raise ValueError(f"size {size} must be positive")
    is_tensor = isinstance(img, torch.Tensor)
    if img.dtype != (torch.uint8 if is_tensor else np.uint8) or img.ndim not in (2, 3):
        raise ValueError(f"resize takes uint8 [H, W] or [H, W, C] images, not {img.dtype} "
                         f"{tuple(img.shape)}")
    gray = img.ndim == 2
    x = img[..., None] if gray else img
    if is_tensor:
        x = x.to(torch.float64)
        if x.shape[1] != w:
            x = _pass_device(x, 1, w, name)
        if x.shape[0] != h:
            x = _pass_device(x, 0, h, name)
        x = x.to(torch.uint8)
    else:
        x = np.ascontiguousarray(x)
        if x.shape[1] != w:
            x = _pass_host(x, 1, w, name)
        if x.shape[0] != h:
            x = _pass_host(x, 0, h, name)
        x = x.copy() if x is img or x.base is img else x
    return x[..., 0] if gray else x


def crop(img: np.ndarray, box: Sequence[int]) -> np.ndarray:
    """``Image.crop(box)``, box = (left, upper, right, lower): the region is
    copied, and where it lies outside the image it reads 0."""
    x0, y0, x1, y1 = (int(v) for v in box)
    if x1 < x0 or y1 < y0:
        raise ValueError(f"crop box {tuple(box)}: right < left or lower < upper")
    h, w = img.shape[:2]
    out = np.zeros((y1 - y0, x1 - x0) + img.shape[2:], img.dtype)
    sx0, sy0, sx1, sy1 = max(x0, 0), max(y0, 0), min(x1, w), min(y1, h)
    if sx1 > sx0 and sy1 > sy0:
        out[sy0 - y0: sy1 - y0, sx0 - x0: sx1 - x0] = img[sy0:sy1, sx0:sx1]
    return out


# -- PNG ------------------------------------------------------------------------

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_TYPE_OF_CHANNELS = {1: 0, 3: 2, 4: 6}       # what encode_png writes
# PNG color type -> (samples a pixel, the bit depths it allows)
_COLOR_TYPES = {0: (1, (1, 2, 4, 8, 16)), 2: (3, (8, 16)), 3: (1, (1, 2, 4, 8)),
                4: (2, (8, 16)), 6: (4, (8, 16))}
# Adam7's passes: (first column, first row, column step, row step)
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
          (0, 1, 1, 2))


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png(arr: np.ndarray, compress_level: int = 6) -> bytes:
    """uint8 ``[H, W]``, ``[H, W, 3]`` or ``[H, W, 4]`` -> PNG bytes (every
    row Up-filtered, zlib at ``compress_level``)."""
    a = np.asarray(arr)
    channels = 1 if a.ndim == 2 else (a.shape[2] if a.ndim == 3 else 0)
    if a.dtype != np.uint8 or channels not in _TYPE_OF_CHANNELS or 0 in a.shape[:2]:
        raise ValueError(f"write_png takes uint8 gray, RGB or RGBA images, not {a.dtype} "
                         f"{a.shape}")
    h, w = a.shape[:2]
    rows = np.ascontiguousarray(a).reshape(h, w * channels)
    data = np.empty((h, 1 + w * channels), np.uint8)
    data[:, 0] = 2                                            # Up
    data[0, 1:] = rows[0]
    np.subtract(rows[1:], rows[:-1], out=data[1:, 1:])        # wraps mod 256
    ihdr = struct.pack(">IIBBBBB", w, h, 8, _TYPE_OF_CHANNELS[channels], 0, 0, 0)
    return (_SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(data.tobytes(), compress_level))
            + _chunk(b"IEND", b""))


def write_png(path: Any, arr: np.ndarray, compress_level: int = 6) -> None:
    """Save ``arr`` (a host array, or a tensor copied to the host) as a PNG."""
    if isinstance(arr, torch.Tensor):
        arr = arr.cpu().numpy()
    with open(path, "wb") as f:
        f.write(encode_png(arr, compress_level))


def _paeth_row(f: np.ndarray, prior: np.ndarray, bpp: int) -> np.ndarray:
    out = bytearray(f.tobytes())
    up = prior.tobytes()
    for i in range(len(out)):
        a = out[i - bpp] if i >= bpp else 0
        b = up[i]
        c = up[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        out[i] = (out[i] + pred) & 0xFF
    return np.frombuffer(bytes(out), np.uint8)


def _average_row(f: np.ndarray, prior: np.ndarray, bpp: int) -> np.ndarray:
    out = bytearray(f.tobytes())
    up = prior.tobytes()
    for i in range(len(out)):
        left = out[i - bpp] if i >= bpp else 0
        out[i] = (out[i] + ((left + up[i]) >> 1)) & 0xFF
    return np.frombuffer(bytes(out), np.uint8)


def _unfilter(raw: np.ndarray, rows: int, stride: int, bpp: int) -> np.ndarray:
    """A (sub)image's filtered scanlines ``[rows, 1 + stride]`` -> its bytes
    ``[rows, stride]``."""
    out = np.empty((rows, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(rows):
        kind, f = raw[y, 0], raw[y, 1:]
        if kind == 0:
            row = f
        elif kind == 1:
            row = np.cumsum(f.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif kind == 2:
            row = f + prior
        elif kind == 3:
            row = _average_row(f, prior, bpp)
        elif kind == 4:
            row = _paeth_row(f, prior, bpp)
        else:
            raise ValueError(f"PNG row {y}: unknown filter type {kind}")
        out[y] = row
        prior = out[y]
    return out


def _samples(rows: np.ndarray, width: int, channels: int, depth: int) -> np.ndarray:
    """Unfiltered bytes ``[rows, stride]`` -> samples ``[rows, width,
    channels]`` (uint16 at depth 16, else uint8 at their own scale)."""
    n = width * channels
    if depth == 16:
        v = rows.reshape(rows.shape[0], -1, 2).astype(np.uint16)
        v = (v[..., 0] << 8) | v[..., 1]
    elif depth == 8:
        v = rows
    else:
        bits = np.unpackbits(rows, axis=1)[:, : n * depth].reshape(rows.shape[0], n, depth)
        v = (bits << np.arange(depth - 1, -1, -1, dtype=np.uint8)).sum(-1, dtype=np.uint8)
    return v[:, :n].reshape(rows.shape[0], width, channels)


def decode_png(blob: bytes) -> np.ndarray:
    """PNG bytes -> uint8 ``[H, W]`` (gray), ``[H, W, 2]`` (gray and alpha),
    ``[H, W, 3]`` (RGB, or a palette image's colors) or ``[H, W, 4]`` (RGBA),
    for every color type, bit depth and interlace method of the standard.
    The values are those Pillow gives: gray of 1, 2 or 4 bits scaled to
    0-255, 16-bit samples cut to their high byte, except 16-bit gray, which
    Pillow's ``I;16`` clips at 255; a transparency chunk is ignored. Raises
    ValueError for what is not a valid PNG (a palette index past the
    palette included)."""
    if blob[:8] != _SIGNATURE:
        raise ValueError("not a PNG file")
    pos, header, idat, palette = 8, None, [], None
    while pos + 8 <= len(blob):
        (length,) = struct.unpack(">I", blob[pos: pos + 4])
        kind = blob[pos + 4: pos + 8]
        data = blob[pos + 8: pos + 8 + length]
        (crc,) = struct.unpack(">I", blob[pos + 8 + length: pos + 12 + length])
        if len(data) != length or zlib.crc32(kind + data) & 0xFFFFFFFF != crc:
            raise ValueError(f"PNG chunk {kind!r}: truncated or bad CRC")
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", data)
        elif kind == b"IDAT":
            idat.append(data)
        elif kind == b"IEND":
            break
        elif kind == b"PLTE":
            if not data or len(data) % 3:
                raise ValueError(f"PNG palette of {len(data)} bytes")
            palette = np.frombuffer(data, np.uint8).reshape(-1, 3)
    if header is None or not idat:
        raise ValueError("PNG without IHDR or IDAT")
    w, h, depth, ctype, _, _, interlace = header
    if ctype not in _COLOR_TYPES or depth not in _COLOR_TYPES[ctype][1] or interlace > 1:
        raise ValueError(f"unsupported PNG: bit depth {depth}, color type {ctype}, "
                         f"interlace {interlace}")
    if ctype == 3 and palette is None:
        raise ValueError("palette PNG without a PLTE chunk")
    channels = _COLOR_TYPES[ctype][0]
    bpp = max(1, channels * depth // 8)
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    passes = _ADAM7 if interlace else ((0, 0, 1, 1),)
    sizes = [(-(-(w - x0) // dx), -(-(h - y0) // dy)) for x0, y0, dx, dy in passes]
    strides = [-(-pw * channels * depth // 8) for pw, _ in sizes]
    want = sum(ph * (st + 1) for (pw, ph), st in zip(sizes, strides) if pw and ph)
    if raw.size != want:
        raise ValueError("PNG image data has the wrong size")
    img = np.empty((h, w, channels), np.uint16 if depth == 16 else np.uint8)
    at = 0
    for (x0, y0, dx, dy), (pw, ph), st in zip(passes, sizes, strides):
        if not (pw and ph):
            continue
        rows = _unfilter(raw[at: at + ph * (st + 1)].reshape(ph, st + 1), ph, st, bpp)
        at += ph * (st + 1)
        img[y0::dy, x0::dx] = _samples(rows, pw, channels, depth)
    if ctype == 3:
        if int(img.max()) >= len(palette):
            raise ValueError(f"PNG palette index {int(img.max())} past its {len(palette)} "
                             f"colors")
        return palette[img[..., 0]]
    if depth == 16:
        img = np.minimum(img, 255) if ctype == 0 else img >> 8
    elif depth < 8:
        img = img * (255 // ((1 << depth) - 1))
    img = img.astype(np.uint8)
    return img[..., 0] if channels == 1 else img


def read_png(path: Any) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_png(f.read())



def to_rgb(arr: np.ndarray) -> np.ndarray:
    """A decoded uint8 gray, gray-and-alpha, RGB or RGBA array as RGB, as
    Pillow's ``convert("RGB")`` makes it (gray copied to the three channels,
    alpha dropped)."""
    if arr.ndim == 2 or arr.shape[2] <= 2:
        gray = arr if arr.ndim == 2 else arr[..., 0]
        return np.repeat(gray[..., None], 3, axis=2)
    return np.ascontiguousarray(arr[..., :3])


def decode_image(blob: bytes) -> Optional[np.ndarray]:
    """Image bytes -> uint8 ``[H, W, 3]`` RGB, the pixels of Pillow's
    ``Image.open(...).convert("RGB")``, or None where they do not decode.
    PNG goes through :func:`decode_png`, JPEG through the port's decoder
    (``ingest/rasterize.decode_jpeg``); neither needs Pillow, and a PNG or
    JPEG that they do not decode is None. Only another format (GIF, WebP,
    ...) is read by Pillow, where it is installed."""
    if blob[:8] == _SIGNATURE:
        try:
            return to_rgb(decode_png(blob))
        except (ValueError, zlib.error, struct.error):
            return None
    if blob[:2] == b"\xff\xd8":
        from multimodal_colpali_tpu_torch.ingest.rasterize import decode_jpeg

        return decode_jpeg(blob)
    try:
        import io

        from PIL import Image
    except ImportError:
        return None
    try:
        return np.asarray(Image.open(io.BytesIO(blob)).convert("RGB"))
    except Exception:  # noqa: BLE001 - any undecodable image is None
        return None
