"""The port's Pillow-free image operations (``ingest/imageops``) and
``resize_image`` against Pillow and against the JAX package's
``resize_image``, on the CPU.

``imageops.resize`` must give Pillow's bytes exactly: on a numpy array (the
host int64 path, the plain version) and on a torch tensor (the float64 path
the card runs, here on the CPU), for BILINEAR, BICUBIC and LANCZOS, RGB and
gray, up and down, 1-px edges and odd ratios. PNGs go both ways between the
port and Pillow with equal pixels.
"""

import io
import struct
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

from multimodal_colpali_tpu.ingest.preprocess import resize_image as jresize_image
from multimodal_colpali_tpu_torch.ingest import imageops
from multimodal_colpali_tpu_torch.ingest.preprocess import resize_image

PIL_FILTERS = {"bilinear": Image.BILINEAR, "bicubic": Image.BICUBIC,
               "lanczos": Image.LANCZOS}


def _pillow(a, size, name):
    return np.asarray(Image.fromarray(a).resize(size, PIL_FILTERS[name]))


def _both(a, size, name):
    host = imageops.resize(a, size, name)
    dev = imageops.resize(torch.from_numpy(a), size, name)
    assert isinstance(host, np.ndarray) and isinstance(dev, torch.Tensor)
    assert host.dtype == np.uint8 and dev.dtype == torch.uint8
    return host, dev.numpy()


@pytest.mark.parametrize("name", sorted(PIL_FILTERS))
@pytest.mark.parametrize("gray", [False, True], ids=["rgb", "gray"])
def test_resize_equals_pillow_on_random_shapes(name, gray):
    rng = np.random.default_rng(zlib.crc32(f"{name}{gray}".encode()))
    for _ in range(12):
        h, w = (int(v) for v in rng.integers(1, 90, 2))
        oh, ow = (int(v) for v in rng.integers(1, 130, 2))
        a = rng.integers(0, 256, (h, w) if gray else (h, w, 3)).astype(np.uint8)
        want = _pillow(a, (ow, oh), name)
        host, dev = _both(a, (ow, oh), name)
        np.testing.assert_array_equal(host, want, err_msg=f"{name} {a.shape}->{(oh, ow)}")
        np.testing.assert_array_equal(dev, want, err_msg=f"{name} {a.shape}->{(oh, ow)}")


@pytest.mark.parametrize("name", sorted(PIL_FILTERS))
@pytest.mark.parametrize("src,dst", [
    ((1, 1), (7, 5)), ((5, 7), (1, 1)), ((1, 40), (1, 13)), ((40, 1), (3, 40)),
    ((37, 53), (53, 37)), ((100, 3), (33, 301)), ((64, 64), (64, 21)), ((64, 64), (21, 64)),
    ((97, 89), (97, 89))], ids=lambda v: "x".join(map(str, v)))
def test_resize_edges_and_odd_ratios(name, src, dst):
    rng = np.random.default_rng(7)
    a = rng.integers(0, 256, src + (3,)).astype(np.uint8)
    # extreme values exercise the clip at 0 and 255 (LANCZOS and BICUBIC overshoot)
    a[::2, ::3] = 0
    a[1::2, 1::3] = 255
    want = _pillow(a, dst[::-1], name)
    host, dev = _both(a, dst[::-1], name)
    np.testing.assert_array_equal(host, want)
    np.testing.assert_array_equal(dev, want)


def test_resize_page_sizes_of_the_main_path():
    """A letter page at 144 DPI to ``resize_image``'s size (LANCZOS), then
    to ColPali's 448 (BICUBIC): the two resizes of the ingest path."""
    rng = np.random.default_rng(3)
    page = np.full((1584, 1224, 3), 255, np.uint8)
    for _ in range(60):
        y, x = rng.integers(0, 1570), rng.integers(0, 900)
        page[y: y + 12, x: x + rng.integers(20, 320)] = rng.integers(0, 120)
    page[400:700, 200:600] = rng.integers(0, 256, (300, 400, 3))
    mid = _pillow(page, (1005, 1300), "lanczos")
    host, dev = _both(page, (1005, 1300), "lanczos")
    np.testing.assert_array_equal(host, mid)
    np.testing.assert_array_equal(dev, mid)
    want = _pillow(mid, (448, 448), "bicubic")
    host, dev = _both(mid, (448, 448), "bicubic")
    np.testing.assert_array_equal(host, want)
    np.testing.assert_array_equal(dev, want)


def test_coefficients_are_pillow_s_fixed_point_weights():
    """Each window's 22-bit weights sum to 2^22 within the rounding of its
    taps, start where Pillow's ``int(center - support + 0.5)`` starts, and
    are zero past the window."""
    for name in PIL_FILTERS:
        for n_in, n_out in ((1224, 1005), (1005, 448), (13, 40), (1, 3)):
            first, kk = imageops.coefficients(n_in, n_out, name)
            assert kk.dtype == np.int64 and first.shape == (n_out,)
            assert not kk.flags.writeable
            assert (np.abs(kk.sum(axis=1) - (1 << 22)) <= kk.shape[1]).all()
            assert (first >= 0).all() and (first < n_in).all()
    assert imageops.coefficients(10, 5, "bicubic") is imageops.coefficients(10, 5, "bicubic")


def test_resize_same_size_is_a_copy_and_bad_inputs_raise():
    a = np.arange(24, dtype=np.uint8).reshape(2, 4, 3)
    out = imageops.resize(a, (4, 2), "lanczos")
    np.testing.assert_array_equal(out, a)
    assert not np.shares_memory(out, a)
    with pytest.raises(ValueError, match="filter"):
        imageops.resize(a, (3, 3), "nearest")
    with pytest.raises(ValueError, match="uint8"):
        imageops.resize(a.astype(np.float32), (3, 3))
    with pytest.raises(ValueError, match="positive"):
        imageops.resize(a, (0, 3))


@pytest.mark.parametrize("size", [(100, 300), (3000, 1000), (500, 700), (1224, 1584),
                                  (223, 224), (50, 2000), (1301, 40), (224, 1300)])
def test_resize_image_equals_the_jax_package(size):
    """``resize_image`` at its edges (upscale, downscale, in range, both at
    once), arrays and tensors, against JAX's on the same pixels."""
    w, h = size
    rng = np.random.default_rng(w * 7 + h)
    a = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
    want = np.asarray(jresize_image(Image.fromarray(a)))
    got = resize_image(a)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(resize_image(torch.from_numpy(a)).numpy(), want)
    if want.shape == a.shape:
        assert got is a                         # in range: returned as it is
    assert min(want.shape[:2]) >= 224 or max(want.shape[:2]) == 1300


def test_crop_equals_pillow():
    rng = np.random.default_rng(5)
    a = rng.integers(0, 256, (30, 40, 3)).astype(np.uint8)
    for box in ((0, 0, 40, 30), (5, 7, 19, 23), (-4, -3, 12, 9), (30, 20, 50, 41),
                (10, 10, 10, 10)):
        want = np.asarray(Image.fromarray(a).crop(box))
        np.testing.assert_array_equal(imageops.crop(a, box), want)
    with pytest.raises(ValueError):
        imageops.crop(a, (5, 0, 4, 3))


@pytest.mark.parametrize("shape", [(17, 23), (17, 23, 3), (17, 23, 4), (1, 1, 3), (300, 2)])
def test_png_both_ways_with_pillow(tmp_path, shape):
    rng = np.random.default_rng(len(shape) * 100 + shape[0])
    a = rng.integers(0, 256, shape).astype(np.uint8)
    mine = tmp_path / "mine.png"
    imageops.write_png(mine, a)
    np.testing.assert_array_equal(np.asarray(Image.open(mine)), a)
    theirs = tmp_path / "theirs.png"
    Image.fromarray(a).save(theirs, format="PNG")
    np.testing.assert_array_equal(imageops.read_png(theirs), a)
    np.testing.assert_array_equal(imageops.read_png(mine), a)
    imageops.write_png(mine, torch.from_numpy(a))          # a tensor is copied to the host
    np.testing.assert_array_equal(imageops.read_png(mine), a)


def test_png_reader_takes_every_filter_type():
    """Pillow's optimizing writer picks a filter a row; smooth, noisy and
    flat regions make it use several. Each of the five is also written by
    hand."""
    rng = np.random.default_rng(11)
    a = np.zeros((64, 48, 3), np.uint8)
    a[:16] = rng.integers(0, 256, (16, 48, 3))
    a[16:32] = np.arange(48, dtype=np.uint8)[None, :, None] * 5
    a[32:48] = np.arange(16, dtype=np.uint8)[:, None, None] * 9
    a[48:] = 77
    buf = io.BytesIO()
    Image.fromarray(a).save(buf, format="PNG", optimize=True)
    np.testing.assert_array_equal(imageops.decode_png(buf.getvalue()), a)

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    def paeth(a_, b, c):
        p = a_ + b - c
        pa, pb, pc = abs(p - a_), abs(p - b), abs(p - c)
        return a_ if pa <= pb and pa <= pc else (b if pb <= pc else c)

    img = rng.integers(0, 256, (5, 7, 3)).astype(np.uint8)
    rows, bpp = img.reshape(5, -1).astype(int), 3
    raw = b""
    for y in range(5):
        kind = y % 5
        prior = rows[y - 1] if y else np.zeros_like(rows[0])
        out = []
        for i, x in enumerate(rows[y]):
            left = rows[y][i - bpp] if i >= bpp else 0
            upleft = prior[i - bpp] if i >= bpp else 0
            pred = [0, left, prior[i], (left + prior[i]) // 2,
                    paeth(left, prior[i], upleft)][kind]
            out.append((x - pred) % 256)
        raw += bytes([kind] + out)
    blob = (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", 7, 5, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))
    np.testing.assert_array_equal(imageops.decode_png(blob), img)
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(blob))), img)


def _chunk(kind, data):
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def _png(samples, ctype, depth, interlace=0, palette=None, trns=None, seed=0):
    """A PNG written by hand: ``samples`` ``[H, W, C]`` at ``depth`` bits,
    packed and filtered (every filter type, rows chosen at random), one pass
    or Adam7's seven, the data split over two IDAT chunks."""
    rng = np.random.default_rng(seed)
    h, w, c = samples.shape
    bpp = max(1, c * depth // 8)
    passes = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4),
              (1, 0, 2, 2), (0, 1, 1, 2)) if interlace else ((0, 0, 1, 1),)
    raw = b""
    for x0, y0, dx, dy in passes:
        sub = samples[y0::dy, x0::dx]
        if sub.size == 0:
            continue
        if depth == 16:
            rows = sub.astype(">u2").reshape(sub.shape[0], -1).view(np.uint8).astype(int)
        elif depth == 8:
            rows = sub.reshape(sub.shape[0], -1).astype(int)
        else:
            bits = ((sub.reshape(sub.shape[0], -1, 1).astype(np.uint8)
                     >> np.arange(depth - 1, -1, -1, dtype=np.uint8)) & 1)
            rows = np.packbits(bits.reshape(sub.shape[0], -1), axis=1).astype(int)
        prior = np.zeros(rows.shape[1], int)
        for row in rows:
            kind = int(rng.integers(0, 5))
            out = []
            for i, x in enumerate(row):
                left = row[i - bpp] if i >= bpp else 0
                ul = prior[i - bpp] if i >= bpp else 0
                pa, pb, pc = abs(prior[i] - ul), abs(left - ul), abs(left + prior[i] - 2 * ul)
                paeth = left if pa <= pb and pa <= pc else (prior[i] if pb <= pc else ul)
                pred = [0, left, prior[i], (left + prior[i]) // 2, paeth][kind]
                out.append((x - pred) % 256)
            raw += bytes([kind] + out)
            prior = row
    blob = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype,
                                                                 0, 0, interlace))
    if palette is not None:
        blob += _chunk(b"PLTE", palette.astype(np.uint8).tobytes())
    if trns is not None:
        blob += _chunk(b"tRNS", trns)
    z = zlib.compress(bytes(raw))                  # in two IDAT chunks
    return (blob + _chunk(b"IDAT", z[: len(z) // 2]) + _chunk(b"IDAT", z[len(z) // 2:])
            + _chunk(b"IEND", b""))


KINDS = [(0, 1), (0, 2), (0, 4), (0, 8), (0, 16), (2, 8), (2, 16), (3, 1), (3, 2), (3, 4),
         (3, 8), (4, 8), (4, 16), (6, 8), (6, 16)]


@pytest.mark.parametrize("interlace", [0, 1])
@pytest.mark.parametrize("ctype,depth", KINDS)
def test_png_reader_takes_every_color_type_and_depth(ctype, depth, interlace):
    """Every color type at every bit depth the standard allows, plain and
    Adam7-interlaced, at sizes that leave some of Adam7's passes empty:
    ``decode_image`` gives Pillow's ``convert("RGB")`` pixels, and
    ``decode_png`` Pillow's values in its own mode."""
    rng = np.random.default_rng(ctype * 100 + depth + 7 * interlace)
    channels = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
    for h, w in ((1, 1), (3, 2), (9, 13), (20, 7)):
        top = 1 << depth
        palette = trns = None
        if ctype == 3:
            n = min(top, 11)
            palette = rng.integers(0, 256, (n, 3))
            samples = rng.integers(0, n, (h, w, 1))
            trns = bytes(rng.integers(0, 256, n // 2, dtype=np.uint8))
        else:
            samples = rng.integers(0, top, (h, w, channels))
            if depth == 16 and ctype == 0:      # values on both sides of 255
                samples[::2] = rng.integers(0, 300, samples[::2].shape)
            if ctype in (0, 2):
                trns = b"\x00\x01" * channels
        blob = _png(samples, ctype, depth, interlace, palette, trns, seed=h * w)
        want = Image.open(io.BytesIO(blob))
        np.testing.assert_array_equal(imageops.decode_image(blob),
                                      np.asarray(want.convert("RGB")))
        mode = {0: "L", 2: "RGB", 3: "RGB", 4: "LA", 6: "RGBA"}[ctype]
        np.testing.assert_array_equal(imageops.decode_png(blob), np.asarray(want.convert(mode)))


def test_png_refuses_what_it_does_not_read(tmp_path):
    """What is not a valid PNG raises in ``decode_png`` and is None in
    ``decode_image``: a bit depth its color type does not allow, an
    unknown interlace method, a palette image without a palette or with an
    index past it, a bad CRC, data of the wrong size, not a PNG."""
    blob = imageops.encode_png(np.zeros((4, 4, 3), np.uint8))
    for depth, ctype, interlace in ((4, 2, 0), (16, 3, 0), (8, 5, 0), (8, 2, 2)):
        ihdr = struct.pack(">IIBBBBB", 4, 4, depth, ctype, 0, 0, interlace)
        bad = blob[:8] + _chunk(b"IHDR", ihdr) + blob[33:]
        with pytest.raises(ValueError, match="unsupported"):
            imageops.decode_png(bad)
        assert imageops.decode_image(bad) is None
    pal = _png(np.array([[[0], [1]], [[2], [1]]]), 3, 8, palette=np.zeros((3, 3)))
    past = _png(np.array([[[0], [3]], [[2], [1]]]), 3, 8, palette=np.zeros((3, 3)))
    np.testing.assert_array_equal(imageops.decode_png(pal), np.zeros((2, 2, 3), np.uint8))
    with pytest.raises(ValueError, match="palette index 3"):
        imageops.decode_png(past)
    no_plte = _png(np.array([[[0]]]), 3, 8)
    with pytest.raises(ValueError, match="without a PLTE"):
        imageops.decode_png(no_plte)
    short = blob[:33] + _chunk(b"IDAT", zlib.compress(b"\x00" * 10)) + _chunk(b"IEND", b"")
    with pytest.raises(ValueError, match="wrong size"):
        imageops.decode_png(short)
    bad = bytearray(blob)
    bad[30] ^= 0xFF                                # a byte of the IHDR CRC
    with pytest.raises(ValueError, match="CRC"):
        imageops.decode_png(bytes(bad))
    with pytest.raises(ValueError, match="PNG"):
        imageops.decode_png(b"GIF89a")
    for data in (past, no_plte, short, bytes(bad)):
        assert imageops.decode_image(data) is None
    with pytest.raises(ValueError, match="uint8"):
        imageops.encode_png(np.zeros((4, 4, 2), np.uint8))


def test_normalize_on_takes_the_host_s_float32_steps():
    """``processing.normalize_on`` (the card's normalization) against numpy's
    three float32 operations, on every byte value, with SigLIP's and
    ImageNet's statistics."""
    from multimodal_colpali_tpu_torch.models.processing import normalize_on
    from multimodal_colpali_tpu_torch.models.processing_florence2 import (
        IMAGENET_MEAN, IMAGENET_STD)

    a = np.arange(256, dtype=np.float32).repeat(3).reshape(1, 16, 16, 3)
    for mean, std in ((0.5, 0.5), (IMAGENET_MEAN, IMAGENET_STD)):
        want = a.copy()
        want /= 255.0
        want -= mean
        want /= std
        got = normalize_on(torch.from_numpy(a), mean, std)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want)
