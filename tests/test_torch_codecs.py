"""Images and tables without Pillow or pandas: the port's JPEG encoder and
decoder (``native/jpeg``, through ``ingest/rasterize``), the data URLs of
``generation/messages.py``, the server's image decoding (``GenerationServer``
with Pillow blocked), and ``drivers/_table.py`` against pandas.

Pillow and pandas are the references here: the JPEG bytes must equal
Pillow's, the decoded pixels Pillow's, the PNG pixels Pillow's (the PNG
bytes differ by design: every row Up-filtered), the tables pandas' values,
types, permutations and CSV text.
"""

from __future__ import annotations

import base64
import io
import json
import math
import sys
import urllib.request

import numpy as np
import pandas as pd
import pytest
from PIL import Image

from multimodal_colpali_tpu.generation import messages as jmsg
from multimodal_colpali_tpu_torch.drivers._table import Table, read_table
from multimodal_colpali_tpu_torch.generation import messages as tmsg
from multimodal_colpali_tpu_torch.generation import server as tserver
from multimodal_colpali_tpu_torch.ingest.imageops import decode_image
from multimodal_colpali_tpu_torch.ingest.rasterize import decode_jpeg, encode_jpeg


def _page(h, w, seed):
    """A page-like image: white, dark text bars, a coloured block, a gradient."""
    rng = np.random.default_rng(seed)
    page = np.full((h, w, 3), 255, np.uint8)
    for _ in range(12):
        y, x = rng.integers(0, max(h - 6, 1)), rng.integers(0, max(w // 3, 1))
        page[y: y + 4, x: x + rng.integers(1, max(w - x, 2))] = rng.integers(0, 90)
    page[h // 3: h // 2, w // 4: w // 2] = rng.integers(0, 256, 3)
    page[-h // 5:, :, 0] = np.linspace(0, 255, w).astype(np.uint8)
    return page


def _noise(h, w, seed):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3), dtype=np.uint8)


def _pillow_jpeg(a, **kw):
    buf = io.BytesIO()
    Image.fromarray(a).save(buf, format="JPEG", **kw)
    return buf.getvalue()


SIZES = [(1, 1), (7, 9), (8, 8), (16, 16), (17, 33), (50, 80), (240, 320), (333, 251),
         (1448, 1024)]


@pytest.mark.parametrize("h,w", SIZES)
@pytest.mark.parametrize("kind", ["page", "noise"])
def test_jpeg_bytes_equal_pillow(h, w, kind):
    a = (_page if kind == "page" else _noise)(h, w, h * 7 + w)
    want = _pillow_jpeg(a)
    assert encode_jpeg(a) == want
    # and the decoder gives Pillow's pixels for it
    np.testing.assert_array_equal(decode_jpeg(want),
                                  np.asarray(Image.open(io.BytesIO(want)).convert("RGB")))


@pytest.mark.parametrize("quality", [1, 30, 50, 90, 95, 100])
def test_jpeg_bytes_equal_pillow_at_other_qualities(quality):
    a = _page(120, 200, quality)
    assert encode_jpeg(a, quality=quality) == _pillow_jpeg(a, quality=quality)


@pytest.mark.parametrize("subsampling,sampling", [(0, (1, 1)), (1, (2, 1)), (2, (2, 2)),
                                                ("gray", None)])
@pytest.mark.parametrize("h,w", [(1, 1), (9, 17), (31, 5), (240, 320)])
def test_jpeg_bytes_equal_pillow_at_each_of_its_samplings_and_in_gray(h, w, subsampling,
                                                                      sampling):
    """Pillow's 4:4:4, 4:2:2 and 4:2:0 and its gray JPEGs, byte for byte, at
    two qualities."""
    a = _page(h, w, h + w)
    for quality in (75, 40):
        if sampling is None:
            assert encode_jpeg(a[..., 1], quality) == _pillow_jpeg(a[..., 1], quality=quality)
        else:
            assert encode_jpeg(a, quality, sampling) == _pillow_jpeg(
                a, quality=quality, subsampling=subsampling)


def test_jpeg_encoder_refuses_what_libjpeg_refuses():
    """Sampling factors past 4 or blocks past 10 an MCU, a restart interval
    past 65,535, other shapes and types raise."""
    a = _page(20, 30, 0)
    for kw in ({"sampling": (5, 1)}, {"sampling": (3, 3)}, {"sampling": (0, 1)},
               {"restart_interval": 65536}):
        with pytest.raises(ValueError, match="failed"):
            encode_jpeg(a, **kw)
    for bad in (a[..., :2], a.astype(np.int16), a[:0]):
        with pytest.raises(ValueError, match="uint8"):
            encode_jpeg(bad)


def test_decoder_takes_pillow_s_other_jpegs_and_refuses_damage():
    a = _page(90, 130, 3)
    for kw in ({"subsampling": 0}, {"subsampling": 1}, {"progressive": True},
               {"optimize": True}):
        blob = _pillow_jpeg(a, **kw)
        np.testing.assert_array_equal(decode_jpeg(blob),
                                      np.asarray(Image.open(io.BytesIO(blob)).convert("RGB")))
    gray = io.BytesIO()
    Image.fromarray(a[..., 0]).save(gray, format="JPEG")
    np.testing.assert_array_equal(decode_jpeg(gray.getvalue()),
                                  np.asarray(Image.open(gray).convert("RGB")))
    assert decode_jpeg(b"\xff\xd8\xff\xdb\x00") is None
    assert decode_jpeg(b"not a jpeg") is None
    assert decode_image(b"not an image at all") is None


@pytest.mark.parametrize("h,w", [(50, 80), (300, 211), (1800, 1400)])
def test_context_data_urls_equal_jax(h, w):
    """Driver 05's JPEG data URLs (width 1,024, LANCZOS, Pillow's defaults)
    from an array, a PIL image and a tensor equal the JAX module's bytes."""
    import torch

    a = _page(h, w, 11)
    want = jmsg.pil_image_to_data_url(Image.fromarray(a))
    assert tmsg.pil_image_to_data_url(a) == want
    assert tmsg.pil_image_to_data_url(Image.fromarray(a)) == want
    assert tmsg.pil_image_to_data_url(torch.from_numpy(a)) == want
    assert (tmsg.image_context_messages([a, a[: h // 2]], 256)
            == jmsg.image_context_messages([Image.fromarray(a),
                                            Image.fromarray(a[: h // 2])], 256))


def _pixels(url):
    return np.asarray(Image.open(io.BytesIO(base64.b64decode(url.split(",", 1)[1])))
                      .convert("RGB"))


@pytest.mark.parametrize("mode", ["RGB", "L", "RGBA", "P", "JPEG"])
def test_png_data_urls_have_pillow_s_pixels(tmp_path, mode):
    """Driver 02's PNG data URLs from page files: the pixels of JAX's."""
    a = _page(230, 170, 5)
    path = tmp_path / ("p.jpg" if mode == "JPEG" else "p.png")
    img = Image.fromarray(a)
    if mode == "JPEG":
        img.save(path, format="JPEG")
    else:
        img.convert(mode).save(path)
    got, want = tmsg.encode_image_to_data_url(str(path)), jmsg.encode_image_to_data_url(str(path))
    assert got.startswith("data:image/png;base64,") and want.startswith("data:image/png;base64,")
    np.testing.assert_array_equal(_pixels(got), _pixels(want))
    assert tmsg.encode_image_to_data_url(str(tmp_path / "missing.png")) is None


class _Recorder:
    """A bare engine, an image engine and a preprocessor that record what the
    server hands them."""

    def __init__(self):
        self.images = []
        self.eos_id = 1

    def generate(self, prompts, *args, **kw):
        return [[66] for _ in prompts]

    def build_mm_prompt(self, ids, bos_id, newline_ids, n_images):
        return [bos_id] + list(ids)

    def preprocess(self, images):
        self.images.append([np.array(im) for im in images])
        return np.zeros((len(images), 2, 2, 3), np.float32)


class _Tok:
    eos_id, bos_id = 1, 2

    def encode(self, text, add_special_tokens=False):
        return [3 + (b % 50) for b in text.encode()][:40]

    def decode(self, ids):
        return "".join(chr(i) for i in ids)


def test_server_decodes_png_and_jpeg_without_pillow(monkeypatch):
    """With Pillow blocked, a request's PNG and JPEG data URLs reach the
    image preprocessor as Pillow's pixels; a bad one is skipped; ``/stats``
    counts them."""
    a, b = _page(60, 90, 1), _noise(33, 47, 2)
    png = tmsg.pil_image_to_data_url(a, 90, "PNG")
    jpg = "data:image/jpeg;base64," + base64.b64encode(_pillow_jpeg(b)).decode()
    want_jpg = np.asarray(Image.open(io.BytesIO(_pillow_jpeg(b))).convert("RGB"))
    for name in [m for m in sys.modules if m == "PIL" or m.startswith("PIL.")]:
        monkeypatch.setitem(sys.modules, name, None)
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError):
        import PIL.Image  # noqa: F401
    rec = _Recorder()
    srv = tserver.GenerationServer(rec, _Tok(), mm_engine=rec, image_preprocessor=rec.preprocess)
    with srv:
        content = [{"type": "text", "text": "which page?"},
                   {"type": "image_url", "image_url": {"url": png}},
                   {"type": "image_url", "image_url": {"url": jpg}},
                   {"type": "image_url", "image_url": {"url": "data:image/png;base64,AAAA"}}]
        body = json.dumps({"model": "m", "messages": [{"role": "user", "content": content}],
                           "max_tokens": 2}).encode()
        req = urllib.request.Request(srv.base_url + "/chat/completions", data=body,
                                     headers={"Content-Type": "application/json"})
        out = json.loads(urllib.request.urlopen(req, timeout=30).read())
        assert out["choices"][0]["message"]["content"] == "B"
        stats = json.loads(urllib.request.urlopen(
            srv.base_url.removesuffix("/v1") + "/stats", timeout=30).read())
    assert len(rec.images) == 1 and len(rec.images[0]) == 2
    np.testing.assert_array_equal(rec.images[0][0], a)
    np.testing.assert_array_equal(rec.images[0][1], want_jpg)
    assert stats == {"requests": 1, "images_decoded": 2, "images_skipped": 1,
                     "images_per_request": {"2": 1}}


# -- tables --------------------------------------------------------------------------

def _frame():
    return pd.DataFrame({
        "Question_nr": [4, 1, 3, 2, 5],
        "question": ['What, "binds" selectins?', "plain", "multi\nline", "x", "é ü"],
        "A": ["a1", "a2", "a3", "a4", "a5"],
        "score": [1.5, math.nan, 2.0, -0.1, 1e-7],
        "part": [1, None, 3, 4, 5],
        "flag": [True, False, True, True, False],
        "maybe": [True, None, False, True, None],
        "refs": ["['P1_pg_0', 'P2_pg_3']", "[]", "['a,b']", "", "['x']"],
        "empty": [None] * 5,
    })


def _values(col):
    return [None if isinstance(v, float) and math.isnan(v) else v for v in col]


@pytest.mark.parametrize("seed", [None, 0, 3])
def test_table_read_shuffle_write_equal_pandas(tmp_path, seed):
    path = tmp_path / "q.csv"
    _frame().to_csv(path, index=False)
    df, t = pd.read_csv(path), read_table(str(path))
    assert list(t.columns) == list(df.columns)
    for name in df.columns:
        assert _values(t[name]) == _values(df[name].tolist()), name
        assert [type(v) for v in t[name]] == [type(v) for v in df[name].tolist()], name
    if seed is None:
        np.random.seed(11)
        want = df.sample(frac=1, random_state=None).reset_index(drop=True)
        np.random.seed(11)
        got = t.sample(None)
    else:
        want = df.sample(frac=1, random_state=seed).reset_index(drop=True)
        got = t.sample(seed)
    assert got["Question_nr"] == want["Question_nr"].tolist()
    assert got.to_csv() == want.to_csv(index=False)
    out = got.with_column("Model", "gpt-5").with_column("Answer", list("ABCDA"))
    want = want.copy()
    want["Model"] = "gpt-5"
    want["Answer"] = list("ABCDA")
    want["Cor"] = (want["Answer"] == want["A"]).astype(int)
    out = out.with_column("Cor", [int(x == y) for x, y in zip(out["Answer"], out["A"])])
    out.to_csv(tmp_path / "o.csv")
    assert (tmp_path / "o.csv").read_text() == want.to_csv(index=False)


def test_xlsx_path_reads_the_csv_beside_it(tmp_path):
    _frame().to_csv(tmp_path / "bench.csv", index=False)
    assert read_table(str(tmp_path / "bench.xlsx")).to_csv() == \
        pd.read_csv(tmp_path / "bench.csv").to_csv(index=False)
    with pytest.raises(FileNotFoundError):
        read_table(str(tmp_path / "none.xlsx"))
    (tmp_path / "only.xlsx").write_bytes(b"PK")
    with pytest.raises(RuntimeError, match="Excel"):
        read_table(str(tmp_path / "only.xlsx"))
    assert len(Table({"a": [1, 2]})) == 2
