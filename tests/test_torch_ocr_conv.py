"""The port's font-general OCR (``ingest/ocr_conv``) against the JAX package's,
on the CPU: ``GlyphNet`` logits against ``conv_ocr_logits`` on the same
weights, and identical text and runs on every fixture of
``tests/test_ocr_conv.py`` (DejaVu Sans and Serif, cmr10 ligatures, skew,
rotation, scale, scanned tables, ``AutoOcr`` routing), with the port's
classifier on the CPU (``device="cpu"``).
"""

import importlib
import itertools
import os
import uuid

import numpy as np
import pytest
import torch
from PIL import Image, ImageDraw, ImageFont

import jax.numpy as jnp
from multimodal_colpali_tpu.ingest import ocr_conv as J
from multimodal_colpali_tpu.ingest.pdfwrite import PdfWriter
from multimodal_colpali_tpu.models.processing import SimpleTokenizer as JTok
from multimodal_colpali_tpu_torch.ingest import ocr_conv as T
from multimodal_colpali_tpu_torch.ingest import rasterize as traster
from multimodal_colpali_tpu_torch.ingest.imageops import read_png
from multimodal_colpali_tpu_torch.models.processing import SimpleTokenizer

# float32 logits of up to ~70 from sums of 1,606 products in another order:
# 1e-5 and a millionth of the logit (the float32 step at 64 is 7.6e-6)
ATOL, RTOL = 1e-5, 1e-6

jloader = importlib.import_module("multimodal_colpali_tpu.ingest.pdf_loader")
tloader = importlib.import_module("multimodal_colpali_tpu_torch.ingest.pdf_loader")


def _font(name="DejaVuSans.ttf", size=22):
    import matplotlib

    path = os.path.join(os.path.dirname(matplotlib.__file__), "mpl-data", "fonts", "ttf", name)
    try:
        return ImageFont.truetype(path, size, layout_engine=ImageFont.Layout.BASIC)
    except (AttributeError, OSError):
        return ImageFont.truetype(path, size)


def _page_image(lines, font, size=(760, 980), y0=30, dy=40):
    im = Image.new("RGB", size, (255, 255, 255))
    d = ImageDraw.Draw(im)
    for i, item in enumerate(lines):
        if isinstance(item, str):
            d.text((30, y0 + dy * i), item, font=font, fill=(0, 0, 0))
        else:
            for x, text in item:
                d.text((x, y0 + dy * i), text, font=font, fill=(0, 0, 0))
    return im


def _scan_pdf(path, image):
    w = PdfWriter(width=image.width / 2, height=image.height / 2)
    w.add_page(image=np.asarray(image), image_rect=(0, 0, image.width / 2, image.height / 2))
    w.save(path)


@pytest.fixture(scope="module")
def engines():
    return J.ConvOcr(), T.ConvOcr(device="cpu")


def _same_reading(engines, image, **kw):
    jo, to = engines
    arr = np.asarray(image)
    got, want = to.recognize(arr, return_score=True), jo.recognize(arr, return_score=True)
    assert got[0] == want[0]
    assert abs(got[1] - want[1]) < 1e-5
    return got


# -- the classifier -------------------------------------------------------------

def test_glyphnet_logits_equal_conv_ocr_logits(engines):
    jo, to = engines
    rng = np.random.default_rng(0)
    patches = rng.uniform(0, 1, (37, T.PATCH, T.PATCH)).astype(np.float32)
    feats = rng.normal(0, 1, (37, T.N_FEATS)).astype(np.float32)
    want = np.asarray(J.conv_ocr_logits({k: jnp.asarray(v) for k, v in jo.params.items()},
                                        jnp.asarray(patches), jnp.asarray(feats)))
    got = to._forward(patches, feats)
    assert got.shape == want.shape == (37, len(T.CHARSET) + 1)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    # random weights through the converter, not only the trained file
    params = J.conv_ocr_init(seed=3)
    assert all(np.array_equal(params[k], v) for k, v in T.conv_ocr_init(seed=3).items())
    net = T.GlyphNet().eval()
    net.load_state_dict(T.glyphnet_state_from_params(params))
    with torch.no_grad():
        got = net(torch.from_numpy(patches), torch.from_numpy(feats)).numpy()
    want = np.asarray(J.conv_ocr_logits({k: jnp.asarray(v) for k, v in params.items()},
                                        jnp.asarray(patches), jnp.asarray(feats)))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_glyph_crops_equal_jax():
    rng = np.random.default_rng(1)
    ink = rng.random((60, 80)) < 0.4
    for box in ((0, 0, 79, 59), (3, 5, 9, 40), (10, 10, 10, 10), (20, 7, 75, 12)):
        np.testing.assert_array_equal(T._glyph_crop(ink, box), J._glyph_crop(ink, box))


def test_full_float32_turns_tf32_off_inside_only():
    before = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    with T.full_float32():
        assert not torch.backends.cudnn.allow_tf32
        assert not torch.backends.cuda.matmul.allow_tf32
    assert (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32) == before


def test_conv_ocr_defaults_to_the_card(monkeypatch):
    import inspect

    for cls in (T.ConvOcr, T.AutoOcr):
        assert inspect.signature(cls).parameters["device"].default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        T.ConvOcr()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        T.AutoOcr()


# -- tests/test_ocr_conv.py, both packages ----------------------------------------

@pytest.mark.parametrize("name", ["DejaVuSans.ttf", "DejaVuSerif.ttf"])
def test_conv_ocr_exact_on_dejavu(engines, name):
    im = _page_image(["Sialylated glycans bind selectin receptors",
                      "Measured binding was 12 nM at neutral pH"],
                     _font(name), size=(760, 110), y0=10)
    text, score = _same_reading(engines, im)
    assert text == ("Sialylated glycans bind selectin receptors\n"
                    "Measured binding was 12 nM at neutral pH")
    assert score > 0.85


def test_conv_ocr_ligatures_in_holdout_font(engines):
    im = _page_image(["final efficient"], _font("cmr10.ttf", size=34), size=(620, 80), y0=15)
    text, _ = _same_reading(engines, im)
    assert "final" in text and "efficient" in text


@pytest.mark.parametrize("size", [14, 20, 28, 40])
def test_conv_ocr_scale_sweep(engines, size):
    im = _page_image(["Selectins bind sialylated glycans"], _font(size=size),
                     size=(40 + 22 * size, 3 * size), y0=size // 2)
    text, _ = _same_reading(engines, im)
    assert text == "Selectins bind sialylated glycans"


def test_conv_ocr_runs_are_positioned(engines):
    jo, to = engines
    im = np.asarray(_page_image([list(zip([40, 300], ["alpha", "beta"]))],
                                _font(size=20), size=(600, 70), y0=15))
    runs = to.recognize_runs(im, dpi=72.0)
    assert runs == jo.recognize_runs(im, dpi=72.0)
    words = {w: (x, y) for x, y, _, w in runs}
    assert set(words) == {"alpha", "beta"}


def test_estimate_skew_and_deskew_equal_jax():
    im = _page_image([f"Skew estimation reference line {i}" for i in range(8)], _font(),
                     size=(760, 400), y0=30)
    for rot in (0.0, -2.0, 1.5):
        r = np.asarray(im.rotate(rot, resample=Image.BILINEAR, fillcolor=(255,) * 3))
        a = T.estimate_skew(T.binarize(r))
        assert a == J.estimate_skew(J.binarize(r))
        assert abs(a - rot) <= 0.15
        if a:
            np.testing.assert_array_equal(T.deskew(T._to_gray(r), a), J.deskew(J._to_gray(r), a))


def test_rotated_pages_read_equal_jax(engines):
    jo, to = engines
    base = _page_image(["Selectin ligands were characterized",
                        "Measurements repeated across cohorts"],
                       _font("DejaVuSerif.ttf", size=24), size=(820, 160), y0=20, dy=60)
    for rot in (Image.Transpose.ROTATE_90, Image.Transpose.ROTATE_180):
        arr = np.asarray(base.transpose(rot))
        gray = T._to_gray(arr)
        assert to.detect_orientation(gray) == jo.detect_orientation(gray)
        text, _ = _same_reading(engines, arr)
        assert "Selectin ligands were characterized" in text


def test_auto_ocr_routes_by_dialect_equal_jax():
    src = PdfWriter()
    src.add_page(text_lines=["GLYCANS BIND SELECTINS"], font_size=12)
    native = traster.PdfDocument(src.tobytes()).render(0, dpi=144)
    ja, ta = J.AutoOcr(), T.AutoOcr(device="cpu")
    assert ta.template.recognize(native, return_score=True) == \
        ja.template.recognize(native, return_score=True)
    assert ta.recognize(native) == ja.recognize(native)
    assert "GLYCANS BIND SELECTINS" in ta.recognize(native)
    foreign = np.asarray(_page_image(["Glycans bind selectins"], _font(), size=(600, 70), y0=15))
    _, s2 = ta.template.recognize(foreign, return_score=True)
    assert s2 < ta.threshold
    assert ta.recognize(foreign) == ja.recognize(foreign)
    assert "Glycans bind selectins" in ta.recognize(foreign)


def _loaders_on(monkeypatch, tmp_path, path, name):
    out = {}
    for tag, fn, tok, extra in (("jax", jloader.pdf_loader, JTok(1000, 999), {}),
                                ("port", tloader.pdf_loader, SimpleTokenizer(1000, 999),
                                 {"device": "cpu"})):
        counter = itertools.count()
        monkeypatch.setattr(uuid, "uuid4", lambda: uuid.UUID(int=next(counter)))
        vd = str(tmp_path / f"vd_{tag}")
        out[tag] = fn([path], [""], [name], vd, tok, **extra), vd
    (tm, tt), tvd = out["port"]
    (jm, jt), jvd = out["jax"]
    for got, want in ((tm, jm), (tt, jt)):
        assert [d.page_content for d in got] == [d.page_content for d in want]
        for g, w in zip(got, want):
            gm, wm = dict(g.metadata), dict(w.metadata)
            g_link, w_link = gm.pop("img_link"), wm.pop("img_link")
            assert gm == wm
            if g_link:
                assert os.path.relpath(g_link, tvd) == os.path.relpath(w_link, jvd)
                np.testing.assert_array_equal(read_png(g_link), np.asarray(Image.open(w_link)))
    return tm, tt


def test_scanned_foreign_font_roundtrips_equal_jax(monkeypatch, tmp_path):
    im = _page_image(["Glycans mediate selectin adhesion", "Binding constants reach 12 nM"],
                     _font(), size=(760, 130), y0=20)
    p = str(tmp_path / "foreign_scan.pdf")
    _scan_pdf(p, im)
    assert tloader.check_ocr(p)
    _, texts = _loaders_on(monkeypatch, tmp_path, p, "foreign_scan.pdf")
    joined = " ".join(d.page_content for d in texts)
    assert "Glycans mediate selectin adhesion" in joined
    assert "Binding constants reach 12 nM" in joined


def test_scanned_table_detected_from_ocr_runs_equal_jax(monkeypatch, tmp_path):
    cols = [40, 260, 480]
    rows = ["Table 1 Binding strengths",
            list(zip(cols, ["Ligand", "Receptor", "Strength"])),
            list(zip(cols, ["sLex", "Eselectin", "12"])),
            list(zip(cols, ["sLea", "Pselectin", "34"]))]
    im = _page_image(rows, _font(size=20), size=(720, 240), y0=20, dy=42)
    p = str(tmp_path / "scan_table.pdf")
    _scan_pdf(p, im)
    multi, _ = _loaders_on(monkeypatch, tmp_path, p, "scan_table.pdf")
    tables = [d for d in multi if d.metadata["type"] == "table"]
    assert tables and "sLex" in tables[0].page_content
    assert tables[0].metadata["caption"].startswith("Table 1")


def test_skewed_scan_roundtrips_equal_jax(monkeypatch, tmp_path):
    im = _page_image(["Glycans mediate selectin adhesion", "Binding constants reach 12 nM",
                      "Sialylated structures dominate the corpus"],
                     _font("DejaVuSerif.ttf", size=26), size=(1000, 240), y0=25, dy=60)
    rot = im.rotate(1.5, resample=Image.BILINEAR, fillcolor=(255,) * 3, expand=True)
    scale = 72.0 / 200.0
    w = PdfWriter(width=rot.width * scale, height=rot.height * scale)
    w.add_page(image=np.asarray(rot), image_rect=(0, 0, rot.width * scale, rot.height * scale))
    p = str(tmp_path / "skewed_scan.pdf")
    w.save(p)
    _, texts = _loaders_on(monkeypatch, tmp_path, p, "skewed_scan.pdf")
    joined = " ".join(d.page_content for d in texts)
    assert "Sialylated structures dominate the corpus" in joined


def test_ocr_pdf_surfaces_equal_jax(tmp_path):
    """``ConvOcr.__call__`` / ``pdf_text_and_runs`` and ``AutoOcr``'s on a
    scanned PDF of two small pages, one native and one foreign."""
    src = PdfWriter(width=300, height=120)
    src.add_page(text_lines=["NATIVE DIALECT PAGE 7"], font_size=12, start_y=80)
    w = PdfWriter(width=300, height=120)
    w.add_page(image=traster.PdfDocument(src.tobytes()).render(0, dpi=144.0),
               image_rect=(0, 0, 300, 120))
    w.add_page(image=np.asarray(_page_image(["Foreign dialect page"], _font(),
                                            size=(600, 240), y0=90)),
               image_rect=(0, 0, 300, 120))
    p = str(tmp_path / "two.pdf")
    w.save(p)
    ja, ta = J.AutoOcr(), T.AutoOcr(device="cpu")
    texts = ta(p)
    assert texts == ja(p)
    assert ta.pdf_text_and_runs(p) == ja.pdf_text_and_runs(p)
    assert ta.conv(p) == ja.conv(p)
    assert "NATIVE DIALECT PAGE 7" in texts[0] and "Foreign dialect page" in texts[1]
