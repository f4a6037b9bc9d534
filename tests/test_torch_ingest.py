"""The port's ingest stage against the JAX package's, on the CPU: every case of
``tests/test_ingest.py`` run through both packages on the same files.

The PDFs are written by the port's ``pdfwrite`` (its bytes equal the JAX
writer's), parsed by each package's own build of ``mmpdf.cpp`` and compared
item by item: page rasters (the port's arrays against ``np.asarray`` of
JAX's PIL pages), text, runs, rules, embedded images, chunks, tables,
``TemplateOcr``'s text and ``pdf_loader``'s documents (``uuid.uuid4``
patched to one counter in both) with the pixels of every PNG they save.
"""

import difflib
import importlib
import io
import itertools
import os
import uuid
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from multimodal_colpali_tpu import documents as jdocuments
from multimodal_colpali_tpu.ingest import chunker as jchunker
from multimodal_colpali_tpu.ingest import ocr as jocr
from multimodal_colpali_tpu.ingest import pdfwrite as jpdfwrite
from multimodal_colpali_tpu.ingest import rasterize as jraster
from multimodal_colpali_tpu.ingest import tables as jtables
from multimodal_colpali_tpu.models.processing import SimpleTokenizer as JTok
from multimodal_colpali_tpu_torch import documents as tdocuments
from multimodal_colpali_tpu_torch.ingest import chunker as tchunker
from multimodal_colpali_tpu_torch.ingest import ocr as tocr
from multimodal_colpali_tpu_torch.ingest import pdfwrite as tpdfwrite
from multimodal_colpali_tpu_torch.ingest import rasterize as traster
from multimodal_colpali_tpu_torch.ingest import tables as ttables
from multimodal_colpali_tpu_torch.ingest.imageops import read_png
from multimodal_colpali_tpu_torch.models.processing import SimpleTokenizer

# the packages' ``ingest/__init__`` re-export the function ``pdf_loader`` over its module
jloader = importlib.import_module("multimodal_colpali_tpu.ingest.pdf_loader")
tloader = importlib.import_module("multimodal_colpali_tpu_torch.ingest.pdf_loader")

REPO = Path(__file__).resolve().parent.parent
PORT_DIR = REPO / "multimodal_colpali_tpu_torch"


@pytest.fixture()
def sample_pdf(tmp_path):
    p = str(tmp_path / "paper.pdf")
    tpdfwrite.make_sample_pdf(p, n_pages=3, lines_per_page=8, with_images=True, seed=1)
    return p


def _docs(path):
    return jraster.PdfDocument(path), traster.PdfDocument(path)


def _same_pages(jdoc, tdoc, dpi=144.0):
    assert len(jdoc) == len(tdoc)
    for i in range(len(tdoc)):
        got = tdoc.render(i, dpi=dpi)
        assert isinstance(got, np.ndarray) and got.dtype == np.uint8 and got.ndim == 3
        np.testing.assert_array_equal(got, np.asarray(jdoc.render(i, dpi=dpi)))
        assert tdoc.extract_text(i) == jdoc.extract_text(i)
        assert tdoc.extract_runs(i) == jdoc.extract_runs(i)
        assert tdoc.extract_rules(i) == jdoc.extract_rules(i)
        assert tdoc.page_size(i) == jdoc.page_size(i)
        assert tdoc.has_text(i) == jdoc.has_text(i)
        timgs, jimgs = tdoc.extract_images(i), jdoc.extract_images(i)
        assert len(timgs) == len(jimgs)
        for (ta, tb), (ja, jb) in zip(timgs, jimgs):
            np.testing.assert_array_equal(ta, np.asarray(ja))
            assert tb == jb


# -- the copies -----------------------------------------------------------------

def test_native_source_and_ocr_weights_are_byte_copies():
    jax_pkg = REPO / "multimodal_colpali_tpu"
    for rel in ("native/src/mmpdf.cpp", "ingest/ocr_conv_weights.npz"):
        assert (PORT_DIR / rel).read_bytes() == (jax_pkg / rel).read_bytes(), rel


def test_native_library_builds_into_the_build_directory():
    from multimodal_colpali_tpu_torch import _build

    path = _build.build_native()
    assert path.parent == _build.BUILD_DIR / "native" and path.exists()
    assert path.name.startswith("libmmpdf-") and path.suffix == ".so"
    assert _build.native_library_path() == path
    cmd = _build.native_command(path)
    assert f"-I{_build.JPEG_DIR}" in cmd and str(_build.JPEG_SRC) in cmd
    assert "-ljpeg" not in cmd and "-lz" in cmd
    assert traster.get_lib() is traster.get_lib()


def _jpeg_pdf(jpeg: bytes) -> bytes:
    w = tpdfwrite.PdfWriter()
    w.add_page(text_lines=["A figure"], image=jpeg, image_rect=(60, 300, 320, 240))
    return w.tobytes()


def _decoded_like_libjpeg(pdf: bytes) -> int:
    """Both libraries' extracted images and rasters of page 1 equal; -> the
    number of images libjpeg (JAX's build) decoded."""
    jdoc, tdoc = jraster.PdfDocument(pdf), traster.PdfDocument(pdf)
    jimgs, timgs = jdoc.extract_images(0), tdoc.extract_images(0)
    assert len(timgs) == len(jimgs)
    for (ta, tb), (ja, jb) in zip(timgs, jimgs):
        np.testing.assert_array_equal(ta, np.asarray(ja))
        assert tb == jb
    np.testing.assert_array_equal(tdoc.render(0, dpi=72), np.asarray(jdoc.render(0, dpi=72)))
    return len(jimgs)


def test_native_library_without_libjpeg_skips_jpeg_figures(tmp_path):
    """The port's library links no libjpeg: its own decoder gives libjpeg's
    pixels for a figure Pillow wrote, and a JPEG that neither decodes (CMYK,
    which libjpeg cannot turn into RGB) is left out by both, the port warning
    with the document and page and counting it."""
    import subprocess

    from multimodal_colpali_tpu_torch import _build

    ldd = subprocess.run(["ldd", str(_build.build_native())], capture_output=True, text=True)
    assert "libjpeg" not in ldd.stdout and "libz" in ldd.stdout
    rng = np.random.default_rng(0)
    jpg = tmp_path / "fig.jpg"
    Image.fromarray(rng.integers(0, 256, (30, 40, 3), dtype=np.uint8)).save(jpg)
    pdf = tmp_path / "jpeg.pdf"
    Image.open(jpg).save(pdf)                     # Pillow embeds the JPEG as DCTDecode
    assert b"/DCTDecode" in pdf.read_bytes()
    assert _decoded_like_libjpeg(pdf.read_bytes()) == 1
    cmyk = tmp_path / "cmyk.jpg"
    Image.fromarray(rng.integers(0, 256, (30, 40, 3), dtype=np.uint8)).convert("CMYK").save(cmyk)
    before = traster.skipped_jpeg_images()
    with pytest.warns(RuntimeWarning, match=r"document.pdf page 1: 1 JPEG image\(s\) could not"):
        assert _decoded_like_libjpeg(_jpeg_pdf(cmyk.read_bytes())) == 0
    assert traster.skipped_jpeg_images() == before + 2     # the images, then the raster


def _smooth_image(rng, h, w):
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([128 + 100 * np.sin(x / 7 + k) * np.cos(y / 9 - k) for k in range(3)], -1)
    return np.clip(base + rng.normal(0, 12, base.shape), 0, 255).astype(np.uint8)


@pytest.mark.parametrize("shape", [(240, 320), (37, 23), (1, 1), (2, 3), (64, 5)])
@pytest.mark.parametrize("sampling", [(1, 1), (2, 1), (1, 2), (2, 2), (4, 1), (3, 1)])
def test_jpeg_decoder_matches_libjpeg_on_every_sampling(shape, sampling):
    """``encode_jpeg``'s baseline streams at every chroma sampling (fancy
    upsampling 2:1, 1:2 and 2:2, replication for 4:1 and 3:1 and for
    components 2 or fewer samples wide), with restart markers and in gray,
    decode to libjpeg's pixels."""
    img = _smooth_image(np.random.default_rng(sum(shape) + 7 * sampling[0] + sampling[1]), *shape)
    assert _decoded_like_libjpeg(_jpeg_pdf(traster.encode_jpeg(img, 75, sampling))) == 1
    assert _decoded_like_libjpeg(_jpeg_pdf(
        traster.encode_jpeg(img, 40, sampling, restart_interval=3))) == 1
    assert _decoded_like_libjpeg(_jpeg_pdf(traster.encode_jpeg(img[..., 1], 80))) == 1


@pytest.mark.parametrize("subsampling", [0, 1, 2])
@pytest.mark.parametrize("progressive", [False, True])
def test_jpeg_decoder_matches_libjpeg_on_pillow_s_jpegs(subsampling, progressive):
    """Pillow's (libjpeg-turbo's) encoder: standard and optimized Huffman
    tables, sequential and progressive, in color, gray and RGB (Adobe
    marker, no color transform)."""
    rng = np.random.default_rng(subsampling + 3 * progressive)
    for shape in ((240, 320), (37, 23), (9, 17)):
        img = _smooth_image(rng, *shape)
        variants = [("RGB", {}), ("RGB", {"optimize": True}), ("L", {})]
        if subsampling == 0:   # libjpeg subsamples no RGB stream
            variants.append(("RGB", {"keep_rgb": True}))
        for mode, kw in variants:
            buf = io.BytesIO()
            Image.fromarray(img).convert(mode).save(buf, "JPEG", quality=85, subsampling=subsampling,
                                                    progressive=progressive, **kw)
            assert _decoded_like_libjpeg(_jpeg_pdf(buf.getvalue())) == 1


def test_jpeg_decoder_matches_libjpeg_on_damaged_streams():
    """A baseline stream cut short or overwritten in the middle decodes as
    libjpeg decodes it (zero bits, then empty blocks). A progressive stream
    cut short, whose first coefficients libjpeg would smooth, is left out
    with a warning: the one case where the port's page differs."""
    rng = np.random.default_rng(5)
    img = _smooth_image(rng, 120, 160)
    full = traster.encode_jpeg(img, 90, restart_interval=4)
    garbled = bytearray(full)
    garbled[len(full) // 3:len(full) // 3 + 40] = rng.integers(0, 255, 40, dtype=np.uint8).tobytes()
    for data in (full[:len(full) // 2], bytes(garbled)):
        assert _decoded_like_libjpeg(_jpeg_pdf(data)) == 1
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", progressive=True)
    pdf = _jpeg_pdf(buf.getvalue()[:len(buf.getvalue()) // 4])
    assert len(jraster.PdfDocument(pdf).extract_images(0)) == 1
    with pytest.warns(RuntimeWarning, match="could not be decoded"):
        assert traster.PdfDocument(pdf).extract_images(0) == []


def test_encode_jpeg_is_read_back_by_pillow():
    """``encode_jpeg`` writes standard JFIF: Pillow reads it at its size,
    close to the source."""
    y, x = np.mgrid[0:48, 0:72]
    img = np.stack([128 + 100 * np.sin(x / 7 + k) * np.cos(y / 9 - k) for k in range(3)], -1)
    img = np.clip(img, 0, 255).astype(np.uint8)
    for sampling in ((2, 2), (1, 1)):
        data = traster.encode_jpeg(img, 90, sampling)
        assert tpdfwrite.jpeg_size(data) == (72, 48, 3)
        back = np.asarray(Image.open(io.BytesIO(data)).convert("RGB")).astype(int)
        assert back.shape == img.shape and np.abs(back - img).mean() < 2.5
    gray = traster.encode_jpeg(img[..., 0], 90)
    assert tpdfwrite.jpeg_size(gray) == (72, 48, 1)
    assert np.abs(np.asarray(Image.open(io.BytesIO(gray))).astype(int) - img[..., 0]).max() <= 3


def test_pdf_writers_write_the_jax_writers_bytes(tmp_path):
    a, b = str(tmp_path / "a.pdf"), str(tmp_path / "b.pdf")
    tpdfwrite.make_sample_pdf(a, n_pages=3, lines_per_page=8, seed=4)
    jpdfwrite.make_sample_pdf(b, n_pages=3, lines_per_page=8, seed=4)
    assert Path(a).read_bytes() == Path(b).read_bytes()
    rng = np.random.default_rng(1)
    img = rng.integers(0, 255, (40, 60, 3)).astype(np.uint8)
    for cls in ("PdfWriter", "PdfWriterXrefStream"):
        pages = []
        for mod in (tpdfwrite, jpdfwrite):
            w = getattr(mod, cls)()
            w.add_page(text_lines=["Glycan structures", "second (line)"], image=img)
            w.add_page(text_lines=["page two"])
            pages.append(w.tobytes())
        assert pages[0] == pages[1], cls


# -- tests/test_ingest.py, both packages ------------------------------------------

def test_pdf_roundtrip_pages_and_text(sample_pdf):
    jdoc, tdoc = _docs(sample_pdf)
    assert len(tdoc) == 3
    t0 = tdoc.extract_text(0)
    assert "page 1" in t0 and "glycans" in t0
    assert tdoc.page_size(0) == (612.0, 792.0)
    _same_pages(jdoc, tdoc)


def test_pdf_raster_contains_image_and_text(sample_pdf):
    jdoc, tdoc = _docs(sample_pdf)
    a = tdoc.render(0, dpi=72)
    assert a.shape == (792, 612, 3)
    assert (a < 250).any(axis=-1).mean() > 0.05
    np.testing.assert_array_equal(a, np.asarray(jdoc.render(0, dpi=72)))
    for dpi in (36.0, 100.0, 288.0):
        np.testing.assert_array_equal(tdoc.render(1, dpi=dpi), np.asarray(jdoc.render(1, dpi=dpi)))


def test_text_only_pdf_and_ocr_probe(tmp_path):
    w = tpdfwrite.PdfWriter()
    w.add_page(text_lines=["hello world"])
    p = str(tmp_path / "t.pdf")
    w.save(p)
    w2 = tpdfwrite.PdfWriter()
    w2.add_page(image=np.zeros((10, 10, 3), np.uint8))
    p2 = str(tmp_path / "s.pdf")
    w2.save(p2)
    assert tloader.check_ocr(p) is jloader.check_ocr(p) is False
    assert tloader.check_ocr(p2) is jloader.check_ocr(p2) is True
    bad = tmp_path / "bad.pdf"
    bad.write_bytes(b"not a pdf")
    assert tloader.check_ocr(str(bad)) is jloader.check_ocr(str(bad)) is True
    with pytest.raises(ValueError, match="could not parse"):
        traster.PdfDocument(str(bad))


def test_chunker_budget_and_refs_equal_jax():
    pages = [
        "one two three four five.\n\nsix seven eight nine ten eleven twelve thirteen.",
        "second page text here.",
        "A very long paragraph. " * 30 + "\nshort tail",
        "",
    ]
    for budget in (3, 12, 40, 512):
        got = tchunker.HybridChunker(SimpleTokenizer(1000, 999), max_tokens=budget).chunk_pages(pages)
        want = jchunker.HybridChunker(JTok(1000, 999), max_tokens=budget).chunk_pages(pages)
        assert [(c.text, c.page_no, c.ref) for c in got] == \
            [(c.text, c.page_no, c.ref) for c in want]
    chunks = tchunker.HybridChunker(SimpleTokenizer(1000, 999), max_tokens=12).chunk_pages(pages[:2])
    assert chunks[0].page_no == 1 and chunks[-1].page_no == 2
    assert [c.ref for c in chunks] == [f"#/texts/{i}" for i in range(len(chunks))]


def test_extract_embedded_images(sample_pdf):
    jdoc, tdoc = _docs(sample_pdf)
    imgs = tdoc.extract_images(0)
    assert len(imgs) == 1
    img, bbox = imgs[0]
    assert img.shape == (60, 80, 3) and img.dtype == np.uint8
    x0, y0, x1, y1 = bbox
    assert abs(x0 - 100) < 2 and abs(x1 - 400) < 2
    assert abs(y0 - (792 - 600)) < 2 and abs(y1 - (792 - 400)) < 2
    np.testing.assert_array_equal(img, np.asarray(jdoc.extract_images(0)[0][0]))


def test_extract_runs_and_rules_equal_jax(tmp_path):
    w = tpdfwrite.PdfWriter()
    w.add_page(text_lines=["alpha", "beta"])
    w.add_page(runs=[(72, 700, "Table 2"), (72, 680, "a"), (200, 680, "b")],
               lines=[(70, 690, 300, 690), (70, 670, 300, 670), (150, 670, 150, 690)])
    p = str(tmp_path / "r.pdf")
    w.save(p)
    jdoc, tdoc = _docs(p)
    runs = tdoc.extract_runs(0)
    assert [r[3] for r in runs] == ["alpha", "beta"]
    assert runs[0][0] == runs[1][0] == 72.0 and runs[1][1] > runs[0][1]
    assert tdoc.extract_rules(1)
    _same_pages(jdoc, tdoc)


def _table_pdf(path):
    w = tpdfwrite.PdfWriter()
    runs = [(72, 700, "Table 1: Glycan binding affinities")]
    rows = [["Glycan", "Lectin", "Kd"], ["sLex", "E-selectin", "870"],
            ["sLea", "P-selectin", "220"]]
    y = 680
    for row in rows:
        for x, cell in zip([72, 200, 320], row):
            runs.append((x, y, cell))
        y -= 18
    runs.append((72, y - 12, "Ordinary paragraph text continues here."))
    w.add_page(runs=runs)
    # a ruled (booktabs) table with ragged cells on a second page
    runs2 = [(72, 720, "Table 2: Ruled")]
    for k, row in enumerate([["Name", "Value"], ["alpha beta", "1"], ["gamma", "22"]]):
        runs2 += [(80 + 3 * k, 700 - 16 * k, row[0]), (260 - 2 * k, 700 - 16 * k, row[1])]
    w.add_page(runs=runs2, lines=[(70, 712, 330, 712), (70, 690, 330, 690),
                                  (70, 655, 330, 655)])
    w.save(path)


def test_detect_tables_equals_jax(tmp_path, sample_pdf):
    p = str(tmp_path / "tab.pdf")
    _table_pdf(p)
    for path in (p, sample_pdf):
        jdoc, tdoc = _docs(path)
        for i in range(len(tdoc)):
            runs, rules = tdoc.extract_runs(i), tdoc.extract_rules(i)
            for kw in ({}, {"rules": rules}, {"x_tol": 5.0}):
                got = ttables.detect_tables(runs, **kw)
                want = jtables.detect_tables(runs, **kw)
                assert [(t.cells, t.bbox, t.caption, t.to_markdown()) for t in got] == \
                    [(t.cells, t.bbox, t.caption, t.to_markdown()) for t in want]
    assert ttables.detect_tables(traster.PdfDocument(sample_pdf).extract_runs(0)) == []
    got = ttables.detect_tables(traster.PdfDocument(p).extract_runs(0))
    assert len(got) == 1 and got[0].caption == "Table 1: Glycan binding affinities"


TEMPLATE_CASES = [
    (["GLYCANS BIND SELECTINS", "SAMPLE LINE 17"], 12),
    (["THE QUICK BROWN FOX JUMPS OVER THE LAZY DOG?"], 14),
    (["Glycans bind Selectins on page 42"], 12),
    (["the quick brown fox jumps over 13 lazy dogs"], 14),
    (["MiXeD Case 0123456789"], 12),
    (["all lowercase no ascenders: our source uses zero cursor"], 12),
    (["vision is our mission"], 12),
    (["juju 9"], 12),
    (["go 42 jumps"], 12),
    (["in jail with no money"], 12),
]


@pytest.mark.parametrize("lines,size", TEMPLATE_CASES, ids=[c[0][0][:16] for c in TEMPLATE_CASES])
def test_template_ocr_equals_jax(lines, size):
    w = tpdfwrite.PdfWriter()
    w.add_page(text_lines=lines, font_size=size)
    raster = traster.PdfDocument(w.tobytes()).render(0, dpi=144.0)
    got = tocr.TemplateOcr().recognize(raster, return_score=True)
    want = jocr.TemplateOcr().recognize(raster, return_score=True)
    assert got == want
    ratio = difflib.SequenceMatcher(None, got[0], "\n".join(lines)).ratio()
    assert ratio > 0.95, got


def test_template_ocr_noise_robustness_equals_jax():
    w = tpdfwrite.PdfWriter()
    w.add_page(text_lines=["GLYCANS BIND SELECTINS ON CELLS",
                           "SCANNED NOISY PAGE SAMPLE 17"], font_size=12)
    img = traster.PdfDocument(w.tobytes()).render(0, dpi=144.0).astype(np.float32)
    noisy = np.clip(img + np.random.default_rng(0).normal(0, 25, img.shape), 0, 255
                    ).astype(np.uint8)
    got = tocr.TemplateOcr().recognize(noisy)
    assert got == jocr.TemplateOcr().recognize(noisy)
    want = "GLYCANS BIND SELECTINS ON CELLS\nSCANNED NOISY PAGE SAMPLE 17"
    assert difflib.SequenceMatcher(None, got, want).ratio() > 0.95


def test_font_atlas_and_ocr_pdf_equal_jax(tmp_path):
    np.testing.assert_array_equal(traster.font_atlas(), jraster.font_atlas())
    w = tpdfwrite.PdfWriter()
    w.add_page(text_lines=["OCR PDF HELPER 12"])
    p = str(tmp_path / "o.pdf")
    w.save(p)
    assert tocr.ocr_pdf(p) == jocr.ocr_pdf(p) == ["OCR PDF HELPER 12"]


# -- pdf_loader: documents and PNGs -----------------------------------------------

def _counter_uuid(monkeypatch):
    counter = itertools.count()
    monkeypatch.setattr(uuid, "uuid4", lambda: uuid.UUID(int=next(counter)))
    return counter


def _run_both(monkeypatch, tmp_path, papers, links, names, **kw):
    """pdf_loader through both packages with one uuid counter each ->
    ((docs_multi, docs_text) of each, vd dirs)."""
    out = {}
    for tag, fn, extra in (("jax", jloader.pdf_loader, {}),
                           ("port", tloader.pdf_loader, {"device": "cpu"})):
        _counter_uuid(monkeypatch)
        vd = str(tmp_path / f"vd_{tag}")
        tok = JTok(1000, 999) if tag == "jax" else SimpleTokenizer(1000, 999)
        out[tag] = (fn(papers, links, names, vd, tok, **kw, **extra), vd)
    return out


def _same_documents(got, want, got_vd, want_vd):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.page_content == w.page_content
        gm, wm = dict(g.metadata), dict(w.metadata)
        g_link, w_link = gm.pop("img_link"), wm.pop("img_link")
        assert gm == wm
        assert (g_link == w_link == "") or \
            os.path.relpath(g_link, got_vd) == os.path.relpath(w_link, want_vd)
        if g_link:
            np.testing.assert_array_equal(read_png(g_link), np.asarray(Image.open(w_link)))
        assert tdocuments.validate_metadata(g.metadata) is None


def _same_pngs(got_vd, want_vd):
    names = sorted(str(p.relative_to(want_vd)) for p in Path(want_vd).rglob("*.png"))
    assert names == sorted(str(p.relative_to(got_vd)) for p in Path(got_vd).rglob("*.png"))
    for n in names:
        np.testing.assert_array_equal(read_png(Path(got_vd) / n),
                                      np.asarray(Image.open(Path(want_vd) / n)))
    return names


def test_pdf_loader_schema_documents_and_pngs_equal_jax(monkeypatch, tmp_path, sample_pdf):
    tab = str(tmp_path / "tab.pdf")
    _table_pdf(tab)
    out = _run_both(monkeypatch, tmp_path, [sample_pdf, tab],
                    ["https://doi.org/10.1/x", ""], ["paper.pdf", "tab.pdf"])
    (t_multi, t_text), tvd = out["port"]
    (j_multi, j_text), jvd = out["jax"]
    _same_documents(t_multi, j_multi, tvd, jvd)
    _same_documents(t_text, j_text, tvd, jvd)
    pngs = _same_pngs(tvd, jvd)
    assert [n for n in pngs if n.startswith("pg_images")] == [
        f"pg_images/{s}_{i:03d}.png" for s, n in (("paper", 3), ("tab", 2))
        for i in range(1, n + 1)]
    image_docs = [d for d in t_multi if d.metadata["type"] == "image"]
    assert [d.metadata["ref"] for d in image_docs] == [f"#/pictures/{i}" for i in range(3)]
    tables = [d for d in t_multi if d.metadata["type"] == "table"]
    assert tables and tables[0].metadata["caption"] == "Table 1: Glycan binding affinities"
    assert all(d.metadata["type"] == "text" for d in t_text)
    assert {d.metadata["document_id"] for d in t_multi} == {
        str(uuid.UUID(int=0)), str(uuid.UUID(int=1))}


def test_convert_pdfs_to_images_layout_equals_jax(sample_pdf, tmp_path):
    saved = traster.convert_pdfs_to_images([sample_pdf], str(tmp_path / "t"), device="cpu")
    want = jraster.convert_pdfs_to_images([sample_pdf], str(tmp_path / "j"))
    assert list(saved) == list(want) == ["paper"]
    for a, b in zip(saved["paper"], want["paper"]):
        assert Path(a).name == Path(b).name
        np.testing.assert_array_equal(read_png(a), np.asarray(Image.open(b)))
    in_mem = traster.convert_pdf_dir_to_images(os.path.dirname(sample_pdf), device="cpu")
    j_mem = jraster.convert_pdf_dir_to_images(os.path.dirname(sample_pdf))
    assert list(in_mem) == list(j_mem) == ["paper.pdf"]
    for a, b in zip(in_mem["paper.pdf"], j_mem["paper.pdf"]):
        assert isinstance(a, np.ndarray)
        np.testing.assert_array_equal(a, np.asarray(b))


def test_scanned_pdf_roundtrips_through_ocr_equal_jax(monkeypatch, tmp_path):
    src = tpdfwrite.PdfWriter()
    src.add_page(text_lines=["GLYCANS BIND SELECTINS ON CELLS",
                             "SCANNED PAGE WITHOUT TEXT LAYER"], font_size=12)
    raster = traster.PdfDocument(src.tobytes()).render(0, dpi=144.0)
    scan = tpdfwrite.PdfWriter()
    scan.add_page(image=raster, image_rect=(0, 0, 612, 792))
    scan_path = str(tmp_path / "scan.pdf")
    scan.save(scan_path)
    assert tloader.check_ocr(scan_path)
    out = _run_both(monkeypatch, tmp_path, [scan_path], ["https://doi.org/10.0/scan"],
                    ["scan.pdf"])
    (t_multi, t_text), tvd = out["port"]
    (j_multi, j_text), jvd = out["jax"]
    _same_documents(t_multi, j_multi, tvd, jvd)
    _same_documents(t_text, j_text, tvd, jvd)
    joined = " ".join(d.page_content for d in t_text if d.metadata["type"] == "text")
    assert "GLYCANS" in joined and "SELECTINS" in joined


# -- independent-writer dialects --------------------------------------------------

@pytest.fixture()
def mpl_pdf(tmp_path):
    mpl = pytest.importorskip("matplotlib")
    mpl.use("Agg")
    import matplotlib.pyplot as plt

    p = str(tmp_path / "mpl_paper.pdf")
    fig = plt.figure(figsize=(6.12, 7.92))
    for i, line in enumerate(["Glycan binding assay results",
                              "Sialyl-Lewis-x binds selectins with high affinity.",
                              "Measured Kd 12 nM at pH 7.4"]):
        fig.text(0.1, 0.9 - 0.06 * i, line, fontsize=12 if i else 14)
    fig.savefig(p)
    plt.close(fig)
    return p


def test_matplotlib_pdf_parses_equal_jax(mpl_pdf):
    jdoc, tdoc = _docs(mpl_pdf)
    assert "Sialyl-Lewis-x binds selectins with high affinity." in tdoc.extract_text(0)
    assert (tdoc.render(0, dpi=72) < 250).sum() > 500
    _same_pages(jdoc, tdoc)


def test_pil_image_pdf_parses_equal_jax(tmp_path):
    p = str(tmp_path / "scan.pdf")
    Image.fromarray(np.random.default_rng(0).integers(0, 255, (120, 160, 3)).astype(np.uint8)
                    ).save(p)
    jdoc, tdoc = _docs(p)
    assert not tdoc.has_text(0) and tloader.check_ocr(p)
    assert tdoc.extract_images(0)[0][0].shape == (120, 160, 3)
    assert tdoc.render(0, dpi=72).shape[:2] == (120, 160)
    _same_pages(jdoc, tdoc)


def test_xref_stream_dialect_roundtrip_equal_jax(tmp_path):
    rng = np.random.default_rng(1)
    w = tpdfwrite.PdfWriterXrefStream()
    w.add_page(text_lines=["Glycan structures overview",
                           "Sialylated glycans bind selectin receptors."],
               image=rng.integers(0, 255, (40, 60, 3)).astype(np.uint8))
    w.add_page(text_lines=["Second page content here"])
    p = str(tmp_path / "xrefstm.pdf")
    w.save(p)
    jdoc, tdoc = _docs(p)
    assert tdoc.extract_text(0) == ("Glycan structures overview\n"
                                    "Sialylated glycans bind selectin receptors.")
    assert tdoc.extract_text(1) == "Second page content here"
    _same_pages(jdoc, tdoc)


def test_pdf_loader_on_foreign_dialects_equal_jax(monkeypatch, mpl_pdf, tmp_path):
    rng = np.random.default_rng(2)
    w = tpdfwrite.PdfWriterXrefStream()
    w.add_page(text_lines=["Receptor expression analysis",
                           "Selectin density correlates with adhesion."],
               image=rng.integers(0, 255, (40, 60, 3)).astype(np.uint8))
    xp = str(tmp_path / "xrefstm_paper.pdf")
    w.save(xp)
    out = _run_both(monkeypatch, tmp_path, [mpl_pdf, xp],
                    ["https://doi.org/10.1/m", "https://doi.org/10.1/x"],
                    ["mpl_paper.pdf", "xrefstm_paper.pdf"])
    (t_multi, t_text), tvd = out["port"]
    (j_multi, j_text), jvd = out["jax"]
    _same_documents(t_multi, j_multi, tvd, jvd)
    _same_documents(t_text, j_text, tvd, jvd)
    _same_pngs(tvd, jvd)
    joined = " ".join(d.page_content for d in t_text)
    assert "Selectin density correlates with adhesion." in joined


def test_documents_module_is_jax_s():
    assert tdocuments.validate_metadata(
        {"document_name": "a", "document_id": "b", "document_link": "", "type": "text",
         "page_no": 1, "ref": "", "caption": "", "img_link": ""}) is None
    assert jdocuments.METADATA_KEYS == tdocuments.METADATA_KEYS
