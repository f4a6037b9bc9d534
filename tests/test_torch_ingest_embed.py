"""The port's corpus embedding and ingest entry points against the JAX
package's, on the CPU: ``api.create_document_embeddings``,
``PipelinedEmbedder.embed_pdf_dir``, ``remote_parse`` on a local fake
service, and the ``create_context`` driver against JAX's driver 01 on
``tests/test_drivers_e2e.py``'s workspace.

Embeddings are compared as ``tests/test_torch_colpali.py`` compares them:
the committed tiny-colpali parameters in float32 on both sides, within
1e-4. The pipelined embedder is held against the sequential path within
``tests/test_ingest.py``'s 2e-2 (bf16 weights, other batch compositions).
"""

import http.server
import importlib
import itertools
import json
import os
import subprocess
import sys
import threading
import uuid
import warnings
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from multimodal_colpali_tpu import api as japi
from multimodal_colpali_tpu.ingest import pipeline as jpipeline
from multimodal_colpali_tpu.ingest import remote_parse as jremote
from multimodal_colpali_tpu.models import registry as JR
from multimodal_colpali_tpu.models.colpali import ColPaliModel as JColPali
from multimodal_colpali_tpu.models.configs import ColPaliModelConfig as JCfg
from multimodal_colpali_tpu.models.processing import ColPaliProcessor as JProcessor
from multimodal_colpali_tpu.models.processing import SimpleTokenizer as JTok
from multimodal_colpali_tpu_torch import api as tapi
from multimodal_colpali_tpu_torch.drivers import create_context
from multimodal_colpali_tpu_torch.ingest import pipeline as tpipeline
from multimodal_colpali_tpu_torch.ingest import remote_parse as tremote
from multimodal_colpali_tpu_torch.ingest.imageops import read_png
from multimodal_colpali_tpu_torch.ingest.pdfwrite import PdfWriter, make_sample_pdf
from multimodal_colpali_tpu_torch.ingest.rasterize import convert_pdf_dir_to_images
from multimodal_colpali_tpu_torch.models import load_retriever
from multimodal_colpali_tpu_torch.models.processing import SimpleTokenizer
from multimodal_colpali_tpu_torch.store import VectorClient

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
PARAMS_NPZ = REPO / "goldens" / "tiny-colpali_params.npz"
ATOL = 1e-4                  # tests/test_torch_colpali.py, float32 on both sides
PIPELINE_ATOL = 2e-2         # tests/test_ingest.py::test_pipelined_embedder_matches_sequential


@pytest.fixture(scope="module")
def retriever_pair():
    """(JAX Retriever, port Retriever) on the committed tiny-colpali
    parameters in float32, keyed by device_preprocess."""
    with np.load(PARAMS_NPZ) as z:
        flat = {k: z[k] for k in z.files}
    nested = {}
    for key, val in flat.items():
        *parents, leaf = key.split("/")
        node = nested
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(val)
    cfg = JCfg.tiny()
    return {dp: (JR.Retriever(name="tiny-colpali", model=JColPali(cfg), params=nested,
                              processor=JProcessor(cfg), dtype=jnp.float32,
                              device_preprocess=dp),
                 load_retriever("tiny-colpali", device="cpu", dtype=torch.float32,
                                params=flat, device_preprocess=dp))
            for dp in (False, True)}


@pytest.fixture(scope="module")
def pdf_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("papers")
    for i, name in enumerate(["a", "b"]):
        make_sample_pdf(str(d / f"{name}.pdf"), n_pages=2, lines_per_page=3, seed=i)
    w = PdfWriter(width=300, height=500)            # another page geometry
    w.add_page(text_lines=["narrow page"])
    w.save(str(d / "c.pdf"))
    (d / "notes.txt").write_text("not a pdf")
    return str(d)


def _same_entries(got, want, atol):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g["doc_id"], g["page_id"], g["file_name"]) == \
            (w["doc_id"], w["page_id"], w["file_name"])
        assert g["embedding"].dtype == np.float32 and g["embedding"].shape == w["embedding"].shape
        np.testing.assert_allclose(g["embedding"], np.asarray(w["embedding"]), rtol=0, atol=atol)


@pytest.mark.parametrize("device_preprocess", [False, True])
def test_create_document_embeddings_matches_jax(retriever_pair, pdf_dir, device_preprocess):
    jr, tr = retriever_pair[device_preprocess]
    want = japi.create_document_embeddings(pdf_dir, jr, batch_size=3)
    got = tapi.create_document_embeddings(pdf_dir, tr, batch_size=3)
    assert [g["file_name"] for g in got] == ["a.pdf"] * 2 + ["b.pdf"] * 2 + ["c.pdf"]
    _same_entries(got, want, ATOL)


@pytest.mark.parametrize("raster_dpi", [None, "auto"])
def test_pipelined_embedder_matches_jax(retriever_pair, pdf_dir, raster_dpi):
    jr, tr = retriever_pair[True]
    want = jpipeline.PipelinedEmbedder(jr, batch_size=2, raster_dpi=raster_dpi
                                       ).embed_pdf_dir(pdf_dir)
    got = tpipeline.PipelinedEmbedder(tr, batch_size=2, raster_dpi=raster_dpi
                                      ).embed_pdf_dir(pdf_dir)
    _same_entries(got, want, ATOL)


def test_pipelined_embedder_matches_sequential(pdf_dir):
    """tests/test_ingest.py's case on the port: bf16 random weights, the
    pipeline's batches of 3 across PDFs against the sequential path's
    batches within a PDF."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        r = load_retriever("tiny-colpali", device="cpu", seed=0)
    want = tapi.create_document_embeddings(pdf_dir, r, batch_size=3)
    got = tpipeline.PipelinedEmbedder(r, batch_size=3).embed_pdf_dir(pdf_dir)
    assert len(got) == len(want) == 5
    _same_entries(got, want, PIPELINE_ATOL)


def test_pipelined_embedder_refuses_dynamic_resolution(retriever_pair, pdf_dir):
    _, tr = retriever_pair[False]

    class Dynamic:
        dynamic_resolution = True
        image_preprocessor = tr.processor.image_preprocessor

    saved, tr.processor = tr.processor, Dynamic()
    try:
        with pytest.raises(NotImplementedError, match="queue 1 item 6"):
            tpipeline.PipelinedEmbedder(tr, batch_size=2).embed_pdf_dir(pdf_dir)
    finally:
        tr.processor = saved


def test_pipeline_errors_reach_the_consumer():
    def broken():
        yield 1
        raise OSError("rasterizer failed")

    it = tpipeline._PrefetchIterator(broken(), depth=1)
    assert next(it) == 1
    with pytest.raises(OSError, match="rasterizer failed"):
        next(it)


def test_create_document_embeddings_on_the_card_by_default(monkeypatch, pdf_dir):
    """The pages are resized on the retriever's device: with no CUDA a card
    retriever's call raises instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    class CardModel:
        device = torch.device("cuda")

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tapi.create_document_embeddings(pdf_dir, CardModel())


def test_create_document_embeddings_holds_one_pdf_at_a_time(monkeypatch, retriever_pair,
                                                           pdf_dir):
    """Each PDF's pages are rasterized only after the one before was embedded,
    so the device holds one document's pages, whatever the corpus size; the
    records are those of the whole-directory conversion."""
    _, port = retriever_pair[False]
    events = []
    rasterize = tapi.resized_pages

    def traced_pages(path, **kw):
        events.append(("pages", os.path.basename(path)))
        return rasterize(path, **kw)

    class Model:
        device = port.device

        def embed_images(self, images, batch_size):
            events.append(("embed", len(images)))
            return port.embed_images(images, batch_size=batch_size)

    monkeypatch.setattr(tapi, "resized_pages", traced_pages)
    got = tapi.create_document_embeddings(pdf_dir, Model(), batch_size=4)
    assert events == [("pages", "a.pdf"), ("embed", 2), ("pages", "b.pdf"), ("embed", 2),
                      ("pages", "c.pdf"), ("embed", 1)]
    pages = convert_pdf_dir_to_images(pdf_dir, device="cpu")
    want = [(d, p, f) for d, (f, imgs) in enumerate(pages.items()) for p in range(len(imgs))]
    assert [(e["doc_id"], e["page_id"], e["file_name"]) for e in got] == want


# -- remote parse ---------------------------------------------------------------------

class _ConvertService:
    """docling-serve's /v1/convert as the clients use it: the first request
    for each file fails with a 500, the next answers with the file's name,
    size and a digest of its bytes (so a mangled upload shows)."""

    def __init__(self):
        import hashlib

        seen = set()
        received = self.received = []

        class Handler(http.server.BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_POST(self):
                body = self.rfile.read(int(self.headers["Content-Length"]))
                ctype = self.headers["Content-Type"]
                boundary = ctype.split("boundary=")[1].encode()
                part = body.split(b"--" + boundary)[1]
                head, content = part.split(b"\r\n\r\n", 1)
                content = content[:-2]                     # the CRLF before the boundary
                name = head.split(b'filename="')[1].split(b'"')[0].decode()
                received.append((self.path, name, hashlib.sha1(content).hexdigest()))
                if name not in seen:
                    seen.add(name)
                    self.send_response(500)
                    self.end_headers()
                    return
                reply = json.dumps({"pages": [
                    {"text": f"remote page of {name}: {len(content)} bytes "
                             f"{hashlib.sha1(content).hexdigest()[:12]}"}]}).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(reply)))
                self.end_headers()
                self.wfile.write(reply)

        self.server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.url = f"http://127.0.0.1:{self.server.server_address[1]}"
        self.thread = threading.Thread(target=self.server.serve_forever, daemon=True)

    def __enter__(self):
        self.thread.start()
        return self

    def __exit__(self, *exc):
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(timeout=10)
        assert not self.thread.is_alive()


def test_remote_parse_matches_jax(monkeypatch, pdf_dir, tmp_path):
    import hashlib

    papers = [os.path.join(pdf_dir, n) for n in ("a.pdf", "c.pdf")]
    names = ["a.pdf", 'c "odd".pdf']
    links = ["https://doi.org/10.1/a", ""]
    digests = [hashlib.sha1(Path(p).read_bytes()).hexdigest() for p in papers]
    results = {}
    for tag, mod in (("jax", jremote), ("port", tremote)):
        with _ConvertService() as srv:
            conv = mod.conv_docs1(papers, names, links, service_url=srv.url + "/", retries=3,
                                  backoff=0.01)
        assert [r[0] for r in srv.received] == ["/v1/convert"] * 4
        assert [r[2] for r in srv.received] == [digests[0]] * 2 + [digests[1]] * 2, tag
        results[tag] = [(c["filename"], c["link"], len(c["document"]),
                         [c["document"].extract_text(i) for i in range(len(c["document"]))])
                        for c in conv]
    assert results["port"] == results["jax"]
    assert results["port"][0][3][0].startswith("remote page of a.pdf")
    # no service: the native text layer
    assert [c["document"].extract_text(0) for c in tremote.conv_docs1(papers, names, links)] == \
        [c["document"].extract_text(0) for c in jremote.conv_docs1(papers, names, links)]
    # a service that never answers: retries exhausted, native fallback
    dead = "http://127.0.0.1:9"
    got = tremote.conv_docs1(papers[:1], names[:1], links[:1], service_url=dead, retries=2,
                             backoff=0.0)
    assert got[0]["document"].extract_text(0) == \
        jremote.conv_docs1(papers[:1], names[:1], links[:1])[0]["document"].extract_text(0)
    # pdf_loader1 through both packages, one uuid counter each
    docs = {}
    for tag, mod, tok, extra in (("jax", jremote, JTok(1000, 999), {}),
                                 ("port", tremote, SimpleTokenizer(1000, 999),
                                  {"device": "cpu"})):
        counter = itertools.count()
        monkeypatch.setattr(uuid, "uuid4", lambda: uuid.UUID(int=next(counter)))
        with _ConvertService() as srv:
            multi, text = _pdf_loader1(mod, papers, links, names, str(tmp_path / tag), tok,
                                       srv.url, extra)
        docs[tag] = [(d.page_content, {k: v for k, v in d.metadata.items() if k != "img_link"})
                     for d in multi + text]
    assert docs["port"] == docs["jax"]
    assert any("remote page of a.pdf" in c for c, _ in docs["port"])


def _pdf_loader1(mod, papers, links, names, vd, tok, url, extra):
    """``pdf_loader1`` with a fast retry: its ``conv_docs1`` call takes the
    default backoff of 2 s, so the module's ``time.sleep`` is skipped."""
    saved = mod.time.sleep
    mod.time.sleep = lambda s: None
    try:
        return mod.pdf_loader1(papers, links, names, vd, tok, service_url=url, **extra)
    finally:
        mod.time.sleep = saved


def test_multipart_body_is_what_the_service_parses():
    body, ctype = tremote.multipart_file("file", "x.pdf", b"%PDF-1.4\r\n--not-a-boundary",
                                         "application/pdf")
    boundary = ctype.split("boundary=")[1]
    assert ctype.startswith("multipart/form-data; boundary=") and len(boundary) == 32
    assert body.startswith(f"--{boundary}\r\n".encode())
    assert body.endswith(f"\r\n--{boundary}--\r\n".encode())
    assert b'name="file"; filename="x.pdf"' in body
    assert b"\r\n\r\n%PDF-1.4\r\n--not-a-boundary\r\n" in body
    body, _ = tremote.multipart_file("file", 'a "b"\\c\nd\x1be.pdf', b"", "application/pdf")
    assert b'filename="a %22b%22\\\\c%0Ad\x1be.pdf"' in body        # httpx's encoding


# -- the create_context driver against driver 01 --------------------------------------

def test_create_context_flags_match_driver_01():
    spec = importlib.util.spec_from_file_location("jdriver01",
                                                  REPO / "drivers" / "01_create_context.py")
    j = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(j)
    argv = ["--papers-dir", "p", "--vd-dir", "v", "--skip-summaries", "--dpi", "100",
            "--text-encoder-config", "tiny", "--doi-file", "d.txt"]
    sys_argv = sys.argv
    try:
        sys.argv = ["01", *argv]
        want = vars(j.parse_args())
    finally:
        sys.argv = sys_argv
    got = vars(create_context.parse_args(argv))
    assert got.pop("device") == "cuda" and want.pop("device") is None
    assert got == want
    assert j.DEFAULT_PROMPT == create_context.DEFAULT_PROMPT


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    """tests/test_drivers_e2e.py's corpus and model registry, with a tiny
    ColPali checkpoint both packages load through COLPALI_TPU_CKPT_DIR."""
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from multimodal_colpali_tpu_torch.models.registry import RETRIEVER_CONFIGS

    ws = tmp_path_factory.mktemp("e2e")
    papers = ws / "papers"
    papers.mkdir()
    for i, name in enumerate(["Paper01", "Paper02"]):
        make_sample_pdf(str(papers / f"{name}.pdf"), n_pages=2, lines_per_page=5, seed=i)
    (ws / "models.json").write_text(json.dumps([{
        "model_name": "fake-gemma", "model_short": "gemma3", "port": 1,
        "text_vd": "RAG_TEXT", "mm_vd": "RAG_MM_gemma3",
        "late_inter": "tiny-colpali", "late_inter_short": "colpali"}]))
    ckpt = ws / "ckpt" / "tiny-colpali"
    ckpt.mkdir(parents=True)
    smoke.write_colpali_checkpoint(torch, RETRIEVER_CONFIGS["tiny-colpali"](), str(ckpt),
                                   seed=5, shards=1, device="cpu")
    return ws


def _collections(storage):
    client = VectorClient(path=str(storage), device="cpu")
    out = {}
    for c in client.get_collections().collections:
        n = client.count(c.name).count
        points, _ = client.scroll(c.name, limit=n + 1, with_vectors=True)
        out[c.name] = points
    return out


def test_create_context_matches_driver_01(workspace, monkeypatch):
    ws = workspace
    common = ["--papers-dir", str(ws / "papers"), "--models-config", str(ws / "models.json"),
              "--prompts-path", "", "--text-encoder-config", "tiny", "--skip-summaries"]
    env = dict(os.environ, JAX_PLATFORMS="cpu", MMCP_JAX_PLATFORMS="cpu",
               COLPALI_TPU_CKPT_DIR=str(ws / "ckpt"),
               PYTHONPATH=f"{REPO}:{os.environ.get('PYTHONPATH', '')}")
    r = subprocess.run([sys.executable, str(REPO / "drivers" / "01_create_context.py"),
                        *common, "--vd-dir", str(ws / "vd_jax")],
                       env=env, capture_output=True, text=True, timeout=420)
    assert r.returncode == 0, r.stderr[-3000:]
    monkeypatch.setenv("COLPALI_TPU_CKPT_DIR", str(ws / "ckpt"))
    stages = create_context.main([*common, "--vd-dir", str(ws / "vd_port"), "--device", "cpu"])
    assert list(stages) == ["text_encoder", "pdf_loader", "summaries", "dense_collections",
                            "page_pngs", "colpali_collections", "save"]

    jvd, tvd = ws / "vd_jax", ws / "vd_port"
    pngs = sorted(p.name for p in (jvd / "pg_images").iterdir())
    assert pngs == ["Paper01_001.png", "Paper01_002.png", "Paper02_001.png", "Paper02_002.png"]
    assert sorted(p.name for p in (tvd / "pg_images").iterdir()) == pngs
    for sub in ("pg_images", "images"):
        for p in sorted((jvd / sub).iterdir()):
            np.testing.assert_array_equal(read_png(tvd / sub / p.name), np.asarray(Image.open(p)))

    want, got = _collections(jvd / "storage"), _collections(tvd / "storage")
    assert sorted(got) == sorted(want) == ["RAG_MM_gemma3", "RAG_TEXT", "colpali"]

    def key(p):
        """The payload without its uuids, image links by file name."""
        def strip(d):
            return {k: (strip(v) if isinstance(v, dict) else
                        os.path.basename(v) if k == "img_link" else v)
                    for k, v in d.items() if k != "document_id"}
        return json.dumps(strip(p.payload), sort_keys=True, default=str)

    for name in want:
        assert len(got[name]) == len(want[name]) > 0, name
        w_by = {key(p): p for p in want[name]}
        g_by = {key(p): p for p in got[name]}
        assert sorted(g_by) == sorted(w_by), name
        for k, wp in w_by.items():
            gv, wv = np.asarray(g_by[k].vector, np.float32), np.asarray(wp.vector, np.float32)
            assert gv.shape == wv.shape, name
            # bf16 weights and activations on both sides: unit vectors (a
            # token each for ColPali) whose cosines are within 1e-2 of 1
            cos = (gv * wv).sum(-1) / (np.linalg.norm(gv, axis=-1) * np.linalg.norm(wv, axis=-1))
            assert cos.min() > 1 - 1e-2, (name, float(cos.min()))
