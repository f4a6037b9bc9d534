"""Build, dispatch and bring-up-script behaviour of the port that a machine
without a GPU or nvcc can check: a failed build raises, kernel wrappers
refuse CPU tensors instead of falling back, and ``chip_smoke.py`` refuses to
run (exit code, no result line) without CUDA or outside a checkout.
"""

import ctypes
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from multimodal_colpali_tpu_torch import _build
from multimodal_colpali_tpu_torch.ops import attention as A
from multimodal_colpali_tpu_torch.ops import fused_layer as FL
from multimodal_colpali_tpu_torch.ops import int4_matmul as I4
from multimodal_colpali_tpu_torch.ops import int8_matmul as IM
from multimodal_colpali_tpu_torch.ops import maxsim as M
from multimodal_colpali_tpu_torch.ops import paged_attention as PA
from multimodal_colpali_tpu_torch.ops import preprocess as PP
from multimodal_colpali_tpu_torch.ops import window_attention as WA

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture
def fake_build(tmp_path, monkeypatch):
    """_build pointed at a copy of csrc/ and a scratch output directory."""
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC_DIR, csrc)
    monkeypatch.setattr(_build, "CSRC_DIR", csrc)
    monkeypatch.setattr(_build, "KERNEL_DIR", tmp_path / "kernels")
    return csrc


def _fake_nvcc(tmp_path, body):
    path = tmp_path / "nvcc"
    path.write_text("#!/bin/sh\n" + body)
    path.chmod(0o755)
    return str(path)


def test_library_path_follows_sources_and_headers(fake_build):
    before = _build.library_path("maxsim")
    assert before.parent == _build.KERNEL_DIR and before.name.startswith("maxsim-")
    assert _build.library_path("attention") != before
    (fake_build / "common.cuh").write_text((fake_build / "common.cuh").read_text() + "\n// x\n")
    assert _build.library_path("maxsim") != before


def test_failed_build_raises_with_compiler_output(fake_build, tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "nvcc_path",
                        lambda: _fake_nvcc(tmp_path, 'echo "error: no sm_90a here"\nexit 1\n'))
    with pytest.raises(RuntimeError, match="(?s)nvcc failed for csrc/maxsim.cu.*no sm_90a"):
        _build._compile(["maxsim"])
    assert not _build.library_path("maxsim").exists()
    assert not list(_build.KERNEL_DIR.glob("*.tmp"))


def test_build_passes_sm90a_flags_and_installs_output(fake_build, tmp_path, monkeypatch):
    log = tmp_path / "args"
    # stand-in compiler: record the arguments, write the file named after -o
    nvcc = _fake_nvcc(tmp_path, f'echo "$@" > {log}\nwhile [ "$1" != "-o" ]; do shift; done\n'
                                'echo built > "$2"\n')
    monkeypatch.setattr(_build, "nvcc_path", lambda: nvcc)
    _build._compile(["maxsim", "attention"])
    for name in ("maxsim", "attention"):
        assert _build.library_path(name).read_text() == "built\n"
    args = log.read_text()
    assert "arch=compute_90a,code=sm_90a" in args and "-O3" in args and "-fPIC" in args
    monkeypatch.setattr(_build, "nvcc_path", lambda: pytest.fail("rebuilt an unchanged source"))
    _build._compile(["maxsim"])


def test_build_variant_adds_flags_and_builds_apart(fake_build, tmp_path, monkeypatch):
    log = tmp_path / "args"
    nvcc = _fake_nvcc(tmp_path, f'echo "$@" >> {log}\nwhile [ "$1" != "-o" ]; do shift; done\n'
                                'echo built > "$2"\n')
    monkeypatch.setattr(_build, "nvcc_path", lambda: nvcc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_typed", lambda name, path: (name, path))
    name, so = _build.build_variant("maxsim", "-DMAXSIM_SKIP_PRODUCTS")
    assert name == "maxsim" and so.parent == tmp_path / "build" / "sweep"
    assert so.read_text() == "built\n" and not _build.library_path("maxsim").exists()
    args = log.read_text()
    assert "-DMAXSIM_SKIP_PRODUCTS" in args and "arch=compute_90a,code=sm_90a" in args
    assert _build.build_variant("maxsim", "-DMAXSIM_SKIP_PRODUCTS")[1] == so   # built once
    assert log.read_text() == args
    assert _build.build_variant("maxsim", "-DOTHER")[1] != so
    monkeypatch.setattr(_build, "nvcc_path",
                        lambda: _fake_nvcc(tmp_path, 'echo "error: bad flag"\nexit 1\n'))
    with pytest.raises(RuntimeError, match="(?s)nvcc failed for csrc/maxsim.cu.*bad flag"):
        _build.build_variant("maxsim", "-DBAD")


def test_check_raises_on_cuda_error_codes():
    class Lib:
        @staticmethod
        def cuda_error_string(code):
            return b"invalid argument"

    _build.check(Lib, 0, "launch")
    with pytest.raises(RuntimeError, match="launch: CUDA error 1 \\(invalid argument\\)"):
        _build.check(Lib, 1, "launch")


def test_build_registers_normalize_with_its_signature():
    """K3 is built by nvcc like the other kernels: its plain C entry point
    takes the pixels, the output, the element count (64-bit) and the three
    scales and three biases by value, then the stream."""
    P, F = ctypes.c_void_p, ctypes.c_float
    assert _build.SIGNATURES["normalize"] == {
        "normalize_launch": (P, P, ctypes.c_longlong, F, F, F, F, F, F, P)}
    assert _build.SIGNATURES["window_attention"]["window_attention_grid"] == ()


_EXTERN = re.compile(r'extern "C" int (\w+)\(([^)]*)\)')


@pytest.mark.parametrize("source", sorted(p.name for p in _build.CSRC_DIR.glob("*.cu")))
def test_every_entry_point_is_typed_with_its_arity(source):
    """Each ``csrc/*.cu`` has a table entry, and each ``extern "C"`` entry
    point (but the shared error string) is typed with as many arguments as
    the C function takes: a missing argument type would pass a pointer as a
    32-bit int."""
    name = source[:-3]
    table = _build.SIGNATURES[name]
    text = (_build.CSRC_DIR / source).read_text()
    found = {fn: len([a for a in args.split(",") if a.strip()])
             for fn, args in _EXTERN.findall(text)}
    assert found and set(found) == set(table), source
    for fn, n_args in found.items():
        assert len(table[fn]) == n_args, fn


def test_port_holds_no_triton():
    """K3 is CUDA C++ now: the port has no Triton kernel and no Triton cache."""
    assert not hasattr(_build, "ensure_triton_cache")
    assert not (_build.PACKAGE_DIR / "ops" / "_normalize_triton.py").exists()
    assert set(_build.SIGNATURES) == {p.stem for p in _build.CSRC_DIR.glob("*.cu")}


_W = torch.zeros(8, 8, dtype=torch.bfloat16)
_V = torch.zeros(8)
_X = torch.zeros(1, 4, 8, dtype=torch.bfloat16)
_COUNTERS = (M.maxsim_scores_cuda, A.fused_attention_cuda, PP.normalize_images_cuda,
             M.maxsim_scores_int8_cuda, FL.fused_vit_layer_cuda,
             FL.fused_vit_attention_block_cuda, FL.fused_mlp_block_cuda,
             PA.paged_attention_cuda, PA.paged_attention_int8_cuda, IM.int8_matmul_kn_cuda,
             IM.int8_matmul_nk_cuda, WA.window_attention_cuda, I4.int4_matmul_kn_cuda,
             FL.fused_gemm_cuda, FL.ln_stats_cuda)
_POOL = torch.zeros(3, 4, 1, 8)
_POOL8 = torch.zeros(3, 4, 1, 8, dtype=torch.int8)
_BT, _LENS = torch.zeros(1, 2, dtype=torch.int32), torch.ones(1, dtype=torch.int32)


@pytest.mark.parametrize("call", [
    lambda: M.maxsim_scores_cuda(torch.zeros(1, 2, 8), torch.zeros(3, 4, 8)),
    lambda: A.fused_attention_cuda(*(torch.zeros(1, 4, 2, 8),) * 3, scale=1.0),
    lambda: PP.normalize_images_cuda(torch.zeros(1, 4, 4, 3, dtype=torch.uint8)),
    lambda: M.maxsim_scores_int8_cuda(torch.zeros(1, 2, 8),
                                      torch.zeros(3, 4, 8, dtype=torch.int8), torch.ones(3, 4)),
    lambda: FL.fused_vit_layer_cuda(_X, _V, _V, *(_W, _V) * 4, _V, _V, _W, _V, _W, _V,
                                    heads=2),
    lambda: FL.fused_vit_attention_block_cuda(_X, _V, _V, *(_W, _V) * 4, heads=2),
    lambda: FL.fused_mlp_block_cuda(_X, _V, _V, _W, _V, _W, _V),
    lambda: PA.paged_attention_cuda(torch.zeros(1, 2, 8), _POOL, _POOL, _BT, _LENS, scale=1.0),
    lambda: PA.paged_attention_int8_cuda(torch.zeros(1, 2, 8), _POOL8, torch.ones(3, 4, 1),
                                         _POOL8, torch.ones(3, 4, 1), _BT, _LENS, scale=1.0),
    lambda: IM.int8_matmul_kn_cuda(_W, torch.zeros(8, 4, dtype=torch.int8), torch.ones(4)),
    lambda: IM.int8_matmul_nk_cuda(_W, torch.zeros(4, 8, dtype=torch.int8), torch.ones(4)),
    lambda: WA.window_attention_cuda(*(torch.zeros(3, 16, 8),) * 3, scale=1.0),
    lambda: I4.int4_matmul_kn_cuda(_W, torch.zeros(4, 4, dtype=torch.uint8), torch.ones(1, 4)),
    lambda: FL.fused_gemm_cuda(_W, (_W,), (_V,), "bias", ln=(_V, _V)),
    lambda: FL.ln_stats_cuda(_W, 1e-6),
], ids=["maxsim", "attention", "normalize", "maxsim_int8", "vit_layer", "attn_block",
        "mlp_block", "paged_attention", "paged_attention_int8", "int8_matmul_kn",
        "int8_matmul_nk", "window_attention", "int4_matmul_kn", "fused_gemm", "ln_stats"])
def test_kernel_wrappers_refuse_cpu_tensors(call):
    counters = [f.launches for f in _COUNTERS]
    with pytest.raises(ValueError, match="CUDA"):
        call()
    assert counters == [f.launches for f in _COUNTERS]


@pytest.mark.parametrize("call,match", [
    (lambda: PP.normalize_images_cuda(torch.zeros(1, 4, 4, 3)), "uint8"),
    (lambda: PP.normalize_images_cuda(torch.zeros(1, 4, 4, 3, dtype=torch.int8)), "uint8"),
    (lambda: PP.normalize_images_cuda(torch.zeros(1, 4, 4, 4, dtype=torch.uint8)),
     r"expected \[B, H, W, 3\]"),
    (lambda: PP.normalize_images_cuda(torch.zeros(4, 4, 3, dtype=torch.uint8)),
     r"expected \[B, H, W, 3\]"),
    (lambda: PP.normalize_images_cuda(torch.zeros(1, 4, 4, 3, dtype=torch.uint8),
                                      mean=(0.5, 0.5)), "one value per channel"),
], ids=["float32", "int8", "four_channels", "no_batch", "two_means"])
def test_normalize_cuda_refuses_wrong_dtype_and_shape(call, match):
    before = PP.normalize_images_cuda.launches
    with pytest.raises(ValueError, match=match):
        call()
    assert PP.normalize_images_cuda.launches == before


@pytest.mark.parametrize("dtype,s,d,path", [
    (torch.bfloat16, 144, 32, "ring"), (torch.bfloat16, 49, 24, "ring"),
    (torch.bfloat16, 1, 1, "ring"), (torch.bfloat16, 145, 32, "wmma"),
    (torch.bfloat16, 144, 40, "wmma"), (torch.bfloat16, 600, 32, "wmma"),
    (torch.float32, 144, 32, "cuda_core"), (torch.float32, 7, 100, "cuda_core")])
def test_window_attention_kernel_path_follows_dtype_and_shape(dtype, s, d, path):
    """Every ColFlor stage (12 x 12 windows, head_dim 32) takes the ring kernel."""
    assert WA.kernel_path(dtype, s, d) == path
    assert hasattr(WA.window_attention_cuda, f"{path}_launches")


def test_dispatchers_take_plain_versions_on_cpu():
    rng = np.random.default_rng(0)
    q, d = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            for s in ((2, 3, 8), (5, 4, 8)))
    torch.testing.assert_close(M.maxsim_scores(q, d), M.maxsim_scores_reference(q, d))
    x = torch.from_numpy(rng.standard_normal((1, 6, 2, 8)).astype(np.float32))
    torch.testing.assert_close(A.fused_attention(x, x, x, scale=0.3),
                               A.attention_reference(x, x, x, scale=0.3))
    u8 = torch.from_numpy(rng.integers(0, 256, (1, 3, 3, 3), dtype=np.uint8))
    assert torch.equal(PP.normalize_images(u8), PP.normalize_images_reference(u8))
    codes, scales = M.quantize_corpus_int8(d)
    assert torch.equal(M.maxsim_scores_int8(q, codes, scales),
                       M.maxsim_scores_int8_reference(q, codes, scales))
    xb = x.reshape(1, 6, 16).to(torch.bfloat16)
    w, v = torch.eye(16, dtype=torch.bfloat16), torch.zeros(16)
    args = (torch.ones(16), v, w, v, w, v)
    assert torch.equal(FL.fused_mlp_block(xb, *args), FL.fused_mlp_block_reference(xb, *args))
    w = torch.from_numpy(rng.standard_normal((3, 16, 8)).astype(np.float32))
    assert torch.equal(WA.window_attention(w, w, w, scale=0.3),
                       WA.window_attention_reference(w, w, w, scale=0.3))
    packed = torch.from_numpy(rng.integers(0, 256, (8, 5), dtype=np.uint8))
    scale = torch.rand(2, 5, generator=torch.Generator().manual_seed(0))
    assert torch.equal(I4.int4_matmul_kn(xb[0], packed, scale),
                       I4.int4_matmul_reference(xb[0], packed, scale))


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_chip_smoke_refuses_without_cuda_or_checkout(tmp_path, where):
    if where == "checkout":
        script, cwd = REPO / "chip_smoke.py", REPO
    else:
        script = Path(shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py"))
        cwd = tmp_path
    r = subprocess.run([sys.executable, str(script)], cwd=cwd, capture_output=True,
                       text=True, timeout=120, env={"PATH": "/usr/bin:/bin",
                                                    "CUDA_VISIBLE_DEVICES": ""})
    assert r.returncode == 2, r.stderr
    assert r.stdout == ""
    assert "FAIL" in r.stderr


def test_entry_points_default_to_the_card(monkeypatch):
    """Every entry point of the port defaults to ``device="cuda"``; without a
    card a default call raises and says why instead of running on the CPU."""
    import dataclasses
    import inspect

    from multimodal_colpali_tpu_torch import serve
    from multimodal_colpali_tpu_torch.generation.engine import GemmaDecodeEngine
    from multimodal_colpali_tpu_torch.models import registry as R
    from multimodal_colpali_tpu_torch.models.colpali import ColPaliModel
    from multimodal_colpali_tpu_torch.models.configs import (
        ColFlorModelConfig, ColIdefics3ModelConfig, ColPaliModelConfig, Gemma3TextConfig)
    from multimodal_colpali_tpu_torch.models.convert import engine_params_from_jax
    from multimodal_colpali_tpu_torch.models.florence2 import ColFlorModel
    from multimodal_colpali_tpu_torch.models.idefics3 import ColIdefics3Model
    from multimodal_colpali_tpu_torch.models.processing import (
        ColPaliProcessor, score_multi_vector)
    from multimodal_colpali_tpu_torch.models.processing_florence2 import ColFlorProcessor
    from multimodal_colpali_tpu_torch.models.processing_idefics3 import ColIdefics3Processor
    from multimodal_colpali_tpu_torch.models.bert import BertEncoder
    from multimodal_colpali_tpu_torch.models.configs import BertConfig
    from multimodal_colpali_tpu_torch.models.text_encoder import BgeEmbeddings
    from multimodal_colpali_tpu_torch.store import DenseVectorStore, VectorClient, VectorParams
    from multimodal_colpali_tpu_torch.drivers import create_context
    from multimodal_colpali_tpu_torch.ingest import rasterize as RA
    from multimodal_colpali_tpu_torch.ingest import remote_parse as RP
    from multimodal_colpali_tpu_torch.ingest.ocr_conv import AutoOcr, ConvOcr
    # ``ingest/__init__`` re-exports the function ``pdf_loader`` over its module
    PL = sys.modules["multimodal_colpali_tpu_torch.ingest.pdf_loader"]

    entry_points = [R.load_retriever, VectorClient.__init__, ColPaliModel.__init__,
                    ColIdefics3Model.__init__, ColFlorModel.__init__, score_multi_vector,
                    ColPaliProcessor.score_multi_vector, ColIdefics3Processor.score_multi_vector,
                    ColFlorProcessor.score_multi_vector,
                    R.load_gemma3_lm, R.gemma3_random_params, R.gemma3_random_params_int8,
                    engine_params_from_jax, BgeEmbeddings.__init__, BertEncoder.__init__,
                    DenseVectorStore.__init__, DenseVectorStore.load, PL.pdf_loader,
                    PL.data_preparation, RA.convert_pdfs_to_images, RA.convert_pdf_dir_to_images,
                    RP.pdf_loader1, ConvOcr.__init__, AutoOcr.__init__]
    for fn in entry_points:
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn.__qualname__
    fields = {f.name: f.default for f in dataclasses.fields(GemmaDecodeEngine)}
    assert fields["device"] == "cuda"
    assert serve.parse_args([]).device == "cuda"
    assert create_context.parse_args([]).device == "cuda"

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = Gemma3TextConfig.tiny()
    params = R.gemma3_random_params(cfg, device="cpu")
    emb = [np.ones((2, 8), np.float32)]
    calls = [lambda: R.load_retriever("tiny-colpali"), lambda: VectorClient(),
             lambda: ColPaliModel(ColPaliModelConfig.tiny()),
             lambda: ColIdefics3Model(ColIdefics3ModelConfig.tiny()),
             lambda: ColFlorModel(ColFlorModelConfig.tiny()),
             lambda: R.load_retriever("tiny-colflor"),
             lambda: score_multi_vector(emb, emb),
             lambda: R.load_gemma3_lm("tiny-gemma3"),
             lambda: R.gemma3_random_params_int8(cfg),
             lambda: GemmaDecodeEngine(cfg, params),
             lambda: serve.build(serve.parse_args(["--model", "tiny-gemma3"])),
             lambda: BgeEmbeddings(cfg=BertConfig.tiny()), lambda: BertEncoder(BertConfig.tiny()),
             lambda: DenseVectorStore("d", dim=8), lambda: ConvOcr(), lambda: AutoOcr(),
             lambda: RA.convert_pdf_dir_to_images(str(REPO)),
             lambda: PL.pdf_loader([], [], [], str(REPO / "build"), None)]
    # a dense collection on a CPU client keeps its corpus on the CPU
    client = VectorClient(device="cpu")
    client.create_collection("d", VectorParams(size=8))
    assert client._get("d").device == torch.device("cpu")
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
