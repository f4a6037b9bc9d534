"""Build, dispatch and bring-up-script behaviour of the port that a machine
without a GPU or nvcc can check: a failed build raises, kernel wrappers
refuse CPU tensors instead of falling back, and ``chip_smoke.py`` refuses to
run (exit code, no result line) without CUDA or outside a checkout.
"""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from multimodal_colpali_tpu_torch import _build
from multimodal_colpali_tpu_torch.ops import attention as A
from multimodal_colpali_tpu_torch.ops import maxsim as M
from multimodal_colpali_tpu_torch.ops import preprocess as PP

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


def test_check_raises_on_cuda_error_codes():
    class Lib:
        @staticmethod
        def cuda_error_string(code):
            return b"invalid argument"

    _build.check(Lib, 0, "launch")
    with pytest.raises(RuntimeError, match="launch: CUDA error 1 \\(invalid argument\\)"):
        _build.check(Lib, 1, "launch")


def test_triton_cache_defaults_into_build_dir(monkeypatch):
    monkeypatch.delenv("TRITON_CACHE_DIR", raising=False)
    _build.ensure_triton_cache()
    assert Path(os.environ["TRITON_CACHE_DIR"]) == _build.BUILD_DIR / "triton"
    monkeypatch.setenv("TRITON_CACHE_DIR", "/elsewhere")
    _build.ensure_triton_cache()
    assert os.environ["TRITON_CACHE_DIR"] == "/elsewhere"


@pytest.mark.parametrize("call", [
    lambda: M.maxsim_scores_cuda(torch.zeros(1, 2, 8), torch.zeros(3, 4, 8)),
    lambda: A.fused_attention_cuda(*(torch.zeros(1, 4, 2, 8),) * 3, scale=1.0),
    lambda: PP.normalize_images_triton(torch.zeros(1, 4, 4, 3, dtype=torch.uint8)),
], ids=["maxsim", "attention", "normalize"])
def test_kernel_wrappers_refuse_cpu_tensors(call):
    counters = (M.maxsim_scores_cuda.launches, A.fused_attention_cuda.launches,
                PP.normalize_images_triton.launches)
    with pytest.raises(ValueError, match="CUDA"):
        call()
    assert counters == (M.maxsim_scores_cuda.launches, A.fused_attention_cuda.launches,
                        PP.normalize_images_triton.launches)


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
