"""Build the package's CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` is compiled on its own, at first use, into
``build/kernels/<name>-<hash>.so`` at the root of the checkout, where
``<hash>`` covers the file, the shared headers and the compiler flags; a
changed source therefore builds anew and an unchanged one loads from disk.
The libraries have a plain C interface: pointers and the CUDA stream go in
as integers, and every entry point returns ``cudaGetLastError()`` after its
launch, which :func:`check` turns into an exception. A failed build raises;
nothing falls back to another implementation.

Triton kernels (K3) cache their compiled form under ``build/triton`` unless
``TRITON_CACHE_DIR`` is already set.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Tuple

PACKAGE_DIR = Path(__file__).resolve().parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build"
KERNEL_DIR = BUILD_DIR / "kernels"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
# C signatures of the entry points, by library.
SIGNATURES: Dict[str, Dict[str, tuple]] = {
    "maxsim": {
        # q, d, q_lens, d_lens, out, B, NQ, P, NT, DIM, dtype, stream
        "maxsim_launch": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    },
    "attention": {
        # q, k, v, o, kv_lens, kv_valid, B, S, H, D, scale, causal, dtype, stream
        "attention_launch": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                             ctypes.c_float, _I, _I, _P),
    },
}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                           "are built from csrc/ at first use")
    return found


def library_path(name: str) -> Path:
    src = CSRC_DIR / f"{name}.cu"
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in [*sorted(CSRC_DIR.glob("*.cuh")), src]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return KERNEL_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _compile(names: Iterable[str]) -> None:
    """Run nvcc for every library not on disk yet, all at once."""
    jobs: Dict[str, Tuple[subprocess.Popen, Path, Path]] = {}
    nvcc = None
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        nvcc = nvcc or nvcc_path()
        KERNEL_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs[name] = (proc, out, tmp)
    failures = []
    for name, (proc, out, tmp) in jobs.items():
        log, _ = proc.communicate()
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failures.append(f"nvcc failed for csrc/{name}.cu "
                            f"(exit {proc.returncode}):\n{log[-6000:]}")
            continue
        os.replace(tmp, out)
    if failures:
        raise RuntimeError("\n".join(failures))


def build_all() -> Dict[str, Path]:
    """Compile every library in ``SIGNATURES`` (in parallel) and load them."""
    with _lock:
        _compile(n for n in SIGNATURES if n not in _libs)
    for name in SIGNATURES:
        load(name)
    return {name: library_path(name) for name in SIGNATURES}


def load(name: str) -> ctypes.CDLL:
    """The library ``name`` with its entry points typed, built if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            _compile([name])
            lib = ctypes.CDLL(str(library_path(name)))
            for fn, argtypes in SIGNATURES[name].items():
                f = getattr(lib, fn)
                f.argtypes = list(argtypes)
                f.restype = ctypes.c_int
            lib.cuda_error_string.argtypes = [ctypes.c_int]
            lib.cuda_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a kernel entry point reported a CUDA error."""
    if code != 0:
        msg = lib.cuda_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


def ensure_triton_cache() -> None:
    os.environ.setdefault("TRITON_CACHE_DIR", str(BUILD_DIR / "triton"))
