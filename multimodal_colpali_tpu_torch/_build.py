"""Build the package's CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` is compiled on its own, at first use, into
``build/kernels/<name>-<hash>.so`` at the root of the checkout, where
``<hash>`` covers the file, the shared headers and the compiler flags; a
changed source therefore builds anew and an unchanged one loads from disk.
The libraries have a plain C interface: pointers and the CUDA stream go in
as integers, and every entry point returns ``cudaGetLastError()`` after its
launch, which :func:`check` turns into an exception. A failed build raises;
nothing falls back to another implementation.

``maxsim.cu`` holds K1 and K4, ``attention.cu`` K2, ``fused_layer.cu`` the
GEMM that K5a-c are built from and its LayerNorm statistics pre-pass,
``paged_attention.cu`` K7a and K7b, ``int8_matmul.cu`` K8a and K8b,
``window_attention.cu`` K6, ``int4_matmul.cu`` K9, ``normalize.cu`` K3.

The host PDF library of the ingest stage, ``native/src/mmpdf.cpp``, is C++
for the CPU: :func:`build_native` compiles it with g++, together with the
port's JPEG decoder ``native/jpeg/jpegdec.cpp`` (libjpeg's interface), into
``build/native/libmmpdf-<hash>.so`` at first use, on the same terms.
"""

from __future__ import annotations

import ctypes
import fcntl
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
        # q, d, q_lens, d_lens, out, next_page, B, NQ, r0, P, NT, DIM, dtype,
        # tensor_core, stream
        "maxsim_launch": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P),
        # q, codes, scales, q_lens, d_lens, out, next_page, B, NQ, r0, P, NT, DIM,
        # tensor_core, stream
        "maxsim_int8_launch": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    },
    "attention": {
        # q, k, v, o, kv_lens, kv_valid, B, S, H, D, scale, causal, dtype,
        # block_q, stream
        "attention_launch": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                             ctypes.c_float, _I, _I, _I, _P),
    },
    "fused_layer": {
        # A, stats, ln_g, ln_b, eps, w0, w1, w2, b0, b1, b2, resid, C, M, N, K,
        # Nseg, epilogue, dtype, bn, grid, stream
        "gemm_launch": (_P, _P, _P, _P, ctypes.c_float, _P, _P, _P, _P, _P, _P, _P, _P,
                        _I, _I, _I, _I, _I, _I, _I, _I, _P),
        # A, stats, M, K, eps, stream
        "ln_stats_launch": (_P, _P, _I, _I, ctypes.c_float, _P),
    },
    "paged_attention": {
        # q, k_pool, v_pool, k_scale, v_scale, block_tables, lengths, out, partials,
        # B, Hq, Hkv, D, page, NB, scale, window, splits, tensor_core, q_dtype,
        # kv_dtype, stream
        "paged_attention_launch": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                   _I, _I, ctypes.c_float, _I, _I, _I, _I, _I, _P),
        # lengths, out, B, window, total, splits, stream
        "paged_attention_deal": (_P, _P, _I, _I, _I, _I, _P),
    },
    "int8_matmul": {
        # x, codes, scale, out, partial, M, N, K, layout, out_dtype, splits, stream
        "int8_matmul_launch": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    },
    "window_attention": {
        # q, k, v, out, N, S, D, scale, dtype, stream
        "window_attention_launch": (_P, _P, _P, _P, _I, _I, _I, ctypes.c_float, _I, _P),
        # the ring kernel's persistent grid on the current device
        "window_attention_grid": (),
    },
    "int4_matmul": {
        # x, packed, scale, out, partial, M, N, K, G, out_dtype, splits, stream
        "int4_matmul_launch": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    },
    "normalize": {
        # x, out, n, scale0, scale1, scale2, bias0, bias1, bias2, stream
        "normalize_launch": (_P, _P, ctypes.c_longlong, *(ctypes.c_float,) * 6, _P),
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


def _typed(name: str, path: Path) -> ctypes.CDLL:
    """The library at ``path`` with the entry points of ``name`` typed."""
    lib = ctypes.CDLL(str(path))
    for fn, argtypes in SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.argtypes = list(argtypes)
        f.restype = ctypes.c_int
    lib.cuda_error_string.argtypes = [ctypes.c_int]
    lib.cuda_error_string.restype = ctypes.c_char_p
    return lib


def load(name: str) -> ctypes.CDLL:
    """The library ``name`` with its entry points typed, built if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            _compile([name])
            lib = _libs[name] = _typed(name, library_path(name))
        return lib


def build_variant(name: str, flags: str) -> ctypes.CDLL:
    """``csrc/<name>.cu`` built anew with the extra nvcc ``flags`` (a probe
    build, such as ``-DMAXSIM_SKIP_PRODUCTS``) into ``build/sweep/``, typed
    as :func:`load`'s library. The package's own calls never use it: a sweep
    passes it to the launch it times."""
    out_dir = BUILD_DIR / "sweep"
    out_dir.mkdir(parents=True, exist_ok=True)
    tag = hashlib.sha256(f"{library_path(name).name} {flags}".encode()).hexdigest()[:16]
    so = out_dir / f"{name}-{tag}.so"
    if not so.exists():
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        proc = subprocess.run([nvcc_path(), *NVCC_FLAGS, *flags.split(), "-o", str(tmp),
                               str(CSRC_DIR / f"{name}.cu")], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for csrc/{name}.cu with {flags!r} "
                               f"(exit {proc.returncode}):\n{(proc.stdout + proc.stderr)[-6000:]}")
        os.replace(tmp, so)
    return _typed(name, so)


NATIVE_SRC = PACKAGE_DIR / "native" / "src" / "mmpdf.cpp"
# libjpeg's interface served by the port's own decoder (jpegdec.cpp), which
# mmpdf.cpp is built against on every machine: the card's has no libjpeg
JPEG_DIR = PACKAGE_DIR / "native" / "jpeg"
JPEG_SRC = JPEG_DIR / "jpegdec.cpp"
# the port's baseline encoder (Pillow's bytes), linked into the same library
JPEG_ENC_SRC = JPEG_DIR / "jpegenc.cpp"
NATIVE_DIR = BUILD_DIR / "native"
GXX_FLAGS = ("-O2", "-fPIC", "-shared")
_native_lock = threading.Lock()


def native_command(out: Path) -> list:
    """The g++ command that builds ``mmpdf.cpp`` with the port's JPEG decoder
    and encoder into ``out`` (zlib from the machine, no libjpeg)."""
    return ["g++", *GXX_FLAGS, f"-I{JPEG_DIR}", "-o", str(out), str(NATIVE_SRC),
            str(JPEG_SRC), str(JPEG_ENC_SRC), "-lz"]


def native_library_path() -> Path:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    for p in (NATIVE_SRC, JPEG_DIR / "jpeglib.h", JPEG_SRC, JPEG_ENC_SRC):
        h.update(p.read_bytes())
    return NATIVE_DIR / f"libmmpdf-{h.hexdigest()[:16]}.so"


def build_native() -> Path:
    """``mmpdf.cpp`` built with g++ (once; later calls find it on disk) -> the
    shared library. A failed build raises."""
    with _native_lock:
        out = native_library_path()
        NATIVE_DIR.mkdir(parents=True, exist_ok=True)
        # another process may be building the same library: wait for it
        with open(NATIVE_DIR / "build.lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            if not out.exists():
                tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
                proc = subprocess.run(native_command(tmp), capture_output=True, text=True)
                if proc.returncode != 0:
                    tmp.unlink(missing_ok=True)
                    raise RuntimeError(
                        f"g++ failed for native/src/mmpdf.cpp (exit {proc.returncode}):\n"
                        f"{(proc.stdout + proc.stderr)[-6000:]}")
                os.replace(tmp, out)
        return out


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a kernel entry point reported a CUDA error."""
    if code != 0:
        msg = lib.cuda_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
