"""Weight-only int8 matrix products (counterpart of
``multimodal_colpali_tpu/ops/int8_matmul.py``).

Two weight layouts, one per consumer:

- ``int8_matmul_kn``: ``x [M, K] @ codes [K, N] * scale [N]`` (projections;
  ``quantize_int8(w, axis=0)``) - kernel K8a;
- ``int8_matmul_nk``: ``x [M, K] @ codes [N, K]^T * scale [N]`` (the tied LM
  head over the row-quantized embed table) - kernel K8b.

Each is a dispatcher: a CPU tensor takes :func:`int8_matmul_reference`, the
JAX package's ``int8_matmul_xla`` (int8_matmul.py:73-79: widen the codes to
x's dtype, multiply, then scale in x's dtype); a CUDA tensor takes the
hand-written kernel (``csrc/int8_matmul.cu``), which multiplies the float32
accumulator by the float32 scale before it casts, as the TPU kernels do. The
kernels take every shape: unlike the TPU dispatch (int8_matmul.py:66-70),
there is no gate on K, N or M.

K8a has two tiles, both widening the codes in registers into tensor-core
fragments: the decode tile for M <= 16 and the prefill tile
(``csrc/wstream.cuh``, shared with K9) for larger M; its wrapper counts each
(``.decode_launches`` / ``.prefill_launches``). K8b is one WMMA kernel.
"""

from __future__ import annotations

from typing import Optional

import torch

from multimodal_colpali_tpu_torch import _build
from multimodal_colpali_tpu_torch.ops._grad import refuse_grad

_OUT_CODES = {torch.float32: 0, torch.bfloat16: 1}
# K8b's tile (csrc/int8_matmul.cu)
_BN = 128                   # its N tile
_BLOCKS_PER_SM = 4          # split K until about this many blocks per SM
# K8a's tiles: decode (M <= 16) and the prefill tile K9 shares (csrc/wstream.cuh)
DECODE_ROWS = 16
_DECODE_BN, _DECODE_BK = 256, 64   # columns a block, K rows a stage
_DECODE_BLOCKS_PER_SM = 2          # its ring and 128-register cap fit two
_DECODE_MIN_STEPS = 8              # a split's partial stays small beside its codes
_PREFILL_BM, _PREFILL_BN = 128, 256  # tokens and columns a block
_PREFILL_MIN_STEPS = 4
_PREFILL_MAX_SPLITS = 4


def int8_matmul_reference(x: torch.Tensor, codes: torch.Tensor, scale: torch.Tensor,
                          transpose_codes: bool = False) -> torch.Tensor:
    """The plain version of K8a (K8b with ``transpose_codes``)."""
    w = codes.to(x.dtype)
    y = x @ (w.T if transpose_codes else w)
    return y * scale.to(x.dtype)


def decode_splits(blocks: int, steps: int, sms: int) -> int:
    """The decode tiles' K splits (K8a's and K9's): one wave of two blocks an
    SM, at least 8 stages a split."""
    return max(1, min(_DECODE_BLOCKS_PER_SM * sms // blocks, steps // _DECODE_MIN_STEPS))


def prefill_splits(m: int, n: int, steps: int, sms: int) -> int:
    """The prefill tile's K splits (K8a's and K9's): 1 where its grid of
    128-token x 256-column blocks fills a wave; else the count (at most 4, at
    least 4 stages a split) that leaves the least of the last wave idle,
    fewest first."""
    blocks = -(-m // _PREFILL_BM) * -(-n // _PREFILL_BN)
    best, best_waves = 1, 1.0
    if blocks < sms:
        for s in range(2, min(_PREFILL_MAX_SPLITS, steps // _PREFILL_MIN_STEPS) + 1):
            waves = -(-blocks * s // sms) / s
            if waves < best_waves:
                best, best_waves = s, waves
    return best


def even_splits(splits: int, steps: int) -> int:
    """``splits`` made whole: each range a whole number of stages, none empty."""
    per = -(-steps // splits)
    return -(-steps // per)


def split_count(m: int, n: int, k: int, sms: int, nk: bool = False) -> int:
    """How many K ranges the kernel splits a product into on a card of
    ``sms`` multiprocessors, each range a whole number of K steps and none
    empty. K8a (``nk`` False): its decode tile (M <= 16) fills one wave, at
    least 8 stages of 64 K rows a split; its prefill tile splits only a grid
    smaller than a wave. K8b: about 4 blocks an SM."""
    if not nk:
        steps = -(-k // _DECODE_BK)
        if m <= DECODE_ROWS:
            splits = decode_splits(-(-n // _DECODE_BN), steps, sms)
        else:
            splits = prefill_splits(m, n, steps, sms)
        return even_splits(splits, steps)
    bm, bk = (16, 64) if m <= 16 else (128, 32)   # K8b's row tile and K step
    blocks = -(-m // bm) * -(-n // _BN)
    steps = -(-k // bk)
    splits = max(1, min(-(-_BLOCKS_PER_SM * sms // blocks), steps // 8))
    return even_splits(splits, steps)


def _int8_matmul_cuda(x: torch.Tensor, codes: torch.Tensor, scale: torch.Tensor,
                      nk: bool, out_dtype: Optional[torch.dtype], wrapper) -> torch.Tensor:
    name = wrapper.__name__
    refuse_grad(name, x, codes, scale)
    if not (x.is_cuda and codes.device == x.device and scale.device == x.device):
        raise ValueError(f"{name} needs x, codes and scale on one CUDA device")
    if x.dim() != 2 or codes.dim() != 2:
        raise ValueError(f"{name}: x and codes must be 2-D, got {tuple(x.shape)}, "
                         f"{tuple(codes.shape)}")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"{name}: x must be bfloat16, got {x.dtype}")
    if codes.dtype != torch.int8:
        raise TypeError(f"{name}: codes must be int8, got {codes.dtype}")
    m, k = x.shape
    n, kc = (codes.shape if nk else codes.shape[::-1])
    if kc != k:
        raise ValueError(f"{name}: x {tuple(x.shape)} does not fit codes {tuple(codes.shape)}")
    if scale.shape != (n,):
        raise ValueError(f"{name}: scale must be [{n}], got {tuple(scale.shape)}")
    out_dtype = out_dtype or x.dtype
    if out_dtype not in _OUT_CODES:
        raise TypeError(f"{name}: out_dtype must be float32 or bfloat16, got {out_dtype}")
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    if out.numel() == 0 or k == 0:
        return out.zero_()
    x, codes = x.contiguous(), codes.contiguous()
    scale = scale.to(torch.float32).contiguous()
    splits = split_count(m, n, k, torch.cuda.get_device_properties(x.device).multi_processor_count,
                         nk)
    partial = (torch.empty((splits, m, n), dtype=torch.float32, device=x.device)
               if splits > 1 else None)
    lib = _build.load("int8_matmul")
    code = lib.int8_matmul_launch(
        x.data_ptr(), codes.data_ptr(), scale.data_ptr(), out.data_ptr(),
        None if partial is None else partial.data_ptr(), m, n, k, int(nk),
        _OUT_CODES[out_dtype], splits, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, code, "int8_matmul_launch")
    wrapper.launches += 1
    if not nk:
        if m <= DECODE_ROWS:
            wrapper.decode_launches += 1
        else:
            wrapper.prefill_launches += 1
    return out


def int8_matmul_kn_cuda(x: torch.Tensor, codes: torch.Tensor, scale: torch.Tensor,
                        out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """K8a on the card: bf16 ``x [M, K]`` times int8 ``codes [K, N]`` times
    float32 ``scale [N]``, out in ``out_dtype`` (x's by default). Adds one to
    ``int8_matmul_kn_cuda.launches`` per launch, and one to
    ``.decode_launches`` (M <= 16) or ``.prefill_launches`` by the tile."""
    return _int8_matmul_cuda(x, codes, scale, False, out_dtype, int8_matmul_kn_cuda)


int8_matmul_kn_cuda.launches = 0
int8_matmul_kn_cuda.decode_launches = 0
int8_matmul_kn_cuda.prefill_launches = 0


def int8_matmul_nk_cuda(x: torch.Tensor, codes: torch.Tensor, scale: torch.Tensor,
                        out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """K8b on the card: bf16 ``x [M, K]`` times int8 ``codes [N, K]``
    transposed times float32 ``scale [N]``. Adds one to
    ``int8_matmul_nk_cuda.launches`` per launch."""
    return _int8_matmul_cuda(x, codes, scale, True, out_dtype, int8_matmul_nk_cuda)


int8_matmul_nk_cuda.launches = 0


def int8_matmul_kn(x: torch.Tensor, codes: torch.Tensor, scale: torch.Tensor,
                   out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``x @ codes * scale``: K8a for a CUDA tensor, the plain version for a CPU one."""
    if x.device.type == "cuda":
        return int8_matmul_kn_cuda(x, codes, scale, out_dtype)
    if x.device.type == "cpu":
        return int8_matmul_reference(x, codes, scale).to(out_dtype or x.dtype)
    raise ValueError(f"int8_matmul_kn: unsupported device {x.device}")


def int8_matmul_nk(x: torch.Tensor, codes: torch.Tensor, scale: torch.Tensor,
                   out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``x @ codes.T * scale``: K8b for a CUDA tensor (x rounded to bf16, as
    the TPU kernel takes it), the plain version for a CPU one."""
    if x.device.type == "cuda":
        return int8_matmul_nk_cuda(x.to(torch.bfloat16), codes, scale, out_dtype)
    if x.device.type == "cpu":
        return int8_matmul_reference(x, codes, scale, transpose_codes=True).to(
            out_dtype or x.dtype)
    raise ValueError(f"int8_matmul_nk: unsupported device {x.device}")
