"""MaxSim late-interaction scoring (counterpart of ``multimodal_colpali_tpu/ops/maxsim.py``).

    scores[b, p] = sum_{i < q_len[b]}  max_{j < d_len[p]}  <Q[b, i], D[p, j]>

Three functions for a float corpus:

- :func:`maxsim_scores_reference` - the plain PyTorch version, the numeric
  oracle (the JAX package's ``maxsim_scores_reference``, maxsim.py:58-88).
- :func:`maxsim_scores_cuda` - the hand-written CUDA kernel K1
  (``csrc/maxsim.cu``) that replaces the TPU kernel ``_maxsim_kernel``.
- :func:`maxsim_scores` - the dispatcher: a CPU tensor takes the plain
  version, a CUDA tensor the kernel. There is no fallback between them.

and the same three for an int8 corpus with per-token scales (the store's
quantized prefilter): :func:`maxsim_scores_int8_reference`,
:func:`maxsim_scores_int8_cuda` (K4, also in ``csrc/maxsim.cu``, replacing
``_maxsim_int8_kernel``) and :func:`maxsim_scores_int8`, beside
:func:`quantize_corpus_int8`, which makes the codes.

Invalid page tokens are masked with the finite ``MASK_VALUE``, so a page
with no valid tokens scores about ``-NQ * 1e30``; the store relies on that to
drop filtered pages.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from multimodal_colpali_tpu_torch import _build

# Large but finite: a page with zero valid tokens ranks last and never
# produces NaN in the per-query sums.
MASK_VALUE = -1e30

_MAX_QUERIES_PER_LAUNCH = 1024  # per-query sums live in shared memory
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def maxsim_scores_reference(
    q: torch.Tensor,
    d: torch.Tensor,
    q_lens: Optional[torch.Tensor] = None,
    d_lens: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """MaxSim by plain einsum in float32: ``[B, NQ, DIM] x [P, NT, DIM] -> [B, P]``."""
    sim = torch.einsum("bqd,ptd->bpqt", q.float(), d.float())  # [B, P, NQ, NT]
    return _mask_max_sum(sim, q_lens, d_lens)


def _lens(lens: Optional[torch.Tensor], n: int, full: int,
          device: torch.device) -> torch.Tensor:
    if lens is None:
        return torch.full((n,), full, dtype=torch.int32, device=device)
    if lens.shape != (n,):
        raise ValueError(f"lengths must have shape ({n},), got {tuple(lens.shape)}")
    return lens.to(device=device, dtype=torch.int32).contiguous()


def maxsim_scores_cuda(
    q: torch.Tensor,
    d: torch.Tensor,
    q_lens: Optional[torch.Tensor] = None,
    d_lens: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """K1 on the card: ``[B, NQ, DIM] x [P, NT, DIM] -> [B, P]`` float32.

    The corpus ``d`` is bf16 or float32; as in the TPU wrapper
    (maxsim.py:182) the queries are cast to bf16 when the corpus is bf16,
    and are otherwise used in float32. DIM must be a multiple of 8 up to
    128. Adds one to ``maxsim_scores_cuda.launches`` per kernel launch.
    """
    if not (q.is_cuda and d.is_cuda and q.device == d.device):
        raise ValueError("maxsim_scores_cuda needs q and d on the same CUDA device")
    if q.dim() != 3 or d.dim() != 3 or q.shape[2] != d.shape[2]:
        raise ValueError(f"expected [B, NQ, DIM] x [P, NT, DIM], got "
                         f"{tuple(q.shape)} x {tuple(d.shape)}")
    if d.dtype not in _DTYPE_CODES:
        raise TypeError(f"corpus dtype must be float32 or bfloat16, got {d.dtype}")
    b, nq, dim = q.shape
    p, nt, _ = d.shape
    if dim % 8 or not 8 <= dim <= 128:
        raise ValueError(f"DIM must be a multiple of 8 in [8, 128], got {dim}")
    q = q.to(d.dtype if d.dtype == torch.bfloat16 else torch.float32).contiguous()
    d = d.contiguous()
    q_lens = _lens(q_lens, b, nq, d.device)
    d_lens = _lens(d_lens, p, nt, d.device)
    out = torch.empty((b, p), dtype=torch.float32, device=d.device)
    if b == 0 or p == 0:
        return out
    lib = _build.load("maxsim")
    stream = torch.cuda.current_stream(d.device).cuda_stream
    q_row = nq * dim * q.element_size()
    for b0 in range(0, b, _MAX_QUERIES_PER_LAUNCH):
        nb = min(_MAX_QUERIES_PER_LAUNCH, b - b0)
        code = lib.maxsim_launch(
            q.data_ptr() + b0 * q_row, d.data_ptr(),
            q_lens.data_ptr() + 4 * b0, d_lens.data_ptr(),
            out.data_ptr() + 4 * b0 * p, nb, nq, p, nt, dim,
            _DTYPE_CODES[d.dtype], stream)
        _build.check(lib, code, "maxsim_launch")
        maxsim_scores_cuda.launches += 1
    return out


maxsim_scores_cuda.launches = 0


def maxsim_scores(
    q: torch.Tensor,
    d: torch.Tensor,
    q_lens: Optional[torch.Tensor] = None,
    d_lens: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Score queries against a page-token corpus with MaxSim.

    The corpus's device decides: CPU runs the plain version, CUDA runs K1
    (and raises if K1 cannot take the inputs)."""
    if d.device.type == "cuda":
        return maxsim_scores_cuda(q, d, q_lens, d_lens)
    if d.device.type == "cpu":
        return maxsim_scores_reference(q, d, q_lens, d_lens)
    raise ValueError(f"maxsim_scores: unsupported device {d.device}")


# -- int8 corpus (K4) -----------------------------------------------------------

def quantize_corpus_int8(d: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-token int8 quantization of a ``[P, NT, DIM]`` corpus
    (maxsim.py:343-354): scale = absmax / 127 (1.0 for an all-zero token),
    codes = round-half-to-even(d / scale). Returns (codes int8, scales float32
    ``[P, NT]``), bit for bit the JAX package's."""
    d = d.float()
    absmax = d.abs().amax(dim=-1)
    # A tensor divisor: PyTorch's CUDA division by a Python scalar multiplies
    # by its reciprocal, which rounds differently from a true division.
    scale = torch.where(absmax > 0, absmax / torch.full_like(absmax, 127.0),
                        torch.ones_like(absmax))
    return torch.round(d / scale[..., None]).to(torch.int8), scale


def maxsim_scores_int8_reference(
    q: torch.Tensor,
    codes: torch.Tensor,
    scales: torch.Tensor,
    q_lens: Optional[torch.Tensor] = None,
    d_lens: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """MaxSim over int8 codes with per-token scales, in float32
    (``_maxsim_int8_kernel``, maxsim.py:227-261): the query rounded to bf16,
    the scale applied to each token's dot before the mask and the max."""
    qf = q.to(torch.bfloat16).float()
    sim = torch.einsum("bqd,ptd->bpqt", qf, codes.float())
    sim = sim * scales.float()[None, :, None, :]
    return _mask_max_sum(sim, q_lens, d_lens)


def _mask_max_sum(sim: torch.Tensor, q_lens: Optional[torch.Tensor],
                  d_lens: Optional[torch.Tensor]) -> torch.Tensor:
    """``[B, P, NQ, NT]`` token dots -> ``[B, P]`` masked MaxSim sums."""
    _, p, nq, nt = sim.shape
    if d_lens is not None:
        d_mask = torch.arange(nt, device=sim.device)[None, :] < d_lens.to(sim.device)[:, None]
        sim = sim.masked_fill(~d_mask[None, :, None, :], MASK_VALUE)
    per_query_token = sim.amax(dim=-1)  # [B, P, NQ]
    if q_lens is not None:
        q_mask = torch.arange(nq, device=sim.device)[None, :] < q_lens.to(sim.device)[:, None]
        per_query_token = per_query_token.masked_fill(~q_mask[:, None, :], 0.0)
    return per_query_token.sum(dim=-1)


def maxsim_scores_int8_cuda(
    q: torch.Tensor,
    codes: torch.Tensor,
    scales: torch.Tensor,
    q_lens: Optional[torch.Tensor] = None,
    d_lens: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """K4 on the card: float32 ``[B, NQ, DIM]`` queries against int8 codes
    ``[P, NT, DIM]`` with float32 scales ``[P, NT]`` -> ``[B, P]`` float32.

    The queries go in as float32 and are rounded to bf16 inside the kernel,
    as in the TPU kernel. DIM must be a multiple of 8 up to 128. Adds one to
    ``maxsim_scores_int8_cuda.launches`` per kernel launch."""
    if not (q.is_cuda and codes.device == q.device and scales.device == q.device):
        raise ValueError("maxsim_scores_int8_cuda needs q, codes and scales on one CUDA device")
    if q.dim() != 3 or codes.dim() != 3 or q.shape[2] != codes.shape[2]:
        raise ValueError(f"expected [B, NQ, DIM] x [P, NT, DIM], got "
                         f"{tuple(q.shape)} x {tuple(codes.shape)}")
    if codes.dtype != torch.int8:
        raise TypeError(f"codes must be int8, got {codes.dtype}")
    if scales.shape != codes.shape[:2]:
        raise ValueError(f"scales must be [P, NT] = {tuple(codes.shape[:2])}, "
                         f"got {tuple(scales.shape)}")
    b, nq, dim = q.shape
    p, nt, _ = codes.shape
    if dim % 8 or not 8 <= dim <= 128:
        raise ValueError(f"DIM must be a multiple of 8 in [8, 128], got {dim}")
    q = q.to(torch.float32).contiguous()
    codes = codes.contiguous()
    scales = scales.to(torch.float32).contiguous()
    q_lens = _lens(q_lens, b, nq, q.device)
    d_lens = _lens(d_lens, p, nt, q.device)
    out = torch.empty((b, p), dtype=torch.float32, device=q.device)
    if b == 0 or p == 0:
        return out
    lib = _build.load("maxsim")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    q_row = nq * dim * 4
    for b0 in range(0, b, _MAX_QUERIES_PER_LAUNCH):
        nb = min(_MAX_QUERIES_PER_LAUNCH, b - b0)
        code = lib.maxsim_int8_launch(
            q.data_ptr() + b0 * q_row, codes.data_ptr(), scales.data_ptr(),
            q_lens.data_ptr() + 4 * b0, d_lens.data_ptr(),
            out.data_ptr() + 4 * b0 * p, nb, nq, p, nt, dim, stream)
        _build.check(lib, code, "maxsim_int8_launch")
        maxsim_scores_int8_cuda.launches += 1
    return out


maxsim_scores_int8_cuda.launches = 0


def maxsim_scores_int8(
    q: torch.Tensor,
    codes: torch.Tensor,
    scales: torch.Tensor,
    q_lens: Optional[torch.Tensor] = None,
    d_lens: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """MaxSim over an int8-quantized corpus: the plain version for CPU
    codes, K4 for CUDA codes (which raises if K4 cannot take the inputs)."""
    if codes.device.type == "cuda":
        return maxsim_scores_int8_cuda(q, codes, scales, q_lens, d_lens)
    if codes.device.type == "cpu":
        return maxsim_scores_int8_reference(q, codes, scales, q_lens, d_lens)
    raise ValueError(f"maxsim_scores_int8: unsupported device {codes.device}")

