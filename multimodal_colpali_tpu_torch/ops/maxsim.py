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

On the card, a bf16 corpus or int8 codes with DIM a multiple of 16 (up to
128; the store's pages of ColPali, ColSmol and ColFlor, DIM 128) take the
tensor-core kernel ``maxsim_mma``; a float32 corpus (the embeddings that
``score_results`` and ``score_multi_vector`` pad, as the JAX package does)
and other DIMs (a multiple of 8 up to 128) take the CUDA-core kernel
``maxsim_kernel`` (:func:`tensor_core_path`). Each page is scored whole by
one block. A tensor-core launch takes whole queries of at most
``ROWS_PER_LAUNCH`` rows in all (:func:`launch_groups`), or a window of
``ROWS_PER_LAUNCH`` rows of one longer query (:func:`launch_plan`); a
CUDA-core launch takes up to 1,024 queries and walks their rows in passes.

Invalid page tokens are masked with the finite ``MASK_VALUE``, so a page
with no valid tokens scores about ``-NQ * 1e30``; the store relies on that to
drop filtered pages.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from multimodal_colpali_tpu_torch import _build
from multimodal_colpali_tpu_torch.ops._grad import refuse_grad

# Large but finite: a page with zero valid tokens ranks last and never
# produces NaN in the per-query sums.
MASK_VALUE = -1e30

# Query rows a launch: the tensor-core kernel's rows (8 warps of two m16
# tiles). Each launch reads the corpus once, so at many queries this sets the
# bytes: a bf16 launch of R rows does R FLOP a byte read. 256 rows beat 128
# at 120 queries on the card, and tie at 1 and 4 (PERF.md, section 6).
ROWS_PER_LAUNCH = 256
# Queries a CUDA-core launch: their running sums live in shared memory.
_CUDA_CORE_QUERIES = 1024
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def tensor_core_path(dtype: torch.dtype, dim: int, nq: int = 1) -> bool:
    """Whether queries of ``nq`` rows against a corpus of ``dtype`` (bf16
    pages or int8 codes) and width ``dim`` run on the tensor-core kernel
    rather than the CUDA-core one."""
    return (dtype in (torch.bfloat16, torch.int8) and dim % 16 == 0 and 16 <= dim <= 128
            and nq > 0)


def launch_groups(b: int, nq: int):
    """``(first query, queries)`` of each tensor-core launch for ``b``
    queries of ``nq`` rows: whole queries, at most ``ROWS_PER_LAUNCH`` rows a
    launch, and a query of more rows alone."""
    per = max(1, ROWS_PER_LAUNCH // max(nq, 1))
    return [(b0, min(per, b - b0)) for b0 in range(0, b, per)]


def launch_plan(b: int, nq: int):
    """``(first query, queries, first row)`` of each tensor-core launch:
    :func:`launch_groups`, with a query of more than ``ROWS_PER_LAUNCH`` rows
    split into launches of that many rows in order (each scores rows [first
    row, + ROWS_PER_LAUNCH) and adds them to the sums the launch before it
    left)."""
    return [(b0, nb, r0) for b0, nb in launch_groups(b, nq)
            for r0 in range(0, nq if nq > ROWS_PER_LAUNCH else 1, ROWS_PER_LAUNCH)]


def _plan(tc: bool, b: int, nq: int):
    """The launches of a call: :func:`launch_plan` on the tensor cores; on
    the CUDA cores up to ``_CUDA_CORE_QUERIES`` queries a launch, each from
    row 0 (its kernel walks their rows in passes: one launch of 30 passes at
    120 queries of 32 rows measured 3% faster than 15 launches of 2)."""
    if tc:
        return launch_plan(b, nq)
    step = _CUDA_CORE_QUERIES
    return [(b0, min(step, b - b0), 0) for b0 in range(0, b, step)]


def _count(fn, tc: bool) -> None:
    fn.launches += 1
    if tc:
        fn.tensor_core_launches += 1
    else:
        fn.cuda_core_launches += 1


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself, or a copy when it does not start on 16 bytes (the bulk
    copies of the tensor-core kernel need that)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


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
    128: bf16 with DIM % 16 == 0 runs on the tensor cores, the rest on the
    CUDA cores. Adds one to ``maxsim_scores_cuda.launches`` per kernel
    launch, and to ``.tensor_core_launches`` or ``.cuda_core_launches`` by
    the path it took."""
    return _launch(maxsim_scores_cuda, q, d, None, q_lens, d_lens)


maxsim_scores_cuda.launches = 0
maxsim_scores_cuda.tensor_core_launches = 0
maxsim_scores_cuda.cuda_core_launches = 0


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
    as in the TPU kernel. DIM must be a multiple of 8 up to 128: DIM % 16 ==
    0 runs on the tensor cores, the rest on the CUDA cores. Adds one to
    ``maxsim_scores_int8_cuda.launches`` per kernel launch, and to
    ``.tensor_core_launches`` or ``.cuda_core_launches`` by its path."""
    return _launch(maxsim_scores_int8_cuda, q, codes, scales, q_lens, d_lens)


maxsim_scores_int8_cuda.launches = 0
maxsim_scores_int8_cuda.tensor_core_launches = 0
maxsim_scores_int8_cuda.cuda_core_launches = 0


def _launch(wrapper, q, d, scales, q_lens, d_lens, lib=None):
    """The launches of one call of K1 (``scales`` None: a bf16 or float32
    corpus ``d``) or K4 (int8 codes ``d`` with their ``scales``), counted on
    ``wrapper``; ``lib`` (default the package's build) is for
    ``maxsim_sweep``'s probe builds."""
    name = wrapper.__name__
    int8 = scales is not None
    tensors = [q, d, scales] if int8 else [q, d]
    refuse_grad(name, *tensors)
    if not all(t.is_cuda and t.device == q.device for t in tensors):
        raise ValueError(f"{name} needs every input on one CUDA device")
    if q.dim() != 3 or d.dim() != 3 or q.shape[2] != d.shape[2]:
        raise ValueError(f"{name}: expected [B, NQ, DIM] x [P, NT, DIM], got "
                         f"{tuple(q.shape)} x {tuple(d.shape)}")
    if int8:
        if d.dtype != torch.int8:
            raise TypeError(f"{name}: codes must be int8, got {d.dtype}")
        if scales.shape != d.shape[:2]:
            raise ValueError(f"{name}: scales must be [P, NT] = {tuple(d.shape[:2])}, "
                             f"got {tuple(scales.shape)}")
    elif d.dtype not in _DTYPE_CODES:
        raise TypeError(f"{name}: corpus dtype must be float32 or bfloat16, got {d.dtype}")
    b, nq, dim = q.shape
    p, nt, _ = d.shape
    if dim % 8 or not 8 <= dim <= 128:
        raise ValueError(f"{name}: DIM must be a multiple of 8 in [8, 128], got {dim}")
    tc = tensor_core_path(d.dtype, dim, nq)
    plan = _plan(tc, b, nq)
    q = q.to(torch.bfloat16 if d.dtype == torch.bfloat16 else torch.float32).contiguous()
    d = _aligned(d.contiguous())
    if int8:
        scales = _aligned(scales.to(torch.float32).contiguous())
    q_lens = _lens(q_lens, b, nq, q.device)
    d_lens = _lens(d_lens, p, nt, q.device)
    out = torch.empty((b, p), dtype=torch.float32, device=q.device)
    if b == 0 or p == 0:
        return out
    next_page = torch.empty(len(plan), dtype=torch.int32, device=q.device)
    lib = lib or _build.load("maxsim")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    q_row = nq * dim * q.element_size()
    for i, (b0, nb, r0) in enumerate(plan):
        head = (q.data_ptr() + b0 * q_row, d.data_ptr())
        tail = (q_lens.data_ptr() + 4 * b0, d_lens.data_ptr(), out.data_ptr() + 4 * b0 * p,
                next_page.data_ptr() + 4 * i, nb, nq, r0, p, nt, dim)
        if int8:
            code = lib.maxsim_int8_launch(*head, scales.data_ptr(), *tail, int(tc), stream)
        else:
            code = lib.maxsim_launch(*head, *tail, _DTYPE_CODES[d.dtype], int(tc), stream)
        _build.check(lib, code, "maxsim_int8_launch" if int8 else "maxsim_launch")
        _count(wrapper, tc)
    return out


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

