"""MaxSim late-interaction scoring (counterpart of ``multimodal_colpali_tpu/ops/maxsim.py``).

    scores[b, p] = sum_{i < q_len[b]}  max_{j < d_len[p]}  <Q[b, i], D[p, j]>

Three functions:

- :func:`maxsim_scores_reference` - the plain PyTorch version, the numeric
  oracle (the JAX package's ``maxsim_scores_reference``, maxsim.py:58-88).
- :func:`maxsim_scores_cuda` - the hand-written CUDA kernel K1
  (``csrc/maxsim.cu``) that replaces the TPU kernel ``_maxsim_kernel``.
- :func:`maxsim_scores` - the dispatcher: a CPU tensor takes the plain
  version, a CUDA tensor the kernel. There is no fallback between them.

Invalid page tokens are masked with the finite ``MASK_VALUE``, so a page
with no valid tokens scores about ``-NQ * 1e30``; the store relies on that to
drop filtered pages.
"""

from __future__ import annotations

from typing import Optional

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
    q = q.float()
    d = d.float()
    sim = torch.einsum("bqd,ptd->bpqt", q, d)  # [B, P, NQ, NT]
    if d_lens is not None:
        nt = d.shape[1]
        d_mask = torch.arange(nt, device=d.device)[None, :] < d_lens.to(d.device)[:, None]
        sim = sim.masked_fill(~d_mask[None, :, None, :], MASK_VALUE)
    per_query_token = sim.amax(dim=-1)  # [B, P, NQ]
    if q_lens is not None:
        nq = q.shape[1]
        q_mask = torch.arange(nq, device=q.device)[None, :] < q_lens.to(q.device)[:, None]
        per_query_token = per_query_token.masked_fill(~q_mask[:, None, :], 0.0)
    return per_query_token.sum(dim=-1)


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

