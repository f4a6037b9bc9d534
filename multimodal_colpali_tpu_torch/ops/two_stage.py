"""Two-stage MaxSim retrieval: pooled prefilter, then exact rescore
(counterpart of ``multimodal_colpali_tpu/ops/two_stage.py``).

Stage 1 scores each page by one pooled vector (the mean of its tokens) or by
``k`` farthest-point-sampled tokens, which is one small matrix product over
the whole corpus. Stage 2 rescores the top ``n_candidates`` pages with exact
MaxSim and returns the top ``k``. These are plain tensor code in the JAX
package (XLA, no Pallas), so they are plain PyTorch here, on whatever device
the corpus is on.

Numerics follow the JAX functions: pooling in float32 cast back to the corpus
dtype; the stage-1 query sum cast to the pooled dtype; the stage-2 rescore
in float32 with a float32 query (not through K1, which would round the query
to bf16 for a bf16 corpus). Candidate selection keeps ``lax.top_k``'s tie
rule, the lower index first, through a stable sort.

``sharded_two_stage_maxsim_topk`` runs both stages over a page-sharded
corpus and returns what the single-device function returns on the whole one.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from multimodal_colpali_tpu_torch.ops.maxsim import MASK_VALUE, quantize_corpus_int8
from multimodal_colpali_tpu_torch.ops.topk import (
    _merge_candidates, rescore_owned, row_dots, topk_with_stable_ties)
from multimodal_colpali_tpu_torch.parallel.mesh import Mesh, all_gather


def _valid(lens: torch.Tensor, n: int) -> torch.Tensor:
    """``[P, n]`` mask of the tokens below each page's length."""
    return torch.arange(n, device=lens.device)[None, :] < lens[:, None]


def _top_indices(scores: torch.Tensor, n: int) -> torch.Tensor:
    """The ``n`` largest entries' indices, lower index first on ties (``lax.top_k``)."""
    return torch.argsort(-scores, stable=True)[:n]


def pool_corpus(d: torch.Tensor, d_lens: torch.Tensor) -> torch.Tensor:
    """``[P, NT, DIM]`` tokens -> ``[P, DIM]`` mean over the valid tokens, in
    float32, cast back to ``d``'s dtype (two_stage.py:47-53)."""
    mask = _valid(d_lens, d.shape[1]).float()
    summed = (d.float() * mask[..., None]).sum(dim=1)
    denom = d_lens.float().clamp_min(1.0)[:, None]
    return (summed / denom).to(d.dtype)


def pool_corpus_fps(d: torch.Tensor, d_lens: torch.Tensor, k: int = 4) -> torch.Tensor:
    """``[P, NT, DIM]`` tokens -> ``[P, k, DIM]`` farthest-point-sampled
    tokens per page (two_stage.py:56-89): the first valid token, then each
    time the valid token farthest from the picks so far (the first such
    token on ties)."""
    p, nt, dim = d.shape
    df = d.float()
    valid = _valid(d_lens, nt)
    picks = torch.zeros((p, k, dim), dtype=torch.float32, device=d.device)
    mindist = torch.full((p, nt), 1e30, dtype=torch.float32, device=d.device)
    neg = torch.tensor(-1e30, dtype=torch.float32, device=d.device)
    for j in range(k):
        idx = torch.argmax(torch.where(valid, mindist, neg), dim=1)  # first maximum
        tok = df[torch.arange(p, device=d.device), idx]              # [P, DIM]
        picks[:, j] = tok
        mindist = torch.minimum(mindist, (df - tok[:, None, :]).square().sum(dim=-1))
    return picks.to(d.dtype)


def _coarse_scores(q: torch.Tensor, q_len: int, pooled: torch.Tensor,
                   d_lens: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Stage-1 scores (two_stage.py:92-110) -> (coarse ``[P]``, float32 query
    ``[NQ, DIM]``, query mask ``[NQ]``). ``pooled`` is ``[P, DIM]`` or
    ``[P, K, DIM]`` (then the score is the max over the K vectors)."""
    nq = q.shape[0]
    qf = q.float()
    qmask = (torch.arange(nq, device=q.device) < q_len).float()
    qsum = (qf * qmask[:, None]).sum(dim=0).to(pooled.dtype).float()
    # on the CPU a page's score must not depend on its place (ops/topk.row_dots)
    coarse = row_dots(pooled, qsum) if pooled.device.type == "cpu" else pooled.float() @ qsum
    if pooled.dim() == 3:
        coarse = coarse.amax(dim=-1)
    return torch.where(d_lens > 0, coarse, torch.full_like(coarse, MASK_VALUE)), qf, qmask


def _rescore(qf: torch.Tensor, qmask: torch.Tensor, pages: torch.Tensor,
             lens: torch.Tensor, scales: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Exact MaxSim of ``pages [C, NT, DIM]`` in float32 -> ``[C]``; each
    page's maxima are summed along its row (a matrix-vector product on the
    CPU rounds a row by its place, ``ops/topk.row_dots``)."""
    sim = torch.einsum("qd,ctd->cqt", qf, pages.float())
    if scales is not None:
        sim = sim * scales.float()[:, None, :]
    tok_valid = _valid(lens, pages.shape[1])[:, None, :]
    sim = sim.masked_fill(~tok_valid, MASK_VALUE)
    return (sim.amax(dim=-1) * qmask).sum(dim=-1)


def _exact_rescore(qf: torch.Tensor, qmask: torch.Tensor, cand: torch.Tensor,
                   d_int8: torch.Tensor, d_scale: torch.Tensor, d_lens: torch.Tensor,
                   d_full: Optional[torch.Tensor]) -> torch.Tensor:
    """Exact MaxSim of the candidate pages, in candidate order -> ``[C]``
    (two_stage.py:113-137): from the originals ``d_full`` when given, else
    from the int8 codes and scales."""
    lens = d_lens[cand]
    if d_full is not None:
        return _rescore(qf, qmask, d_full[cand], lens)
    return _rescore(qf, qmask, d_int8[cand], lens, d_scale[cand])


def two_stage_maxsim_topk(q: torch.Tensor, q_len: int, pooled: torch.Tensor,
                          d_int8: torch.Tensor, d_scale: torch.Tensor, d_lens: torch.Tensor,
                          k: int = 5, n_candidates: int = 32,
                          d_full: Optional[torch.Tensor] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One query ``[NQ, DIM]`` -> (scores ``[k]``, page indices ``[k]``)
    (two_stage.py:140-160)."""
    coarse, qf, qmask = _coarse_scores(q, q_len, pooled, d_lens)
    cand = _top_indices(coarse, n_candidates)
    exact = _exact_rescore(qf, qmask, cand, d_int8, d_scale, d_lens, d_full)
    vals, order = topk_with_stable_ties(exact[None, :], k)
    return vals[0], cand[order[0].long()]


def sharded_two_stage_maxsim_topk(mesh: Mesh, axis: str, q: torch.Tensor, q_len: int,
                                  pooled: torch.Tensor, d_int8: torch.Tensor,
                                  d_scale: torch.Tensor, d_lens: torch.Tensor, k: int = 5,
                                  n_candidates: int = 32, d_full: Optional[torch.Tensor] = None
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two-stage MaxSim over a page-sharded corpus (two_stage.py:163-230):
    ``pooled``, ``d_int8``, ``d_scale``, ``d_lens`` (and ``d_full``) are this
    rank's pages, ``q [NQ, DIM]`` is replicated. Equals
    :func:`two_stage_maxsim_topk` on the unsharded corpus, on every rank.

    Each rank takes its local top ``min(C, p_local)`` coarse pages, the
    candidates of every rank are all-gathered and ordered by id, then by
    score (``lax.top_k``'s tie rule over the whole coarse vector), and the
    global top ``min(C, p_total)`` are rescored by the rank that owns each
    (``ops/topk.rescore_owned``). The traffic is O(C) a rank, whatever the
    corpus size."""
    n_shards, rank = mesh.size(axis), mesh.index(axis)
    p_local = pooled.shape[0]
    c_local = min(n_candidates, p_local)
    c_global = min(n_candidates, p_local * n_shards)
    coarse, qf, qmask = _coarse_scores(q, q_len, pooled, d_lens)
    li = _top_indices(coarse, c_local)
    lv = coarse[li]
    start = rank * p_local
    gv = all_gather(mesh, axis, lv).reshape(-1)     # [S * c_local]
    gi = all_gather(mesh, axis, li + start).reshape(-1)
    _, cand = _merge_candidates(gv, gi, c_global)   # [C] global page ids
    exact = rescore_owned(mesh, axis, cand, start, p_local, lambda local: _exact_rescore(
        qf, qmask, local, d_int8, d_scale, d_lens, d_full))
    vals, order = topk_with_stable_ties(exact[None, :], k)
    return vals[0], cand[order[0].long()]


def coarse_topk(q: torch.Tensor, q_len: int, pooled: torch.Tensor, d_lens: torch.Tensor,
                n_candidates: int = 32) -> torch.Tensor:
    """Stage 1 alone: the candidate page indices ``[n_candidates]``
    (two_stage.py:231-249); the on_disk store gathers them from the host."""
    coarse, _, _ = _coarse_scores(q, q_len, pooled, d_lens)
    return _top_indices(coarse, n_candidates)


def rescore_candidates(q: torch.Tensor, q_len: int, cand_pages: torch.Tensor,
                       cand_lens: torch.Tensor, k: int = 5
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stage 2 over gathered candidates ``[C, NT, DIM]`` -> (scores ``[k]``,
    positions ``[k]`` in the candidate axis) (two_stage.py:252-271)."""
    nq = q.shape[0]
    qf = q.float()
    qmask = (torch.arange(nq, device=q.device) < q_len).float()
    exact = _rescore(qf, qmask, cand_pages, cand_lens)
    vals, order = topk_with_stable_ties(exact[None, :], k)
    return vals[0], order[0]


def build_two_stage_index(d: torch.Tensor, d_lens: torch.Tensor, n_centroids: int = 1
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(pooled, int8 codes, scales) from a token corpus (two_stage.py:274-288);
    ``n_centroids > 1`` pools by farthest-point sampling."""
    if n_centroids > 1:
        pooled = pool_corpus_fps(d, d_lens, k=n_centroids)
    else:
        pooled = pool_corpus(d, d_lens)
    codes, scales = quantize_corpus_int8(d)
    return pooled, codes, scales
