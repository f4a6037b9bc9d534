"""Top-k with a stable tie order, on one device or over a page-sharded corpus
(counterpart of ``multimodal_colpali_tpu/ops/topk.py``).

``torch.topk`` promises no order among equal values, so the ranking is a
stable sort on ``-scores``: descending score, then ascending index, the
order of the JAX package's ``topk_with_stable_ties`` (topk.py:30-49).

Sharded (topk.py:52-129): each rank of the corpus axis scores its shard,
keeps a local top-k with global ids (its first row's offset added), and the
``k`` candidates of every rank are all-gathered and merged into the global
top-k on every rank. The traffic is O(k) a rank, whatever the corpus size,
and ties still go to the lower global index, so a sharded result equals the
single-device one. A rescore over the merged candidates runs on each rank
and is joined by an all-reduce (``rescore_owned``).

Equal pages tie only if each page's score does not depend on where it sits
in the batch: on the CPU the stores' matrix-vector scores go through
``row_dots`` for that.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from multimodal_colpali_tpu_torch.ops.maxsim import maxsim_scores
from multimodal_colpali_tpu_torch.parallel.mesh import Mesh, all_gather, all_reduce

PAD_ID = 2**31 - 1      # the id of a padding candidate (a shard with fewer than k pages)
ROW_DOTS_SLICE = 1 << 16  # leading rows a slice in ``row_dots``


def row_dots(rows: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``rows [..., D]`` dotted with ``v [D]`` in float32 -> ``[...]``: the
    products of a row multiplied and summed along the row, ``ROW_DOTS_SLICE``
    leading rows at a time (no corpus-sized temporary).

    On the CPU a matrix-vector product takes the rows past its last full
    block through another kernel, so a row's rounding depends on its place,
    and a shard of the corpus would rank two equal pages unlike the whole
    corpus. PyTorch's CPU sum reduces each row of a contiguous last axis on
    its own, the same way for every row of one length, so here a row's
    result depends on its values only (pinned by the equal pages of
    ``tests/test_torch_parallel.py``). The stores use it on the CPU; on the
    card they keep their matrix products."""
    vf = v.float()
    return torch.cat([(rows[s: s + ROW_DOTS_SLICE].float() * vf).sum(dim=-1)
                      for s in range(0, rows.shape[0], ROW_DOTS_SLICE)])


def topk_with_stable_ties(scores: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last axis; ties broken toward the lower index.

    Returns (values ``[..., k]`` float32, indices ``[..., k]`` int32),
    ordered by descending value then ascending index.
    """
    s = scores.float()
    order = torch.argsort(-s, dim=-1, stable=True)[..., :k]
    return torch.gather(s, -1, order), order.to(torch.int32)


def _merge_candidates(vals: torch.Tensor, inds: torch.Tensor, k: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The gathered candidates' global top-k (topk.py:52-65): a stable sort by
    id, then a stable sort by ``-value``, so equal values keep id order."""
    by_id = torch.argsort(inds, dim=-1, stable=True)
    v, i = torch.gather(vals, -1, by_id), torch.gather(inds, -1, by_id)
    by_val = torch.argsort(-v, dim=-1, stable=True)
    v, i = torch.gather(v, -1, by_val), torch.gather(i, -1, by_val)
    return v[..., :k], i[..., :k]


def sharded_topk(mesh: Mesh, axis: str, scores: torch.Tensor, k: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The global top-k of scores sharded on their last axis: ``scores
    [..., p_local]`` are this rank's, whose first global index is ``rank *
    p_local``. Returns (values ``[..., k]``, global indices ``[..., k]``),
    the same on every rank of ``axis``."""
    p_local = scores.shape[-1]
    kk = min(k, p_local)
    lv, li = topk_with_stable_ties(scores, kk)
    li = li + mesh.index(axis) * p_local           # global page ids
    if kk < k:  # pad so every rank gathers k
        pad = lv.shape[:-1] + (k - kk,)
        lv = torch.cat([lv, lv.new_full(pad, float("-inf"))], dim=-1)
        li = torch.cat([li, li.new_full(pad, PAD_ID)], dim=-1)
    n = mesh.size(axis)
    gv = all_gather(mesh, axis, lv)                 # [S, ..., k]
    gi = all_gather(mesh, axis, li)
    gv = torch.movedim(gv, 0, -2).reshape(lv.shape[:-1] + (n * k,))
    gi = torch.movedim(gi, 0, -2).reshape(li.shape[:-1] + (n * k,))
    return _merge_candidates(gv, gi, k)


def sharded_maxsim_topk(mesh: Mesh, axis: str, q: torch.Tensor, d_local: torch.Tensor,
                        d_lens_local: torch.Tensor, k: int, *,
                        q_lens: Optional[torch.Tensor] = None,
                        score_fn: Optional[Callable] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """MaxSim and top-k over a corpus sharded on the page axis (topk.py:68-129).

    ``q [B, NQ, DIM]`` is replicated; ``d_local [p_local, NT, DIM]`` and
    ``d_lens_local [p_local]`` are this rank's pages (every rank holds the
    same count; pad with zero-length pages). ``score_fn(q, d, q_lens,
    d_lens) -> [B, p_local]`` defaults to ``ops/maxsim.maxsim_scores`` (K1
    on a CUDA tensor). Returns (values ``[B, k]``, global page ids ``[B,
    k]``), the same on every rank."""
    score_fn = score_fn or maxsim_scores
    return sharded_topk(mesh, axis, score_fn(q, d_local, q_lens, d_lens_local), k)


def rescore_owned(mesh: Mesh, axis: str, cand: torch.Tensor, lo: int, p_local: int,
                  score_fn: Callable[[torch.Tensor], torch.Tensor]) -> torch.Tensor:
    """Exact scores ``[..., C]`` of the global candidate ids ``cand [C]``,
    the same on every rank of ``axis``. The rank that holds global rows
    ``[lo, lo + p_local)`` scores the candidates it owns, ``score_fn(local
    ids [C]) -> [..., C]``, puts ``-inf`` in the others' places, and an
    all-reduce (max) joins the ranks. The others' ids are clamped into the
    shard rather than left out, so each candidate keeps its place in the
    batch and rounds as a single-device rescore of ``cand`` rounds it; C
    pages are few beside the shard's scan."""
    owned = (cand >= lo) & (cand < lo + p_local)
    exact = score_fn(torch.clamp(cand - lo, 0, p_local - 1))
    exact = torch.where(owned, exact, torch.full_like(exact, float("-inf")))
    return all_reduce(mesh, axis, exact, op="max")
