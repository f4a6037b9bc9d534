"""A read-only corpus view over every rank's page rows (counterpart of
``multimodal_colpali_tpu/store/distributed.py``).

``MultiVectorStore`` keeps a host copy of the whole corpus on every rank.
Past one host's memory, each rank contributes only its own rows: the view
puts them on the rank's device (``parallel.make_global_corpus``), derives
the int8 codes and the pooled (or farthest-point) centroids there, and a
query runs the sharded kernels. Global page ids are the rank's offset plus
the local row; payloads stay with the rank that owns the rows, which
resolves the hits it owns (:meth:`DistributedCorpusView.owns`).
"""

from __future__ import annotations

import math
from typing import Any, Optional, Tuple

import numpy as np
import torch

from multimodal_colpali_tpu_torch.ops.maxsim import quantize_corpus_int8
from multimodal_colpali_tpu_torch.ops.topk import sharded_maxsim_topk
from multimodal_colpali_tpu_torch.ops.two_stage import (
    pool_corpus, pool_corpus_fps, sharded_two_stage_maxsim_topk)
from multimodal_colpali_tpu_torch.parallel.mesh import (
    Mesh, global_corpus_mesh, make_global_corpus)


class DistributedCorpusView:
    """Read-only MaxSim retrieval over rank-local page shards.

    Every rank of the mesh builds the view together, with the same row
    count (pad with zero-length pages) and the same options; a rank holds
    one device, so its rows are its shard (JAX pads a process's rows to its
    devices' count, distributed.py:69-78). ``prefilter="pooled"`` answers by
    the sharded two-stage search (``pooled_centroids`` vectors a page),
    anything else by the exact sharded scan."""

    _SCORE_FLOOR = -1e28  # below = masked or padding page

    def __init__(self, local_vectors: Any, local_lens: Any, mesh: Optional[Mesh] = None,
                 axis: str = "corpus", prefilter: str = "pooled", pooled_centroids: int = 1,
                 dtype: torch.dtype = torch.bfloat16, normalize: bool = True):
        if mesh is None:
            mesh = global_corpus_mesh(axis)
        self.mesh, self.axis, self.prefilter = mesh, axis, prefilter
        vecs = np.asarray(local_vectors, np.float32)
        lens = np.asarray(local_lens, np.int32)
        if normalize:   # unit tokens, the padding tokens zeroed (distributed.py:63-67)
            vecs = vecs / np.maximum(np.linalg.norm(vecs, axis=-1, keepdims=True), 1e-12)
            vecs = vecs * (np.arange(vecs.shape[1])[None, :, None] < lens[:, None, None])
        shard = make_global_corpus(torch.from_numpy(vecs).to(dtype), mesh, axis)
        self.local_rows = shard.local.shape[0]
        self.shard_offset = shard.offset
        self.real_rows = shard.total
        self.d = shard.local
        self.d_lens = make_global_corpus(lens, mesh, axis).local
        # the stage-1 and quantized forms come from the rank's own shard
        self.d_int8, self.d_scale = quantize_corpus_int8(self.d)
        self.pooled = (pool_corpus_fps(self.d, self.d_lens, k=pooled_centroids)
                       if pooled_centroids > 1 else pool_corpus(self.d, self.d_lens))

    def __len__(self) -> int:
        """The number of pages over every rank."""
        return self.real_rows

    def owns(self, global_id: int) -> bool:
        return self.shard_offset <= global_id < self.shard_offset + self.local_rows

    def query(self, query: Any, limit: int = 5, oversampling: float = 2.0
              ) -> Tuple[np.ndarray, np.ndarray]:
        """One query's token vectors -> (scores ``[<=k]``, global page ids),
        the same on every rank; masked and padding pages are dropped
        (distributed.py:107-137)."""
        q = np.asarray(query, np.float32)
        q = q / np.maximum(np.linalg.norm(q, axis=-1, keepdims=True), 1e-12)
        k = min(limit, self.real_rows)
        qt = torch.from_numpy(q).to(self.d.device)
        if self.prefilter == "pooled":
            n_cand = min(max(math.ceil(limit * max(oversampling, 1.0)), limit), self.real_rows)
            vals, ids = sharded_two_stage_maxsim_topk(
                self.mesh, self.axis, qt, q.shape[0], self.pooled, self.d_int8, self.d_scale,
                self.d_lens, k=k, n_candidates=n_cand, d_full=self.d)
        else:
            vals, ids = sharded_maxsim_topk(self.mesh, self.axis, qt[None].to(self.d.dtype),
                                            self.d, self.d_lens, k)
            vals, ids = vals[0], ids[0]
        vals, ids = vals.cpu().numpy(), ids.cpu().numpy()
        keep = vals > self._SCORE_FLOOR
        return vals[keep], ids[keep]
