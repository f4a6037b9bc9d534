"""Dense single-vector store with exact cosine / dot search
(counterpart of ``multimodal_colpali_tpu/store/dense.py``).

The replacement for the reference's dense Qdrant collections (768-d COSINE,
``qdrant_process`` at functions.py:1310-1333) of the text-RAG and
multimodal-RAG modes. Search is exact: one product of the corpus with the
query, then a top-k whose ties go to the lower index, as in the JAX store
(HNSW is not reimplemented on either side).

- **Host of record, device cache.** Upserts and deletes change a float32
  numpy array and payload dicts on the host; the first query after a change
  uploads the corpus to ``device`` in ``dtype`` (bf16), its rows padded to a
  multiple of 8 with zeros (dense.py:122-140).
- **Scores in float32.** The bf16 query times the bf16 corpus, summed and
  returned in float32 (``einsum(..., preferred_element_type=float32)`` at
  dense.py:166-169): a bf16 result would round the scores and reorder
  near-ties.
- **Filters are a mask.** Rows a payload filter rejects, and the padding
  rows, get -2e28 added; results under -1e28 are dropped. The filter is
  JAX's Python loop over every payload (dense.py:154-158).
- **Same files.** ``save`` / ``load`` write and read the JAX store's
  ``vectors.npz`` (compressed) and ``meta.json`` (``kind: "dense"``), so a
  store saved by either package loads in the other.

- **Sharded over a mesh** (``mesh=``, ``mesh_axis="corpus"``, dense.py:40-48,
  :123-131): each rank uploads only its rows, the row count padded to
  ``lcm(axis size, 8)``; a query is the rank's float32 product and top-k,
  merged over the axis by ``ops/topk.sharded_topk`` into global ids, the same
  on every rank.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from multimodal_colpali_tpu_torch._device import resolve_device
from multimodal_colpali_tpu_torch.ops.quant import bf16_matmul_f32
from multimodal_colpali_tpu_torch.ops.topk import row_dots, sharded_topk, topk_with_stable_ties
from multimodal_colpali_tpu_torch.parallel.mesh import rank_rows, shard_range
from multimodal_colpali_tpu_torch.store import types as t

_FILTERED = -1e28


def scores_f32(corpus: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """``corpus [N, D] @ q [D]`` in float32: for a bf16 corpus, bf16 products
    summed and returned in float32 (``ops/quant.bf16_matmul_f32`` on the card).
    On the CPU each row is reduced on its own (``ops/topk.row_dots``), so a
    row shard ranks exact ties as the whole corpus does."""
    if corpus.device.type == "cpu":
        return row_dots(corpus, q.to(corpus.dtype) if corpus.dtype == torch.bfloat16 else q)
    if corpus.dtype == torch.bfloat16:
        return bf16_matmul_f32(q[None], corpus)[0]
    return corpus.float() @ q.float()


class DenseVectorStore:
    """A named collection of single dense vectors with exact top-k search."""

    def __init__(
        self,
        name: str,
        dim: int = 768,
        distance: t.Distance = t.Distance.COSINE,
        dtype: torch.dtype = torch.bfloat16,
        device: Any = "cuda",
        mesh: Any = None,
        mesh_axis: str = "corpus",
    ):
        self.name = name
        self.dim = dim
        self.distance = distance
        self.dtype = dtype
        self.device = resolve_device(device)
        self.mesh = mesh
        self.mesh_axis = mesh_axis
        if mesh is not None:
            mesh.check(torch.empty(0, device=self.device))

        self._vectors = np.zeros((0, dim), dtype=np.float32)
        self._ids: List[Union[int, str]] = []
        self._payloads: List[Dict[str, Any]] = []
        self._id_to_idx: Dict[Union[int, str], int] = {}
        self._device_cache: Optional[torch.Tensor] = None
        self._pad_mask: Optional[torch.Tensor] = None
        self._dirty = True

    def __len__(self) -> int:
        return len(self._ids)

    def upsert(self, points: Sequence[t.PointStruct]) -> t.UpdateResult:
        """Unit-normalize under COSINE (float32, numpy); an id already stored
        is overwritten in place, new ids are appended in order."""
        new_vecs, new_pts = [], []
        for pt in points:
            vec = np.asarray(pt.vector, dtype=np.float32).reshape(-1)
            if vec.shape[0] != self.dim:
                raise ValueError(f"expected dim {self.dim}, got {vec.shape[0]}")
            if self.distance == t.Distance.COSINE:
                vec = vec / max(np.linalg.norm(vec), 1e-12)
            if pt.id in self._id_to_idx:
                idx = self._id_to_idx[pt.id]
                self._vectors[idx] = vec
                self._payloads[idx] = dict(pt.payload)
            else:
                new_vecs.append(vec)
                new_pts.append(pt)
        if new_vecs:
            base = len(self._ids)
            self._vectors = np.concatenate([self._vectors, np.stack(new_vecs)], axis=0)
            for off, pt in enumerate(new_pts):
                self._ids.append(pt.id)
                self._payloads.append(dict(pt.payload))
                self._id_to_idx[pt.id] = base + off
        self._dirty = True
        return t.UpdateResult()

    def delete(self, ids: Optional[Sequence[Union[int, str]]] = None,
               flt: Optional[t.Filter] = None) -> t.UpdateResult:
        drop = set()
        if ids is not None:
            drop.update(self._id_to_idx[i] for i in ids if i in self._id_to_idx)
        if flt is not None:
            drop.update(i for i, p in enumerate(self._payloads) if flt.matches(p))
        if not drop:
            return t.UpdateResult()
        keep = [i for i in range(len(self._ids)) if i not in drop]
        self._vectors = self._vectors[keep]
        self._ids = [self._ids[i] for i in keep]
        self._payloads = [self._payloads[i] for i in keep]
        self._id_to_idx = {pid: i for i, pid in enumerate(self._ids)}
        self._dirty = True
        return t.UpdateResult()

    def scroll(self, flt: Optional[t.Filter] = None, limit: int = 100, offset: int = 0,
               with_vectors: bool = False) -> Tuple[List[t.Record], Optional[int]]:
        matching = [i for i, p in enumerate(self._payloads) if flt is None or flt.matches(p)]
        records = [
            t.Record(id=self._ids[i], payload=dict(self._payloads[i]),
                     vector=self._vectors[i].tolist() if with_vectors else None)
            for i in matching[offset: offset + limit]
        ]
        next_off = offset + limit if offset + limit < len(matching) else None
        return records, next_off

    def count(self, flt: Optional[t.Filter] = None) -> int:
        if flt is None:
            return len(self._ids)
        return sum(1 for p in self._payloads if flt.matches(p))

    def _ensure_device(self) -> torch.Tensor:
        """The corpus on ``device`` in ``dtype``, rows padded to a multiple of
        8, and the unfiltered mask (-2e28 on the padding rows); rebuilt after
        a change."""
        if self._device_cache is not None and not self._dirty:
            return self._device_cache
        n = self._vectors.shape[0]     # on a mesh only this rank's rows reach its device
        self._lo, hi, self._total = shard_range(self.mesh, self.mesh_axis, n)
        d = rank_rows(self._vectors, self._lo, hi, self.device).to(self.dtype)
        mask = torch.zeros(hi - self._lo, dtype=torch.float32)
        mask[max(n - self._lo, 0):] = _FILTERED * 2
        self._device_cache = d
        self._pad_mask = mask.to(self.device)
        self._dirty = False
        return d

    def query(self, query: Any, limit: int = 5, query_filter: Optional[t.Filter] = None,
              with_vectors: bool = False) -> t.QueryResponse:
        q = np.asarray(query, dtype=np.float32).reshape(-1)
        if self.distance == t.Distance.COSINE:
            q = q / max(np.linalg.norm(q), 1e-12)
        if len(self._ids) == 0:
            return t.QueryResponse(points=[])
        d = self._ensure_device()
        lo = self._lo
        if query_filter is not None:
            m = np.full(max(lo + d.shape[0], len(self._payloads)), _FILTERED * 2, np.float32)
            for i, p in enumerate(self._payloads):
                if query_filter.matches(p):
                    m[i] = 0.0
            mask = torch.from_numpy(m[lo: lo + d.shape[0]]).to(self.device)
        else:
            mask = self._pad_mask   # padded rows must never win
        qd = torch.from_numpy(q).to(self.device).to(self.dtype)
        scores = scores_f32(d, qd) + mask
        if self.mesh is not None:
            vv, vi = sharded_topk(self.mesh, self.mesh_axis, scores[None, :],
                                  min(limit, self._total))
        else:
            vv, vi = topk_with_stable_ties(scores[None, :], min(limit, self._total))
        points = []
        for score, idx in zip(vv[0].cpu().tolist(), vi[0].cpu().tolist()):
            if idx >= len(self._ids) or score < _FILTERED:
                continue
            points.append(t.ScoredPoint(
                id=self._ids[idx], score=float(score), payload=dict(self._payloads[idx]),
                vector=self._vectors[idx].tolist() if with_vectors else None))
        return t.QueryResponse(points=points[:limit])

    def save(self, directory: str) -> None:
        os.makedirs(directory, exist_ok=True)
        np.savez_compressed(os.path.join(directory, "vectors.npz"), vectors=self._vectors)
        meta = {
            "name": self.name, "dim": self.dim, "distance": self.distance.value,
            "kind": "dense", "ids": self._ids, "payloads": self._payloads,
        }
        with open(os.path.join(directory, "meta.json"), "w") as f:
            json.dump(meta, f)

    @classmethod
    def load(cls, directory: str, device: Any = "cuda", mesh: Any = None,
             mesh_axis: str = "corpus") -> "DenseVectorStore":
        with open(os.path.join(directory, "meta.json")) as f:
            meta = json.load(f)
        store = cls(name=meta["name"], dim=meta["dim"],
                    distance=t.Distance(meta["distance"]), device=device, mesh=mesh,
                    mesh_axis=mesh_axis)
        with np.load(os.path.join(directory, "vectors.npz")) as data:
            store._vectors = data["vectors"]
        store._ids = meta["ids"]
        store._payloads = meta["payloads"]
        store._id_to_idx = {pid: i for i, pid in enumerate(store._ids)}
        return store
