"""Device-resident multi-vector page store, exact search
(counterpart of ``multimodal_colpali_tpu/store/multivector.py``).

The replacement for the reference's Qdrant ColPali collections: 128-d
COSINE multivectors with the MAX_SIM comparator.

- **Host of record, device cache.** Upserts and deletes change packed numpy
  arrays and payload dicts on the host; the first query after a change
  uploads the corpus to ``device`` in ``dtype``, with the page axis padded
  to a multiple of 8 by zero-length pages (multivector.py:296-309).
- **Filters fold into token counts.** A payload filter zeroes the token
  counts of the pages it rejects (multivector.py:331-341); MaxSim scores
  such a page about ``-NQ * 1e30`` and results under
  ``_FILTERED_SCORE_FLOOR`` are dropped.
- **Same files.** ``save``/``load`` use the JAX store's ``vectors.npz`` +
  ``meta.json`` format, so a store saved by either package loads in the other.

Only the exact scan is ported. The int8 prefilter (``quantized``), the
pooled two-stage search, ``on_disk`` and mesh sharding raise
``NotImplementedError``; ROADMAP.md queues them.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from multimodal_colpali_tpu_torch.ops.maxsim import maxsim_scores
from multimodal_colpali_tpu_torch.ops.topk import topk_with_stable_ties
from multimodal_colpali_tpu_torch.store import types as t

_FILTERED_SCORE_FLOOR = -1e28  # anything below this is a masked or padded page
_PAGE_MULTIPLE = 8


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to the PyTorch store yet; only the exact scan "
        f"is (see ROADMAP.md: K4 and the quantized/pooled store modes)")


class MultiVectorStore:
    """One named collection of multi-vector points with exact MaxSim search."""

    def __init__(
        self,
        name: str,
        dim: int = 128,
        max_tokens: int = 1056,
        distance: t.Distance = t.Distance.COSINE,
        dtype: torch.dtype = torch.bfloat16,
        device: Any = "cpu",
        quantized: bool = False,
        prefilter: str = "int8",
        on_disk: bool = False,
        mesh: Any = None,
    ):
        if quantized:
            raise _not_ported("the quantized (int8 prefilter) store")
        if prefilter != "int8":
            raise _not_ported(f"prefilter={prefilter!r}")
        if on_disk:
            raise _not_ported("on_disk")
        if mesh is not None:
            raise _not_ported("mesh sharding")
        self.name = name
        self.dim = dim
        self.max_tokens = max_tokens
        self.distance = distance
        self.dtype = dtype
        self.device = torch.device(device)

        self._vectors = np.zeros((0, max_tokens, dim), dtype=np.float32)
        self._lens = np.zeros((0,), dtype=np.int32)
        self._ids: List[Union[int, str]] = []
        self._payloads: List[Dict[str, Any]] = []
        self._id_to_idx: Dict[Union[int, str], int] = {}
        self._device_cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None

    # -- mutation ----------------------------------------------------------

    def __len__(self) -> int:
        return len(self._ids)

    def upsert(self, points: Sequence[t.PointStruct]) -> t.UpdateResult:
        new_vecs, new_lens, new_rows = [], [], []
        for pt in points:
            vec = np.asarray(pt.vector, dtype=np.float32)
            if vec.ndim != 2 or vec.shape[1] != self.dim:
                raise ValueError(
                    f"multivector point must be [n_tokens, {self.dim}], got {vec.shape}")
            n = min(vec.shape[0], self.max_tokens)
            vec = vec[:n]
            if self.distance == t.Distance.COSINE:
                vec = vec / np.maximum(np.linalg.norm(vec, axis=-1, keepdims=True), 1e-12)
            padded = np.zeros((self.max_tokens, self.dim), dtype=np.float32)
            padded[:n] = vec
            if pt.id in self._id_to_idx:  # overwrite in place
                idx = self._id_to_idx[pt.id]
                self._vectors[idx] = padded
                self._lens[idx] = n
                self._payloads[idx] = dict(pt.payload)
            else:
                new_vecs.append(padded)
                new_lens.append(n)
                new_rows.append(pt)
        if new_vecs:
            base = len(self._ids)
            self._vectors = np.concatenate([self._vectors, np.stack(new_vecs)], axis=0)
            self._lens = np.concatenate([self._lens, np.asarray(new_lens, np.int32)])
            for off, pt in enumerate(new_rows):
                self._ids.append(pt.id)
                self._payloads.append(dict(pt.payload))
                self._id_to_idx[pt.id] = base + off
        self._device_cache = None
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
        self._lens = self._lens[keep]
        self._ids = [self._ids[i] for i in keep]
        self._payloads = [self._payloads[i] for i in keep]
        self._id_to_idx = {pid: i for i, pid in enumerate(self._ids)}
        self._device_cache = None
        return t.UpdateResult()

    def scroll(self, flt: Optional[t.Filter] = None, limit: int = 100, offset: int = 0,
               with_vectors: bool = False) -> Tuple[List[t.Record], Optional[int]]:
        matching = [i for i, p in enumerate(self._payloads) if flt is None or flt.matches(p)]
        records = [
            t.Record(id=self._ids[i], payload=dict(self._payloads[i]),
                     vector=self._vectors[i, : self._lens[i]].tolist() if with_vectors else None)
            for i in matching[offset: offset + limit]
        ]
        next_off = offset + limit if offset + limit < len(matching) else None
        return records, next_off

    def count(self, flt: Optional[t.Filter] = None) -> int:
        if flt is None:
            return len(self._ids)
        return sum(1 for p in self._payloads if flt.matches(p))

    # -- device cache ------------------------------------------------------

    def _ensure_device(self) -> Tuple[torch.Tensor, torch.Tensor]:
        if self._device_cache is None:
            pad = (-len(self._ids)) % _PAGE_MULTIPLE
            vecs = np.concatenate(
                [self._vectors, np.zeros((pad, self.max_tokens, self.dim), np.float32)])
            lens = np.concatenate([self._lens, np.zeros((pad,), np.int32)])
            self._device_cache = (
                torch.from_numpy(vecs).to(self.device, self.dtype),
                torch.from_numpy(lens).to(self.device),
            )
        return self._device_cache

    def _filter_lens(self, dl: torch.Tensor, flt: Optional[t.Filter]) -> torch.Tensor:
        if flt is None:
            return dl
        keep = np.zeros(dl.shape[0], dtype=np.int32)
        for i, payload in enumerate(self._payloads):
            keep[i] = flt.matches(payload)
        return dl * torch.from_numpy(keep).to(dl.device)

    # -- search ------------------------------------------------------------

    def query(self, query: Any, limit: int = 5, query_filter: Optional[t.Filter] = None,
              search_params: Optional[t.SearchParams] = None,
              with_vectors: bool = False) -> t.QueryResponse:
        """Exact MaxSim search for one query (``[n_q_tokens, dim]``).

        ``search_params`` is accepted for the reference's signature; an
        unquantized collection always scans exactly, as in the JAX store."""
        q = np.asarray(query, dtype=np.float32)
        if q.ndim != 2 or q.shape[1] != self.dim:
            raise ValueError(f"query must be [n_tokens, {self.dim}], got {q.shape}")
        if self.distance == t.Distance.COSINE:
            q = q / np.maximum(np.linalg.norm(q, axis=-1, keepdims=True), 1e-12)
        if not self._ids:
            return t.QueryResponse(points=[])

        d, dl = self._ensure_device()
        dl_eff = self._filter_lens(dl, query_filter)
        qt = torch.from_numpy(q[None]).to(self.device, self.dtype)
        scores = maxsim_scores(qt, d, None, dl_eff)
        vals, inds = topk_with_stable_ties(scores, min(limit, d.shape[0]))
        points = []
        for score, idx in zip(vals[0].tolist(), inds[0].tolist()):
            if idx >= len(self._ids) or score < _FILTERED_SCORE_FLOOR:
                continue  # padded or filtered-out page
            points.append(t.ScoredPoint(
                id=self._ids[idx], score=float(score), payload=dict(self._payloads[idx]),
                vector=self._vectors[idx, : self._lens[idx]].tolist() if with_vectors else None,
            ))
        return t.QueryResponse(points=points[:limit])

    # -- persistence -------------------------------------------------------

    def save(self, directory: str) -> None:
        os.makedirs(directory, exist_ok=True)
        np.savez_compressed(os.path.join(directory, "vectors.npz"),
                            vectors=self._vectors, lens=self._lens)
        meta = {
            "name": self.name, "dim": self.dim, "max_tokens": self.max_tokens,
            "distance": self.distance.value, "quantized": False,
            "dtype": str(self.dtype).removeprefix("torch."),
            "kind": "multivector", "ids": self._ids, "payloads": self._payloads,
        }
        with open(os.path.join(directory, "meta.json"), "w") as f:
            json.dump(meta, f)

    @classmethod
    def load(cls, directory: str, device: Any = "cpu") -> "MultiVectorStore":
        with open(os.path.join(directory, "meta.json")) as f:
            meta = json.load(f)
        store = cls(
            name=meta["name"], dim=meta["dim"], max_tokens=meta["max_tokens"],
            distance=t.Distance(meta["distance"]), quantized=meta.get("quantized", False),
            prefilter=meta.get("prefilter", "int8"), on_disk=meta.get("on_disk", False),
            dtype=getattr(torch, meta.get("dtype", "bfloat16")), device=device,
        )
        with np.load(os.path.join(directory, "vectors.npz")) as data:
            store._vectors = data["vectors"]
            store._lens = data["lens"]
        store._ids = meta["ids"]
        store._payloads = meta["payloads"]
        store._id_to_idx = {pid: i for i, pid in enumerate(store._ids)}
        return store
