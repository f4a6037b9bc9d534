"""Device-resident multi-vector page store
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
- **Quantized search** (``quantized=True``), after Qdrant's scalar
  quantization search params (``ignore/rescore/oversampling``, reference
  functions.py:897-903): ``prefilter="int8"`` scans int8 codes with K4 for
  ``ceil(limit * oversampling)`` candidates and rescores them exactly with
  K1; ``prefilter="pooled"`` scans pooled page vectors
  (``pooled_centroids`` per page) and rescores the candidates from the
  originals in float32 (``ops/two_stage``).
- **on_disk** (reference 01_create_context_qdrant.py:217): the device holds
  only the pooled index and the token counts; a query gathers its
  candidates' originals from host memory (a memory map after ``load``).
- **Same files.** ``save``/``load`` use the JAX store's formats
  (``vectors.npz``, or ``vectors.npy`` + ``lens.npy`` for on_disk, and
  ``meta.json``), so a store saved by either package loads in the other in
  the same mode.

- **Sharded over a mesh** (``mesh=``, ``mesh_axis="corpus"``,
  multivector.py:111-146, :258-340): every rank holds the same host copy
  (each runs the same upserts) and uploads only its pages, the page axis
  padded to ``lcm(axis size, 8)``; a query returns global page ids, the same
  on every rank. The exact scan is ``ops/topk.sharded_maxsim_topk``, the
  pooled prefilter ``ops/two_stage.sharded_two_stage_maxsim_topk``. JAX's
  int8 prefilter has no sharded function (GSPMD gathers the global scores);
  here it is shard-local: K4 on each shard, the candidates merged by
  ``ops/topk.sharded_topk``, each rescored with K1 by the rank that owns it
  and joined by an all-reduce (max), so its ids equal the single-device
  store's. ``on_disk`` keeps the originals on the host and refuses a mesh
  (``ValueError``, as in JAX).
"""

from __future__ import annotations

import concurrent.futures as cf
import json
import math
import os
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from multimodal_colpali_tpu_torch.ops import two_stage
from multimodal_colpali_tpu_torch.ops.maxsim import (
    maxsim_scores, maxsim_scores_int8, quantize_corpus_int8)
from multimodal_colpali_tpu_torch.ops.topk import (
    rescore_owned, sharded_maxsim_topk, sharded_topk, topk_with_stable_ties)
from multimodal_colpali_tpu_torch.parallel.mesh import rank_rows, shard_range
from multimodal_colpali_tpu_torch.store import types as t

_FILTERED_SCORE_FLOOR = -1e28  # anything below this is a masked or padded page
_PAGE_MULTIPLE = 8
_ON_DISK_CHUNK = 8192       # pages per upload when pooling a host corpus
_EXACT_SCAN_CHUNK = 2048    # pages per upload in the on_disk exact scan

_GATHER_WORKERS = 16
_gather_pool: Optional[cf.ThreadPoolExecutor] = None
_gather_pool_lock = threading.Lock()


def _pool() -> cf.ThreadPoolExecutor:
    global _gather_pool
    with _gather_pool_lock:
        if _gather_pool is None:
            _gather_pool = cf.ThreadPoolExecutor(_GATHER_WORKERS,
                                                 thread_name_prefix="mmcp-gather")
        return _gather_pool


def _gather_rows(arr: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """``arr[idx]``, reading the rows of a memory-mapped corpus concurrently
    (a copy of multivector.py:55-94).

    Fancy indexing on a memmap reads the rows one after another, each a
    blocking disk round trip with the GIL held; ``os.pread`` per row on a
    thread pool releases the GIL during each read, so the reads overlap. The
    rows come back in the corpus dtype. The offset
    of each row is ``arr.offset + row * row_bytes``, which holds only for a
    whole-file map, so a view into a memmap takes plain indexing."""
    idx = np.asarray(idx)
    if (not isinstance(arr, np.memmap) or arr.filename is None or len(idx) < 8
            or isinstance(arr.base, np.memmap)):  # a view: its offset is the parent's
        return arr[idx]
    row_bytes = int(np.prod(arr.shape[1:], dtype=np.int64)) * arr.dtype.itemsize
    raw = np.empty((len(idx), *arr.shape[1:]), arr.dtype)
    fd = os.open(arr.filename, os.O_RDONLY)
    try:
        def read(j: int) -> None:
            buf = os.pread(fd, row_bytes, int(arr.offset) + int(idx[j]) * row_bytes)
            raw[j] = np.frombuffer(buf, arr.dtype).reshape(arr.shape[1:])

        for f in [_pool().submit(read, j) for j in range(len(idx))]:
            f.result()
    finally:
        os.close(fd)
    return raw


def _pad_pages(x: torch.Tensor) -> torch.Tensor:
    """Pad the page axis to a multiple of 8 with zeros."""
    pad = (-x.shape[0]) % _PAGE_MULTIPLE
    if pad == 0:
        return x
    return torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])


class MultiVectorStore:
    """One named collection of multi-vector points with MaxSim search."""

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
        pooled_centroids: int = 1,
        on_disk: bool = False,
        mesh: Any = None,
        mesh_axis: str = "corpus",
    ):
        """``prefilter`` picks the quantized first stage ("int8" or
        "pooled"); ``on_disk`` implies ``quantized`` and ``prefilter="pooled"``,
        as in the JAX store (multivector.py:138-139). ``mesh`` shards the
        page axis over ``mesh_axis`` (``parallel.get_mesh``); ``device`` must
        be the mesh's."""
        if on_disk and mesh is not None:
            raise ValueError("on_disk and mesh corpus sharding are mutually exclusive (shard "
                             "the host tier instead)")
        if prefilter not in ("int8", "pooled"):
            raise ValueError(f"prefilter must be 'int8' or 'pooled', got {prefilter!r}")
        self.name = name
        self.dim = dim
        self.max_tokens = max_tokens
        self.distance = distance
        self.dtype = dtype
        self.device = torch.device(device)
        self.quantized = quantized or on_disk
        self.prefilter = "pooled" if on_disk else prefilter
        self.pooled_centroids = pooled_centroids
        self.on_disk = on_disk
        self.mesh = mesh
        self.mesh_axis = mesh_axis
        if mesh is not None:
            mesh.check(torch.empty(0, device=self.device))

        self._vectors = np.zeros((0, max_tokens, dim), dtype=np.float32)
        self._lens = np.zeros((0,), dtype=np.int32)
        self._ids: List[Union[int, str]] = []
        self._payloads: List[Dict[str, Any]] = []
        self._id_to_idx: Dict[Union[int, str], int] = {}
        self._invalidate()

    def _invalidate(self) -> None:
        self._device_cache: Optional[Tuple[Optional[torch.Tensor], torch.Tensor]] = None
        self._device_cache_int8: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
        self._device_cache_pooled: Optional[torch.Tensor] = None

    # -- mutation ----------------------------------------------------------

    def __len__(self) -> int:
        return len(self._ids)

    def _materialize(self) -> None:
        """A corpus loaded as a memory map is copied into writable host
        memory before it changes; ``save`` writes the disk tier again."""
        if isinstance(self._vectors, np.memmap) or not self._vectors.flags.writeable:
            self._vectors = np.array(self._vectors)

    def upsert(self, points: Sequence[t.PointStruct]) -> t.UpdateResult:
        self._materialize()
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
        self._invalidate()
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
        self._materialize()
        self._vectors = self._vectors[keep]
        self._lens = self._lens[keep]
        self._ids = [self._ids[i] for i in keep]
        self._payloads = [self._payloads[i] for i in keep]
        self._id_to_idx = {pid: i for i, pid in enumerate(self._ids)}
        self._invalidate()
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

    def _pool_pages(self, d: torch.Tensor, dl: torch.Tensor) -> torch.Tensor:
        if self.pooled_centroids > 1:
            return two_stage.pool_corpus_fps(d, dl, k=self.pooled_centroids)
        return two_stage.pool_corpus(d, dl)

    def _ensure_device(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """The padded corpus and token counts on ``device`` and, for a
        quantized store, its int8 codes and pooled index, all derived from
        the uploaded corpus (multivector.py:296-327)."""
        if self._device_cache is None:   # on a mesh only this rank's pages reach its device
            self._lo, hi, self._total = shard_range(self.mesh, self.mesh_axis, len(self._lens),
                                                    _PAGE_MULTIPLE)
            d = rank_rows(self._vectors, self._lo, hi, self.device, self.dtype)
            dl = rank_rows(self._lens, self._lo, hi, self.device)
            self._device_cache = (d, dl)
            if self.quantized:
                self._device_cache_int8 = quantize_corpus_int8(d)
                if self.prefilter == "pooled":
                    self._device_cache_pooled = self._pool_pages(d, dl)
        return self._device_cache

    def _ensure_device_on_disk(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """on_disk tier: the device holds only the pooled index and the
        token counts (multivector.py:262-294). The host corpus (possibly a
        memory map larger than RAM) streams through the device in chunks."""
        if self._device_cache is None:
            parts = []
            for s in range(0, self._vectors.shape[0], _ON_DISK_CHUNK):
                d = torch.from_numpy(np.array(self._vectors[s: s + _ON_DISK_CHUNK],
                                              np.float32)).to(self.device, self.dtype)
                dl = torch.from_numpy(np.asarray(self._lens[s: s + _ON_DISK_CHUNK])).to(self.device)
                parts.append(self._pool_pages(d, dl))
            pooled = (torch.cat(parts) if parts else
                      torch.zeros((0, self.dim), dtype=self.dtype, device=self.device))
            self._device_cache_pooled = _pad_pages(pooled)
            self._device_cache = (None, _pad_pages(torch.from_numpy(self._lens).to(self.device)))
        return self._device_cache_pooled, self._device_cache[1]

    def _filter_lens(self, dl: torch.Tensor, flt: Optional[t.Filter]) -> torch.Tensor:
        """Token counts with the pages ``flt`` rejects zeroed (this rank's
        pages on a mesh)."""
        if flt is None:
            return dl
        lo = self._lo if self.mesh is not None else 0    # on_disk keeps no _lo
        keep = np.zeros(max(lo + dl.shape[0], len(self._payloads)), dtype=np.int32)
        for i, payload in enumerate(self._payloads):
            keep[i] = flt.matches(payload)
        return dl * torch.from_numpy(keep[lo: lo + dl.shape[0]]).to(dl.device)

    # -- search ------------------------------------------------------------

    def query(self, query: Any, limit: int = 5, query_filter: Optional[t.Filter] = None,
              search_params: Optional[t.SearchParams] = None,
              with_vectors: bool = False) -> t.QueryResponse:
        """MaxSim search for one query (``[n_q_tokens, dim]``).

        An unquantized store always scans exactly. A quantized one runs its
        prefilter unless ``search_params.quantization.ignore`` is set; only
        the int8 prefilter reads ``rescore`` (multivector.py:368-419)."""
        q = np.asarray(query, dtype=np.float32)
        if q.ndim != 2 or q.shape[1] != self.dim:
            raise ValueError(f"query must be [n_tokens, {self.dim}], got {q.shape}")
        if self.distance == t.Distance.COSINE:
            q = q / np.maximum(np.linalg.norm(q, axis=-1, keepdims=True), 1e-12)
        if not self._ids:
            return t.QueryResponse(points=[])
        quant = search_params.quantization if search_params else None
        oversampling = quant.oversampling if quant else 2.0
        if self.on_disk:
            if quant is not None and quant.ignore:
                return self._query_on_disk_exact(q, limit, query_filter, with_vectors)
            return self._query_on_disk(q, limit, query_filter, oversampling, with_vectors)

        d, dl = self._ensure_device()
        dl_eff = self._filter_lens(dl, query_filter)
        qt = torch.from_numpy(q[None]).to(self.device, self.dtype)
        if self.mesh is not None:
            vals, inds = self._query_sharded(q, qt, d, dl_eff, limit, quant, oversampling)
            return self._response(vals.tolist(), inds.tolist(), limit, with_vectors)
        n_pages = d.shape[0]
        if self.quantized and not (quant and quant.ignore) and self.prefilter == "pooled":
            n_cand = min(max(math.ceil(limit * max(oversampling, 1.0)), limit), n_pages)
            dq, ds = self._device_cache_int8
            vals, inds = two_stage.two_stage_maxsim_topk(
                torch.from_numpy(q).to(self.device), q.shape[0], self._device_cache_pooled,
                dq, ds, dl_eff, k=min(limit, n_pages), n_candidates=n_cand, d_full=d)
        elif self.quantized and not (quant and quant.ignore):
            n_cand = min(math.ceil(limit * max(oversampling, 1.0)), n_pages)
            dq, ds = self._device_cache_int8
            approx = maxsim_scores_int8(torch.from_numpy(q[None]).to(self.device), dq, ds,
                                        None, dl_eff)
            cv, ci = topk_with_stable_ties(approx, n_cand)
            cand = ci[0].long()
            if quant is None or quant.rescore:
                exact = maxsim_scores(qt, d[cand], None, dl_eff[cand])
                vv, vi = topk_with_stable_ties(exact, min(limit, n_cand))
                vals, inds = vv[0], cand[vi[0].long()]
            else:
                vals, inds = cv[0][:limit], cand[:limit]
        else:
            scores = maxsim_scores(qt, d, None, dl_eff)
            vv, vi = topk_with_stable_ties(scores, min(limit, n_pages))
            vals, inds = vv[0], vi[0]
        return self._response(vals.tolist(), inds.tolist(), limit, with_vectors)

    def _query_sharded(self, q: np.ndarray, qt: torch.Tensor, d: torch.Tensor,
                       dl_eff: torch.Tensor, limit: int, quant: Any, oversampling: float):
        """The modes of :meth:`query` over this rank's pages -> (scores, global
        page ids), the same on every rank (multivector.py:368-425)."""
        mesh, axis, total = self.mesh, self.mesh_axis, self._total
        k = min(limit, total)
        if self.quantized and not (quant and quant.ignore) and self.prefilter == "pooled":
            n_cand = min(max(math.ceil(limit * max(oversampling, 1.0)), limit), total)
            dq, ds = self._device_cache_int8
            return two_stage.sharded_two_stage_maxsim_topk(
                mesh, axis, torch.from_numpy(q).to(self.device), q.shape[0],
                self._device_cache_pooled, dq, ds, dl_eff, k=k, n_candidates=n_cand, d_full=d)
        if self.quantized and not (quant and quant.ignore):
            n_cand = min(math.ceil(limit * max(oversampling, 1.0)), total)
            dq, ds = self._device_cache_int8
            approx = maxsim_scores_int8(torch.from_numpy(q[None]).to(self.device), dq, ds,
                                        None, dl_eff)
            cv, ci = sharded_topk(mesh, axis, approx, n_cand)   # K4 on each shard, merged
            cand = ci[0].long()
            if quant is not None and not quant.rescore:
                return cv[0][:limit], cand[:limit]
            exact = rescore_owned(mesh, axis, cand, self._lo, d.shape[0], lambda local:
                                  maxsim_scores(qt, d[local], None, dl_eff[local]))  # K1
            vv, vi = topk_with_stable_ties(exact, min(limit, n_cand))
            return vv[0], cand[vi[0].long()]
        vv, vi = sharded_maxsim_topk(mesh, axis, qt, d, dl_eff, k)
        return vv[0], vi[0]

    def _response(self, vals: List[float], inds: List[int], limit: int,
                  with_vectors: bool) -> t.QueryResponse:
        points = []
        for score, idx in zip(vals, inds):
            if idx >= len(self._ids) or score < _FILTERED_SCORE_FLOOR:
                continue  # padded or filtered-out page
            points.append(t.ScoredPoint(
                id=self._ids[idx], score=float(score), payload=dict(self._payloads[idx]),
                vector=self._vectors[idx, : self._lens[idx]].tolist() if with_vectors else None,
            ))
        return t.QueryResponse(points=points[:limit])

    def _query_on_disk(self, q: np.ndarray, limit: int, query_filter: Optional[t.Filter],
                       oversampling: float, with_vectors: bool) -> t.QueryResponse:
        """Device pooled prefilter -> host gather of the candidates'
        originals -> exact device rescore (multivector.py:447-516). The
        rescore is the device-resident pooled path's, so the two agree."""
        pooled, dl = self._ensure_device_on_disk()
        dl_eff = self._filter_lens(dl, query_filter)
        n_cand = min(max(math.ceil(limit * max(oversampling, 1.0)), limit), pooled.shape[0])
        qt = torch.from_numpy(q).to(self.device)
        cand = two_stage.coarse_topk(qt, q.shape[0], pooled, dl_eff,
                                     n_candidates=n_cand).cpu().numpy()
        n_real = len(self._ids)
        safe = np.minimum(cand, max(n_real - 1, 0))
        pages = _gather_rows(self._vectors, safe)  # corpus dtype; cast on the device
        lens = self._lens[safe].astype(np.int32)
        for row, idx in enumerate(cand.tolist()):
            if idx >= n_real or (query_filter is not None
                                 and not query_filter.matches(self._payloads[idx])):
                lens[row] = 0  # a padded or filtered candidate scores MASK_VALUE
        vals, order = two_stage.rescore_candidates(
            qt, q.shape[0], torch.from_numpy(np.asarray(pages)).to(self.device).to(self.dtype),
            torch.from_numpy(lens).to(self.device), k=min(limit, n_cand))
        inds = cand[order.cpu().numpy()]
        return self._response(vals.tolist(), inds.tolist(), limit, with_vectors)

    def _query_on_disk_exact(self, q: np.ndarray, limit: int,
                             query_filter: Optional[t.Filter],
                             with_vectors: bool) -> t.QueryResponse:
        """Exact scan of a host corpus in chunks through MaxSim (K1 on a
        CUDA device), ranked by score then index (multivector.py:518-559)."""
        n_real = len(self._ids)
        qt = torch.from_numpy(q[None]).to(self.device, self.dtype)
        lens = self._lens[:n_real].astype(np.int32)
        if query_filter is not None:
            for i, payload in enumerate(self._payloads):
                if not query_filter.matches(payload):
                    lens[i] = 0
        scores = np.empty(n_real, dtype=np.float32)
        for s in range(0, n_real, _EXACT_SCAN_CHUNK):
            e = min(s + _EXACT_SCAN_CHUNK, n_real)
            pages = torch.from_numpy(np.array(self._vectors[s:e], np.float32))
            got = maxsim_scores(qt, pages.to(self.device, self.dtype), None,
                                torch.from_numpy(lens[s:e]).to(self.device))
            scores[s:e] = got[0].float().cpu().numpy()
        order = np.lexsort((np.arange(n_real), -scores))[:min(limit, n_real)]
        return self._response(scores[order].tolist(), order.tolist(), limit, with_vectors)

    # -- persistence -------------------------------------------------------

    def save(self, directory: str) -> None:
        os.makedirs(directory, exist_ok=True)
        if self.on_disk:
            # Raw .npy, so load() can memory-map the originals. Through a
            # temporary file: self._vectors may be the memory map of the
            # destination, which writing in place would truncate first.
            for fname, arr in (("vectors.npy", self._vectors), ("lens.npy", self._lens)):
                dest = os.path.join(directory, fname)
                tmp = dest + ".tmp"
                with open(tmp, "wb") as f:
                    np.save(f, np.ascontiguousarray(arr))
                os.replace(tmp, dest)
        else:
            np.savez_compressed(os.path.join(directory, "vectors.npz"),
                                vectors=self._vectors, lens=self._lens)
        meta = {
            "name": self.name, "dim": self.dim, "max_tokens": self.max_tokens,
            "distance": self.distance.value, "quantized": self.quantized,
            "prefilter": self.prefilter, "pooled_centroids": self.pooled_centroids,
            "on_disk": self.on_disk, "dtype": str(self.dtype).removeprefix("torch."),
            "kind": "multivector", "ids": self._ids, "payloads": self._payloads,
        }
        with open(os.path.join(directory, "meta.json"), "w") as f:
            json.dump(meta, f)

    @classmethod
    def load(cls, directory: str, device: Any = "cpu", mesh: Any = None,
             mesh_axis: str = "corpus") -> "MultiVectorStore":
        """A saved collection; ``mesh`` shards it, except an on_disk one
        (multivector.py:598-611)."""
        with open(os.path.join(directory, "meta.json")) as f:
            meta = json.load(f)
        store = cls(
            name=meta["name"], dim=meta["dim"], max_tokens=meta["max_tokens"],
            distance=t.Distance(meta["distance"]), quantized=meta.get("quantized", False),
            prefilter=meta.get("prefilter", "int8"),
            pooled_centroids=meta.get("pooled_centroids", 1),
            on_disk=meta.get("on_disk", False),
            dtype=getattr(torch, meta.get("dtype", "bfloat16")), device=device,
            mesh=None if meta.get("on_disk", False) else mesh, mesh_axis=mesh_axis,
        )
        if store.on_disk:
            # a memory map: host RAM holds only the pages a query touches
            store._vectors = np.load(os.path.join(directory, "vectors.npy"), mmap_mode="r")
            store._lens = np.asarray(np.load(os.path.join(directory, "lens.npy")))
        else:
            with np.load(os.path.join(directory, "vectors.npz")) as data:
                store._vectors = data["vectors"]
                store._lens = data["lens"]
        store._ids = meta["ids"]
        store._payloads = meta["payloads"]
        store._id_to_idx = {pid: i for i, pid in enumerate(store._ids)}
        return store
