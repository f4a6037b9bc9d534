"""Overlapped host->device embedding pipeline (counterpart of
``multimodal_colpali_tpu/ingest/pipeline.py``).

SURVEY.md §7 hard part: keeping chips fed during corpus embedding. The
reference's DataLoader(batch=2..4) loop (functions.py:784-796) serializes
rasterize -> preprocess -> forward; here the host stages run in background
threads with a bounded queue (double buffering), so PDF rasterization (C++
mmpdf) and image preprocessing overlap the device forward of the previous
batch.

    loader = PipelinedEmbedder(retriever)
    entries = loader.embed_pdf_dir(pdf_dir)   # create_document_embeddings schema

On a CUDA retriever each page raster is uploaded in stage 1 and resized
there (LANCZOS by ``resize_image``, then BICUBIC to the model size in stage
2, both ``imageops`` on the device, pixels equal to the host's), so the
host threads only rasterize and launch; stage 3 is the retriever's own
forward, ``Retriever._embed``. A dynamic-resolution processor (ColQwen2's
smart grids, ColSmol's image splitting, ColGranite's anyres tiles) is fed
one sub-batch per layout through its ``group_by_grid``; one without it
raises.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Dict, Iterator, List, Sequence, Tuple

import torch


class _PrefetchIterator:
    """Run ``producer`` in a thread, yield its items through a bounded queue."""

    _SENTINEL = object()

    def __init__(self, producer: Iterator, depth: int = 2):
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._err: List[BaseException] = []

        def run():
            try:
                for item in producer:
                    self._q.put(item)
            except BaseException as e:  # noqa: BLE001 - re-raised in consumer
                self._err.append(e)
            finally:
                self._q.put(self._SENTINEL)

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._SENTINEL:
            if self._err:
                raise self._err[0]
            raise StopIteration
        return item


class PipelinedEmbedder:
    """Corpus embedding with prefetched host stages.

    Stage 1 (thread): rasterize pages from PDFs (native mmpdf).
    Stage 2 (thread): processor preprocessing into model input batches.
    Stage 3 (main):   device forward + unpad, overlapping stage 1/2.
    """

    def __init__(self, retriever: Any, batch_size: int = 32, dpi: float = 144.0,
                 prefetch_depth: int = 2, raster_dpi: Any = None):
        self.retriever = retriever
        self.batch_size = batch_size
        self.dpi = dpi
        self.prefetch_depth = prefetch_depth
        # raster_dpi="auto": render each page so its long side lands at the
        # model's input size instead of rasterizing at 144 DPI and
        # downsampling (~6x less raster+resize host work per page; the
        # rasterizer's geometric scaling replaces the bitmap downsample).
        # Page pixels then differ from the reference's 144-DPI chain, so
        # this is an opt-in for embedding-only ingest.
        self.raster_dpi = raster_dpi

    # -- stage 1: pages -------------------------------------------------------

    def _iter_pages(self, pdf_dir: str) -> Iterator[Tuple[int, int, str, Any]]:
        import os

        from multimodal_colpali_tpu_torch.ingest.preprocess import resize_image
        from multimodal_colpali_tpu_torch.ingest.rasterize import PdfDocument

        device = torch.device(self.retriever.device)

        def placed(raster):
            return raster if device.type == "cpu" else torch.from_numpy(raster).to(device)

        target = None
        if self.raster_dpi == "auto":
            pre = getattr(self.retriever.processor, "image_preprocessor", None)
            target = getattr(pre, "image_size", None)
        names = sorted(f for f in os.listdir(pdf_dir) if f.lower().endswith(".pdf"))
        for doc_idx, name in enumerate(names):
            doc = PdfDocument(os.path.join(pdf_dir, name))
            for page_id in range(len(doc)):
                if target:
                    w_pt, h_pt = doc.page_size(page_id)
                    dpi = max(target * 72.0 / max(w_pt, h_pt, 1.0), 18.0)
                    yield doc_idx, page_id, name, placed(doc.render(page_id, dpi=dpi))
                else:
                    yield doc_idx, page_id, name, resize_image(
                        placed(doc.render(page_id, dpi=self.dpi)))

    # -- stage 2: batches ------------------------------------------------------

    def _iter_batches(self, pages: Iterator) -> Iterator[Tuple[List[Tuple], Dict]]:
        proc = self.retriever.processor
        dynamic = getattr(proc, "dynamic_resolution", False)
        dev_pre = getattr(self.retriever, "device_preprocess", False)
        device = self.retriever.device
        if dynamic and not hasattr(proc, "group_by_grid"):
            raise NotImplementedError(
                f"{type(proc).__name__} has a dynamic layout but no group_by_grid, so its "
                f"pages cannot be grouped into batches of one layout")

        def emit(buf):
            if dynamic:
                # one sub-batch per layout (pipeline.py:104-121)
                for grid, idxs in proc.group_by_grid([r[3] for r in buf]):
                    sub = [buf[i] for i in idxs]
                    yield sub, proc.process_images([r[3] for r in sub], grid=grid,
                                                   device=device)
            elif dev_pre:
                # resize-only stage; normalize runs on the device in the
                # forward (ops/preprocess.py, K3 on a CUDA device)
                yield buf, proc.process_images([r[3] for r in buf], device_preprocess=True,
                                               device=device)
            else:
                yield buf, proc.process_images([r[3] for r in buf], device=device)

        buf: List[Tuple] = []
        for rec in pages:
            buf.append(rec)
            if len(buf) == self.batch_size:
                yield from emit(buf)
                buf = []
        if buf:
            yield from emit(buf)

    # -- stage 3: device -------------------------------------------------------

    def embed_pdf_dir(self, pdf_dir: str) -> List[Dict[str, Any]]:
        """-> entries {embedding, doc_id, page_id, file_name} (the
        create_document_embeddings schema, reference functions.py:765-809)."""
        pages = _PrefetchIterator(self._iter_pages(pdf_dir), depth=self.prefetch_depth * self.batch_size)
        batches = _PrefetchIterator(self._iter_batches(pages), depth=self.prefetch_depth)

        out: List[Dict[str, Any]] = []
        for records, batch in batches:
            embs = self.retriever._embed(batch, with_image=True)
            for i, (doc_idx, page_id, name, _img) in enumerate(records):
                out.append({
                    "embedding": embs[i],
                    "doc_id": doc_idx,
                    "page_id": page_id,
                    "file_name": name,
                })
        return out
