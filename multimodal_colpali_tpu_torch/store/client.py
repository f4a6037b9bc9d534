"""Collection-level client (counterpart of ``multimodal_colpali_tpu/store/client.py``).

Shaped like the subset of ``qdrant_client.QdrantClient`` the reference uses
(create/upsert/query_points/scroll/delete/count), running in-process on
``device``. Only multivector (ColPali) collections are ported; dense
collections raise ``NotImplementedError`` until ``store/dense`` is.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import torch

from multimodal_colpali_tpu_torch.store import types as t
from multimodal_colpali_tpu_torch.store.multivector import MultiVectorStore

_DENSE_NOT_PORTED = ("dense collections are not ported to PyTorch yet "
                     "(see ROADMAP.md: models/bert + store/dense)")


class VectorClient:
    """In-process vector-database client with optional disk persistence.

    Args:
      path: directory for persistence (collections are saved there by
        ``save()`` and loaded when the client is created). ``None`` keeps
        everything in memory.
      device: where collections keep their corpus and run MaxSim.
    """

    def __init__(self, path: Optional[str] = None, device: Any = "cpu"):
        self.path = path
        self.device = torch.device(device)
        self._collections: Dict[str, MultiVectorStore] = {}
        if path:
            os.makedirs(path, exist_ok=True)
            self._load_all()

    # -- collection lifecycle ------------------------------------------------

    def _coll_dir(self, name: str) -> str:
        if self.path is None:
            raise ValueError("client was created without a persistence path")
        return os.path.join(self.path, name)

    def _load_all(self) -> None:
        for name in sorted(os.listdir(self.path)):
            meta_path = os.path.join(self.path, name, "meta.json")
            if not os.path.exists(meta_path):
                continue
            with open(meta_path) as f:
                kind = json.load(f).get("kind", "dense")
            if kind != "multivector":
                raise NotImplementedError(f"collection {name!r}: {_DENSE_NOT_PORTED}")
            self._collections[name] = MultiVectorStore.load(self._coll_dir(name),
                                                            device=self.device)

    def collection_exists(self, collection_name: str) -> bool:
        return collection_name in self._collections

    def create_collection(self, collection_name: str, vectors_config: t.VectorParams,
                          quantized: bool = False, prefilter: str = "int8",
                          max_tokens: int = 1056, **_: Any) -> bool:
        if vectors_config.multivector_config is None:
            raise NotImplementedError(_DENSE_NOT_PORTED)
        self._collections[collection_name] = MultiVectorStore(
            name=collection_name, dim=vectors_config.size, max_tokens=max_tokens,
            distance=vectors_config.distance, device=self.device,
            quantized=quantized, prefilter=prefilter,
            on_disk=bool(getattr(vectors_config, "on_disk", False)),
        )
        return True

    def delete_collection(self, collection_name: str) -> bool:
        self._collections.pop(collection_name, None)
        if self.path:
            shutil.rmtree(self._coll_dir(collection_name), ignore_errors=True)
        return True

    def get_collections(self) -> t.CollectionsResponse:
        return t.CollectionsResponse(
            collections=[t.CollectionDescription(name=n) for n in self._collections])

    def _get(self, name: str) -> MultiVectorStore:
        if name not in self._collections:
            raise KeyError(f"collection {name!r} does not exist")
        return self._collections[name]

    # -- data plane ------------------------------------------------------------

    def upsert(self, collection_name: str, points: Sequence[t.PointStruct],
               **_: Any) -> t.UpdateResult:
        return self._get(collection_name).upsert(points)

    def query_points(self, collection_name: str, query: Any, limit: int = 5,
                     query_filter: Optional[t.Filter] = None,
                     search_params: Optional[t.SearchParams] = None,
                     with_vectors: bool = False, **_: Any) -> t.QueryResponse:
        return self._get(collection_name).query(
            query, limit=limit, query_filter=query_filter,
            search_params=search_params, with_vectors=with_vectors)

    def scroll(self, collection_name: str, scroll_filter: Optional[t.Filter] = None,
               limit: int = 100, offset: int = 0, with_vectors: bool = False,
               **_: Any) -> Tuple[List[t.Record], Optional[int]]:
        return self._get(collection_name).scroll(
            flt=scroll_filter, limit=limit, offset=offset, with_vectors=with_vectors)

    def delete(self, collection_name: str,
               points_selector: Union[Sequence[Union[int, str]], t.Filter,
                                      t.FilterSelector, t.PointIdsList, None] = None,
               **_: Any) -> t.UpdateResult:
        store = self._get(collection_name)
        if isinstance(points_selector, t.FilterSelector):
            return store.delete(flt=points_selector.filter)
        if isinstance(points_selector, t.Filter):
            return store.delete(flt=points_selector)
        if isinstance(points_selector, t.PointIdsList):
            return store.delete(ids=points_selector.points)
        return store.delete(ids=points_selector)

    def count(self, collection_name: str, count_filter: Optional[t.Filter] = None,
              **_: Any) -> t.CountResult:
        return t.CountResult(count=self._get(collection_name).count(count_filter))

    # -- persistence -----------------------------------------------------------

    def save(self) -> None:
        for name, store in self._collections.items():
            store.save(self._coll_dir(name))
