"""In-process vector store: Qdrant-shaped types, the multivector store, the client."""

from multimodal_colpali_tpu_torch.store.client import VectorClient  # noqa: F401
from multimodal_colpali_tpu_torch.store.multivector import MultiVectorStore  # noqa: F401
from multimodal_colpali_tpu_torch.store.types import (  # noqa: F401
    CountResult, Distance, FieldCondition, Filter, FilterSelector, MatchAny, MatchValue,
    MultiVectorComparator, MultiVectorConfig, PointIdsList, PointStruct,
    QuantizationSearchParams, QueryResponse, Record, ScoredPoint, SearchParams,
    UpdateResult, VectorParams)
