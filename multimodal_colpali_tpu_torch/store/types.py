"""Vector-store value types (a copy of ``multimodal_colpali_tpu/store/types.py``).

Shape-compatible with the subset of ``qdrant_client.http.models`` the
reference uses (PointStruct/VectorParams/Distance/MultiVectorConfig at
01_create_context_qdrant.py:208-222 and functions.py:827-929). The classes
are plain Python; they are copied only because importing the JAX package's
module would import JAX.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Dict, List, Optional, Sequence, Union


class Distance(str, enum.Enum):
    COSINE = "Cosine"
    DOT = "Dot"
    EUCLID = "Euclid"


class MultiVectorComparator(str, enum.Enum):
    MAX_SIM = "max_sim"


@dataclasses.dataclass
class MultiVectorConfig:
    comparator: MultiVectorComparator = MultiVectorComparator.MAX_SIM


@dataclasses.dataclass
class VectorParams:
    size: int
    distance: Distance = Distance.COSINE
    on_disk: bool = False
    multivector_config: Optional[MultiVectorConfig] = None


@dataclasses.dataclass
class PointStruct:
    id: Union[int, str]
    vector: Any  # [dim] dense or [n_tokens, dim] multivector
    payload: Dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class MatchValue:
    value: Any


@dataclasses.dataclass
class MatchAny:
    any: Sequence[Any]


@dataclasses.dataclass
class FieldCondition:
    key: str
    match: Union[MatchValue, MatchAny]


def _cond_matches(cond: FieldCondition, payload: Dict[str, Any]) -> bool:
    val = _lookup(payload, cond.key)
    if isinstance(cond.match, MatchAny):
        return val in list(cond.match.any)
    return val == cond.match.value


@dataclasses.dataclass
class Filter:
    must: Sequence[FieldCondition] = ()
    must_not: Sequence[FieldCondition] = ()

    def matches(self, payload: Dict[str, Any]) -> bool:
        for cond in self.must:
            if not _cond_matches(cond, payload):
                return False
        for cond in self.must_not:
            if _cond_matches(cond, payload):
                return False
        return True


@dataclasses.dataclass
class FilterSelector:
    filter: "Filter"


@dataclasses.dataclass
class PointIdsList:
    points: Sequence[Union[int, str]]


def _lookup(payload: Dict[str, Any], dotted_key: str) -> Any:
    cur: Any = payload
    for part in dotted_key.split("."):
        if not isinstance(cur, dict) or part not in cur:
            return None
        cur = cur[part]
    return cur


@dataclasses.dataclass
class QuantizationSearchParams:
    """Mirrors Qdrant semantics used at reference functions.py:897-903.

    ignore: skip the quantized first stage entirely (exact search).
    rescore: re-score candidates with full-precision vectors.
    oversampling: first-stage candidate multiplier before rescoring.
    """

    ignore: bool = False
    rescore: bool = True
    oversampling: float = 2.0


@dataclasses.dataclass
class SearchParams:
    quantization: Optional[QuantizationSearchParams] = None


@dataclasses.dataclass
class ScoredPoint:
    id: Union[int, str]
    score: float
    payload: Dict[str, Any] = dataclasses.field(default_factory=dict)
    vector: Optional[Any] = None


@dataclasses.dataclass
class QueryResponse:
    points: List[ScoredPoint]


@dataclasses.dataclass
class Record:
    id: Union[int, str]
    payload: Dict[str, Any] = dataclasses.field(default_factory=dict)
    vector: Optional[Any] = None


@dataclasses.dataclass
class CollectionDescription:
    name: str


@dataclasses.dataclass
class CollectionsResponse:
    collections: List[CollectionDescription]


@dataclasses.dataclass
class CountResult:
    count: int


@dataclasses.dataclass
class UpdateResult:
    operation_id: int = 0
    status: str = "completed"
