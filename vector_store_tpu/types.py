"""Domain types for the vector/text store.

Mirrors the reference's newtype surface (reference: src/lib.rs:29-265) with
Python-idiomatic types.  These are the values that cross every actor seam:
index identifiers, document keys, embeddings, search limits and the
HNSW-style hyper-parameters (connectivity / expansion_add / expansion_search,
reference: src/lib.rs:164-200).
"""

from __future__ import annotations

import time as _time
from dataclasses import dataclass, field
from typing import Any, Optional, Sequence

import numpy as np

# ---------------------------------------------------------------------------
# Identifiers


@dataclass(frozen=True)
class IndexId:
    """Absolute index name, `keyspace.index` (reference: src/lib.rs:47).

    The live system treats it as an opaque string; the vestigial ANN system
    composes it from (keyspace_name, index_name) — we support both.
    """

    value: str

    def __post_init__(self) -> None:
        if not self.value:
            raise ValueError("IndexId must be non-empty")

    @classmethod
    def from_parts(cls, keyspace: str, index: str) -> "IndexId":
        return cls(f"{keyspace}.{index}")

    @property
    def keyspace_name(self) -> str:
        return self.value.split(".", 1)[0] if "." in self.value else ""

    @property
    def index_name(self) -> str:
        return self.value.split(".", 1)[1] if "." in self.value else self.value

    def __str__(self) -> str:  # pragma: no cover - trivial
        return self.value


# Document key.  The live system uses a plain string (src/lib.rs:63); the
# vestigial ANN system uses a multi-column primary key (a tuple of values,
# tests/integration/usearch.rs:334-337).  A PrimaryKey is a tuple of
# JSON-serialisable scalars; a plain string Key is the 1-tuple special case.
PrimaryKey = tuple


def primary_key(*parts: Any) -> PrimaryKey:
    """Build a primary key from its column values."""
    return tuple(parts)


# ---------------------------------------------------------------------------
# Index hyper-parameters (usearch vocabulary, reference: src/lib.rs:147-211)

DEFAULT_CONNECTIVITY = 32  # graph degree R (usearch `connectivity`)
DEFAULT_EXPANSION_ADD = 128  # beam pool during insert (usearch `expansion_add`)
DEFAULT_EXPANSION_SEARCH = 64  # beam pool during search (usearch `expansion_search`)


@dataclass(frozen=True)
class IndexParams:
    """Per-index build/search knobs.

    The reference carries (dimensions, connectivity, expansion_add,
    expansion_search) through `IndexFactory::create_index`
    (src/index/usearch.rs:38-45); `space` extends it with the distance
    metric (usearch used its default, cosine: src/index/usearch.rs:89-96).
    """

    dimensions: int
    connectivity: int = DEFAULT_CONNECTIVITY
    expansion_add: int = DEFAULT_EXPANSION_ADD
    expansion_search: int = DEFAULT_EXPANSION_SEARCH
    space: str = "cosine"  # "cosine" | "l2" | "dot"
    dtype: str = "float32"  # storage dtype: "float32" | "bfloat16" | "int8"
    capacity: int = 1 << 20  # initial reservation, reference: usearch.rs:60-66

    def __post_init__(self) -> None:
        if self.dimensions <= 0:
            raise ValueError("dimensions must be positive")
        if self.space not in ("cosine", "l2", "dot"):
            raise ValueError(f"unknown space {self.space!r}")
        if self.dtype not in ("float32", "bfloat16", "int8"):
            raise ValueError(f"unknown dtype {self.dtype!r}")


# ---------------------------------------------------------------------------
# Data-plane values


Embedding = np.ndarray  # 1-D float vector (reference: src/lib.rs:224)
Distance = float  # reference: src/lib.rs:131


@dataclass(frozen=True)
class Limit:
    """Search result limit, default 1 (reference: src/lib.rs:235-256)."""

    value: int = 1

    def __post_init__(self) -> None:
        if self.value < 1:
            raise ValueError("Limit must be >= 1")


@dataclass(frozen=True)
class Timestamp:
    """Microsecond write timestamp used for last-writer-wins dedup
    (reference: src/lib.rs:262, src/monitor_items.rs:56-71)."""

    micros: int

    @classmethod
    def now(cls) -> "Timestamp":
        return cls(int(_time.time() * 1_000_000))

    def __lt__(self, other: "Timestamp") -> bool:
        return self.micros < other.micros

    def __le__(self, other: "Timestamp") -> bool:
        return self.micros <= other.micros


@dataclass(frozen=True)
class DbEmbedding:
    """One ingestion event: upsert (embedding set) or delete (embedding None),
    with its write timestamp (reference: src/db_index.rs:46-50,400-416)."""

    primary_key: PrimaryKey
    embedding: Optional[np.ndarray]
    timestamp: Timestamp


@dataclass(frozen=True)
class IndexMetadata:
    """Everything the engine needs to materialise an index
    (reference: src/monitor_indexes.rs:90-146).

    `kind` selects the backend behind the factory seam — the reference
    swapped backends at compile time (opensearch live vs usearch
    vestigial); here both coexist behind one registry.
    """

    index_id: IndexId
    params: Optional[IndexParams] = None
    version: str = ""
    key_columns: Sequence[str] = field(default_factory=tuple)
    kind: str = "ann"  # "ann" | "ivf" | "exact" | "text" | "auto" (by capacity)

    @property
    def id(self) -> IndexId:
        return self.index_id


# ---------------------------------------------------------------------------
# Search results


@dataclass(frozen=True)
class AnnResult:
    """ANN response: parallel lists of primary keys and distances
    (reference: tests/integration/httpclient.rs:46-66)."""

    primary_keys: list
    distances: list
