"""Index factory — the backend-swap seam.

Mirrors `trait IndexFactory` (reference: src/index/factory.rs:10-12); the
vestigial variant also carries the index hyper-parameters
(src/index/usearch.rs:38-45), which here travel in `IndexMetadata`.
"""

from __future__ import annotations

from typing import Optional, Protocol

from ..types import IndexId, IndexMetadata
from .actor import IndexHandle


class IndexFactory(Protocol):
    def create_index(
        self, index_id: IndexId, metadata: Optional[IndexMetadata] = None
    ) -> IndexHandle:
        """Create the backend actor for an index and return its handle."""
        ...


# kind="auto" crossover: below this declared capacity the graph backend's
# sub-linear traversal wins on latency-sensitive small collections; at and
# above it the IVF bucketed scan is expected to win on QPS.  The value
# was set on another accelerator; the GPU crossover is not measured yet
# (ROADMAP S2)
AUTO_IVF_MIN_CAPACITY = 200_000


class RoutingFactory:
    """Dispatch to a backend factory by `IndexMetadata.kind`.

    The reference swapped backends at compile time (the opensearch factory
    in the live build, the usearch one in the vestigial build); serving
    both index types in one process needs a runtime seam instead.

    `kind="auto"` picks the ANN backend from the declared capacity
    (`IndexParams.capacity`): graph below AUTO_IVF_MIN_CAPACITY, IVF at
    or above it.  The default capacity (1M, the reference's reservation,
    usearch.rs:60-66) therefore routes auto-indexes to IVF — the faster
    backend at that scale per the measured crossover.
    """

    def __init__(self, by_kind: dict[str, IndexFactory], default: str = "ann"):
        self._by_kind = by_kind
        self._default = default

    def create_index(
        self, index_id: IndexId, metadata: Optional[IndexMetadata] = None
    ) -> IndexHandle:
        kind = metadata.kind if metadata is not None else self._default
        if kind == "auto":
            cap = getattr(getattr(metadata, "params", None), "capacity", None)
            kind = "ivf" if cap and cap >= AUTO_IVF_MIN_CAPACITY else "ann"
        factory = self._by_kind.get(kind)
        if factory is None:
            raise ValueError(f"no factory for index kind {kind!r}")
        handle = factory.create_index(index_id, metadata)
        handle.metadata = metadata
        handle.resolved_kind = kind
        return handle
