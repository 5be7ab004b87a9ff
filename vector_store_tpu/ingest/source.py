"""Ingestion source protocol — the DB seam.

Abstracts the reference's ScyllaDB control plane + per-index data plane
(src/db.rs enum Db :46-90; src/db_index.rs enum DbIndex + the
`Receiver<DbEmbedding>` feed :46-69) into two Python protocols:

  * `DbSource` — control plane: schema-version polling and index
    discovery (what monitor_indexes consumes);
  * `EmbeddingStream` — data plane: one per index, yielding `DbEmbedding`
    events — an initial bulk scan followed by CDC-style live updates
    (db_index.rs runs a token-range full scan in parallel with a
    scylla-cdc consumer, :104-130,389-459).

Any store can sit behind this seam: the in-memory fake (memdb.py, the
db_basic.rs role), a JSONL/fvecs file source, or a real CDC consumer.
"""

from __future__ import annotations

import asyncio
from typing import Optional, Protocol, Sequence

from ..types import DbEmbedding, IndexMetadata

# Stream termination sentinel (the reference closes the channel;
# an explicit EOS keeps asyncio.Queue semantics simple).
END_OF_STREAM = object()


class EmbeddingStream:
    """Per-index embedding feed: a bounded queue of DbEmbedding events.

    The producer (scan task + CDC task) pushes; `monitor_items` drains.
    `stop()` mirrors `cdc_reader.stop()` (db_index.rs:121-127).
    """

    # Channel depth.  The reference used 10 ("taken from initial
    # benchmarks", db_index.rs:72-75) — sized for per-row CPU inserts.
    # Here the consumer (monitor_items) coalesces everything queued into
    # ONE batched device step, so a deeper channel directly becomes
    # device batch size; 8192 ≈ one IVF ingest chunk, which amortizes
    # the fixed per-apply cost (assignment readback plus dispatch).
    CAPACITY = 8192

    def __init__(self, primary_key_columns: Sequence[str]) -> None:
        self.queue: asyncio.Queue = asyncio.Queue(self.CAPACITY)
        self._pk_columns = tuple(primary_key_columns)
        self._stopped = asyncio.Event()

    async def primary_key_columns(self) -> tuple[str, ...]:
        """Served even while the initial scan runs (db_index.rs:104-130)."""
        return self._pk_columns

    async def put(self, item: DbEmbedding) -> None:
        await self.queue.put(item)

    async def get(self) -> Optional[DbEmbedding]:
        """Next event, or None once the stream has ended."""
        item = await self.queue.get()
        if item is END_OF_STREAM:
            return None
        return item

    def get_nowait(self) -> Optional[DbEmbedding]:
        """Non-blocking drain: an event, None at end-of-stream, or raises
        asyncio.QueueEmpty — lets the consumer coalesce whatever is
        already queued into one batch."""
        item = self.queue.get_nowait()
        if item is END_OF_STREAM:
            return None
        return item

    async def close(self) -> None:
        await self.queue.put(END_OF_STREAM)

    def stop(self) -> None:
        self._stopped.set()

    @property
    def stopped(self) -> bool:
        return self._stopped.is_set()


class DbSource(Protocol):
    """Control plane (the `Db` actor surface monitor_indexes needs)."""

    async def latest_schema_version(self) -> Optional[str]:
        """Opaque version; changes whenever DDL happened
        (reference reads system.group0_history: db.rs:299-316)."""
        ...

    async def get_indexes(self) -> list[IndexMetadata]:
        """Discover indexes and assemble their metadata — id, version,
        dimensions, params, validity (monitor_indexes.rs:90-146)."""
        ...

    async def get_db_index(self, metadata: IndexMetadata) -> EmbeddingStream:
        """Open the per-index feed: initial scan + live updates
        (db.rs:115-119 → db_index.rs:66-130)."""
        ...
