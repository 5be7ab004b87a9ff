"""In-memory fake DB — cluster-free distributed-ingestion harness.

Behavioural port of the reference's `db_basic.rs` test double
(tests/integration/db_basic.rs:102-389), promoted to a first-class
source: the same mock that tests the pipeline also serves as a
local/demo backend.

Semantics preserved from the reference:
  * every DDL/DML mutator bumps the schema version
    (db_basic.rs:135-202 — add_table/add_index/del_index/insert_values);
  * upserts are write-time last-writer-wins (db_basic.rs:223-235);
  * the initial scan streams a snapshot of stored rows
    (db_basic.rs:370-389).

Extension beyond the reference's mock: after the snapshot, open streams
receive *live* CDC-style events (upserts and deletes), covering the
scylla-cdc consumer role (db_index.rs:389-459) so streaming-ingest tests
(BASELINE config 3) run without a cluster.
"""

from __future__ import annotations

import asyncio
import itertools
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from ..types import (
    DbEmbedding,
    IndexId,
    IndexMetadata,
    IndexParams,
    PrimaryKey,
    Timestamp,
)
from .source import EmbeddingStream


@dataclass
class _Row:
    embedding: Optional[np.ndarray]  # None = tombstone
    timestamp: Timestamp


@dataclass
class _Table:
    primary_key_columns: tuple[str, ...]
    dimensions: int
    rows: dict[PrimaryKey, _Row] = field(default_factory=dict)


@dataclass
class _Index:
    table: str
    metadata: IndexMetadata


class MemDb:
    """The DbMock role (db_basic.rs:102-125) with live CDC fan-out."""

    # concurrent scan slices (the reference's shards×3, db_index.rs:253-258)
    SCAN_PARALLELISM = 6

    def __init__(self) -> None:
        self._version = itertools.count(1)
        self._schema_version = next(self._version)
        self._tables: dict[str, _Table] = {}
        self._indexes: dict[IndexId, _Index] = {}
        # open per-(index) live streams for CDC fan-out
        self._streams: list[tuple[str, EmbeddingStream]] = []
        self._ts = itertools.count(1)  # monotonic fallback write-times

    # ------------------------------------------------------------------
    # mutators (each bumps the schema version where the reference does)

    def _bump(self) -> None:
        self._schema_version = next(self._version)

    def next_timestamp(self) -> Timestamp:
        return Timestamp(next(self._ts))

    def add_table(
        self, name: str, primary_key_columns: tuple[str, ...], dimensions: int
    ) -> None:
        self._tables[name] = _Table(primary_key_columns, dimensions)
        self._bump()

    def add_index(
        self,
        name: str,
        table: str,
        params: Optional[IndexParams] = None,
        kind: str = "ann",
    ) -> IndexMetadata:
        tbl = self._tables[table]
        params = params or IndexParams(dimensions=tbl.dimensions)
        index_id = IndexId(name)
        meta = IndexMetadata(
            index_id=index_id,
            params=params,
            version=f"v{self._schema_version}",
            key_columns=tbl.primary_key_columns,
            kind=kind,
        )
        self._indexes[index_id] = _Index(table, meta)
        self._bump()
        return meta

    def del_index(self, name: str) -> None:
        self._indexes.pop(IndexId(name), None)
        self._bump()

    async def insert_values(
        self,
        table: str,
        key: PrimaryKey,
        embedding: Optional[np.ndarray],
        timestamp: Optional[Timestamp] = None,
    ) -> None:
        """LWW upsert (embedding None = delete), db_basic.rs:223-235."""
        tbl = self._tables[table]
        ts = timestamp or self.next_timestamp()
        row = tbl.rows.get(key)
        if row is None or row.timestamp <= ts:
            tbl.rows[key] = _Row(
                None if embedding is None else np.asarray(embedding, np.float32),
                ts,
            )
        self._bump()
        # live CDC fan-out to open streams of this table
        ev = DbEmbedding(primary_key=key, embedding=tbl.rows[key].embedding, timestamp=tbl.rows[key].timestamp)
        for stream_table, stream in list(self._streams):
            if stream_table == table and not stream.stopped:
                await stream.put(ev)

    async def delete_values(self, table: str, key: PrimaryKey) -> None:
        await self.insert_values(table, key, None)

    def preload(self, table: str, keys, embeddings: np.ndarray) -> None:
        """Bulk bench/test setup: load rows directly with one schema bump
        and no per-row CDC fan-out (open streams observe the data through
        the initial scan instead — the realistic shape of pre-existing
        data in the reference, db_basic.rs:223-235)."""
        tbl = self._tables[table]
        for key, emb in zip(keys, embeddings):
            tbl.rows[key] = _Row(
                np.asarray(emb, np.float32), self.next_timestamp()
            )
        self._bump()

    # ------------------------------------------------------------------
    # DbSource protocol

    async def latest_schema_version(self) -> Optional[str]:
        return f"s{self._schema_version}"

    async def get_indexes(self) -> list[IndexMetadata]:
        return [ix.metadata for ix in self._indexes.values()]

    async def get_db_index(self, metadata: IndexMetadata) -> EmbeddingStream:
        ix = self._indexes.get(metadata.id)
        if ix is None:
            raise KeyError(f"unknown index {metadata.id}")
        tbl = self._tables[ix.table]
        stream = EmbeddingStream(tbl.primary_key_columns)
        self._streams.append((ix.table, stream))

        # Parallel initial scan: the snapshot is hash-partitioned into
        # range slices and scanned by SCAN_PARALLELISM concurrent tasks
        # feeding the one bounded stream — the token-range scan shape of
        # the reference (db_index.rs:217-258, shards×3).  Live events may
        # interleave; monitor_items' LWW filter resolves races exactly as
        # it does for the real scan+CDC pair.
        snapshot = list(tbl.rows.items())
        r = self.SCAN_PARALLELISM

        async def scan_slice(part: int) -> None:
            for key, row in snapshot[part::r]:
                if stream.stopped:
                    break
                await stream.put(
                    DbEmbedding(
                        primary_key=key,
                        embedding=row.embedding,
                        timestamp=row.timestamp,
                    )
                )

        async def initial_scan() -> None:
            await asyncio.gather(*(scan_slice(p) for p in range(r)))

        asyncio.get_running_loop().create_task(initial_scan())
        return stream

    async def close_streams(self) -> None:
        for _, stream in self._streams:
            stream.stop()
            await stream.close()
        self._streams.clear()
