"""Index actor protocol — the message seam between engine and backends.

Mirrors the reference's channel-based actor model: every index backend is
a task draining a bounded mailbox of typed messages, and callers talk to
it through a typed async façade over the mailbox (the `IndexExt`
extension-trait role, reference: src/index/actor.rs:29-59).

Two protocols share the seam, exactly as in the reference:
  * the live text protocol  — Add / Remove / Search (src/index/actor.rs:13-27)
  * the ANN protocol        — AddOrReplace / Remove / Ann / Count
                              (src/index/usearch.rs:148-171)
A backend implements the subset it supports; unsupported messages resolve
their reply future with an error.

Lifecycle matches the reference: the engine holds the only `IndexHandle`;
closing it terminates the actor task (engine.rs:113-116 — dropping the
sender ends the mailbox loop).
"""

from __future__ import annotations

import asyncio
from dataclasses import dataclass, field
from typing import Any, Optional, Sequence

import numpy as np

from ..types import Limit, PrimaryKey

# Mailbox capacity, "taken from initial benchmarks" in the reference
# (src/index/usearch.rs:101-103).
MAILBOX_CAPACITY = 10

_CLOSE = object()  # sentinel: handle dropped → actor terminates


# --- message types ----------------------------------------------------------


@dataclass
class Add:
    """Live text protocol: acked document insert (actor.rs:36-46)."""

    key: PrimaryKey
    text: str
    reply: asyncio.Future


@dataclass
class Remove:
    """Fire-and-forget removal (actor.rs:48-52, usearch.rs:235-249)."""

    key: PrimaryKey


@dataclass
class Search:
    """Live text protocol: full-text search → list of keys (actor.rs:54-58)."""

    text: str
    limit: Limit
    reply: asyncio.Future


@dataclass
class AddOrReplace:
    """ANN protocol: LWW upsert of an embedding (usearch.rs:148-159)."""

    primary_key: PrimaryKey
    embedding: np.ndarray
    reply: Optional[asyncio.Future] = None


@dataclass
class AddOrReplaceBatch:
    """ANN protocol extension: one message carrying many upserts.

    The reference inserts one vector per message (its usearch add is
    per-row CPU work); here an insert is a fixed-shape device step, so
    the ingestion path coalesces (ingest/monitor_items.py) and ships
    whole batches — one jitted step instead of hundreds."""

    items: list  # [(PrimaryKey, np.ndarray)]
    reply: Optional[asyncio.Future] = None


@dataclass
class RemoveBatch:
    """ANN protocol extension: one message carrying many removals —
    the delete twin of AddOrReplaceBatch (the ingest bridge ships
    coalesced LWW batches; a churny CDC stream would otherwise cost one
    mailbox turn per tombstone)."""

    keys: list  # [PrimaryKey]


@dataclass
class Ann:
    """ANN protocol: nearest-neighbour query (usearch.rs:160-166)."""

    embedding: np.ndarray
    limit: Limit
    reply: asyncio.Future = field(default=None)  # type: ignore[assignment]


@dataclass
class Count:
    """ANN protocol: live item count (usearch.rs:167-170)."""

    reply: asyncio.Future


@dataclass
class Compact:
    """Maintenance: reclaim tombstoned rows (extension — the reference's
    only fragmentation answer was a rebuild from the source DB)."""

    reply: asyncio.Future


Message = Any


class IndexHandle:
    """Typed async façade over an index actor's mailbox (the `IndexExt`
    role, actor.rs:29-59).  One handle per index, owned by the engine."""

    def __init__(self, queue: asyncio.Queue, task: asyncio.Task) -> None:
        self._queue = queue
        self._task = task
        self._closed = False
        # optional IndexMetadata, attached by the factory (API layer uses
        # key_columns for the column-major ann response shape)
        self.metadata = None

    # -- lifecycle --------------------------------------------------------

    def close(self) -> None:
        """Drop the sender: actor drains its mailbox and terminates."""
        if not self._closed:
            self._closed = True
            try:
                self._queue.put_nowait(_CLOSE)
            except asyncio.QueueFull:
                # mailbox full: the loop is still draining it — deliver
                # the sentinel as soon as a slot frees (a bare raise here
                # would leak the actor forever)
                asyncio.get_running_loop().create_task(
                    self._queue.put(_CLOSE)
                )

    async def join(self) -> None:
        await self._task

    @property
    def closed(self) -> bool:
        return self._closed

    async def _send(self, msg: Message) -> None:
        if self._closed:
            raise RuntimeError("index handle closed")
        await self._queue.put(msg)

    # -- live text protocol ----------------------------------------------

    async def add(self, key: PrimaryKey, text: str) -> None:
        """Acked insert — resolves when the backend applied it."""
        fut = asyncio.get_running_loop().create_future()
        await self._send(Add(key, text, fut))
        await fut

    async def remove(self, key: PrimaryKey) -> None:
        await self._send(Remove(key))

    async def search(self, text: str, limit: Limit) -> Sequence[PrimaryKey]:
        fut = asyncio.get_running_loop().create_future()
        await self._send(Search(text, limit, fut))
        return await fut

    # -- ANN protocol -----------------------------------------------------

    async def add_or_replace(
        self, primary_key: PrimaryKey, embedding: np.ndarray
    ) -> None:
        await self._send(AddOrReplace(primary_key, embedding))

    async def add_or_replace_batch(self, items: list) -> None:
        """Coalesced upserts: [(key, embedding)] applied as one device step."""
        await self._send(AddOrReplaceBatch(list(items)))

    async def remove_batch(self, keys: list) -> None:
        """Coalesced removals: one device tombstone step."""
        await self._send(RemoveBatch(list(keys)))

    async def ann(
        self, embedding: np.ndarray, limit: Limit
    ) -> tuple[list, list]:
        fut = asyncio.get_running_loop().create_future()
        await self._send(Ann(embedding, limit, fut))
        return await fut

    async def count(self) -> int:
        fut = asyncio.get_running_loop().create_future()
        await self._send(Count(fut))
        return await fut

    async def compact(self) -> int:
        """Rebuild away tombstones; returns the live count."""
        fut = asyncio.get_running_loop().create_future()
        await self._send(Compact(fut))
        return await fut


def spawn_index_actor(process, name: str = "index") -> IndexHandle:
    """Spawn the mailbox loop: `while msg := recv(): process(msg)`.

    `process` is an async callable handling one message; exceptions are
    routed to the message's reply future when present, logged otherwise
    (the reference logs and drops: opensearch.rs:166-172).

    If `process` exposes a `coalesce(msgs) -> msgs` hook, each loop turn
    drains everything already queued and lets the backend merge runs of
    consecutive messages before processing — a mutation is a
    fixed-shape device step, so ten queued single-row upserts should cost
    one step, not ten (the rayon-offload role, usearch.rs:115-118, played
    by batching instead of threads).  Order across message types is
    preserved: only *consecutive* same-type runs may merge.
    """
    import logging

    log = logging.getLogger(f"vst.{name}")
    queue: asyncio.Queue = asyncio.Queue(MAILBOX_CAPACITY)

    async def loop() -> None:
        closing = False
        coalesce = getattr(process, "coalesce", None)
        while not closing:
            msg = await queue.get()
            if msg is _CLOSE:
                break
            batch = [msg]
            if coalesce is not None:
                while True:
                    try:
                        nxt = queue.get_nowait()
                    except asyncio.QueueEmpty:
                        break
                    if nxt is _CLOSE:
                        closing = True
                        break
                    batch.append(nxt)
                batch = coalesce(batch)
            for m in batch:
                try:
                    await process(m)
                except Exception as exc:  # noqa: BLE001 — actor must not die
                    replies = getattr(m, "replies", None) or [
                        getattr(m, "reply", None)
                    ]
                    routed = False
                    for reply in replies:
                        if reply is not None and not reply.done():
                            reply.set_exception(exc)
                            routed = True
                    if not routed:
                        log.exception(
                            "actor %s: error processing %s", name, m
                        )
        # Fail anything that slipped in behind the sentinel: a _send that
        # passed the closed-check and was awaiting a mailbox slot when
        # close() landed enqueues AFTER _CLOSE — without this drain its
        # reply future would hang forever.  A couple of event-loop turns
        # let every such pending put() complete (each get_nowait below
        # wakes one blocked putter); new sends fail on the closed flag.
        for _ in range(3):
            while True:
                try:
                    m = queue.get_nowait()
                except asyncio.QueueEmpty:
                    break
                if m is _CLOSE:
                    continue
                replies = getattr(m, "replies", None) or [
                    getattr(m, "reply", None)
                ]
                for reply in replies:
                    if reply is not None and not reply.done():
                        reply.set_exception(
                            RuntimeError("index handle closed")
                        )
            await asyncio.sleep(0)
        shutdown = getattr(process, "shutdown", None)
        if shutdown is not None:
            await shutdown()

    task = asyncio.get_running_loop().create_task(loop(), name=f"index-{name}")
    return IndexHandle(queue, task)
