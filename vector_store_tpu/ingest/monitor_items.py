"""Item monitor — the LWW bridge from an embedding stream to an index actor.

Port of the reference's monitor_items actor (src/monitor_items.rs):
drains `DbEmbedding` events, keeps `{PrimaryKey: Timestamp}` and applies
last-writer-wins — stale timestamps are dropped (:56-71); an event with
an embedding is an add_or_replace, a None embedding a remove (:72-79);
the task terminates when the stream closes (:40-42).

Deviation: the reference forwards one message per event (its inserts
are per-row CPU work).  Here an insert is a fixed-shape device step, so
the bridge **coalesces** — after the first awaited event it drains
everything already queued (up to MAX_APPLY_BATCH), resolves LWW inside
the batch, and ships surviving upserts as ONE AddOrReplaceBatch message.
Per-key final state is identical to the one-by-one ordering: the LWW
filter makes per-key timestamps monotone, so applying only each key's
last event is equivalent.
"""

from __future__ import annotations

import asyncio
import logging

from ..engine.actor import IndexHandle
from ..types import Timestamp
from .source import EmbeddingStream

log = logging.getLogger("vst.monitor_items")

# Upper bound on one coalesced apply.  Each device apply pays fixed
# costs (an assignment readback, dispatch overheads); 8192 rows per apply amortizes them 8x better than the old
# 1024 while staying one ingest chunk for the IVF backend (ivf.py
# `chunk = 8192`).  The reference forwards ONE event per message
# (monitor_items.rs:72-79) because its inserts are per-row CPU work —
# this constant is deliberately not parity.
MAX_APPLY_BATCH = 8192


async def run(stream: EmbeddingStream, index: IndexHandle) -> None:
    """Bridge loop; returns when the stream ends."""
    seen: dict = {}
    while True:
        ev = await stream.get()
        if ev is None:
            log.debug("monitor_items: stream closed, terminating")
            return
        batch = [ev]
        eos = False
        while len(batch) < MAX_APPLY_BATCH:
            try:
                nxt = stream.get_nowait()
            except asyncio.QueueEmpty:
                break
            if nxt is None:
                eos = True
                break
            batch.append(nxt)

        # LWW across history and within the batch (monitor_items.rs:56-71);
        # per key only the newest surviving event applies.
        latest: dict = {}
        for e in batch:
            prev: Timestamp | None = seen.get(e.primary_key)
            if prev is not None and e.timestamp < prev:
                continue  # stale write, drop
            seen[e.primary_key] = e.timestamp
            latest[e.primary_key] = e

        upserts = [
            (k, e.embedding) for k, e in latest.items() if e.embedding is not None
        ]
        removes = [k for k, e in latest.items() if e.embedding is None]
        try:
            if upserts:
                await index.add_or_replace_batch(upserts)
            if removes:
                # one mailbox message (RemoveBatch) instead of one per
                # tombstone — a churny CDC stream can carry thousands
                if hasattr(index, "remove_batch"):
                    await index.remove_batch(removes)
                else:  # text-protocol handles: per-key Remove
                    for k in removes:
                        await index.remove(k)
        except RuntimeError:
            # index handle closed under us (engine del_index) — stop
            log.debug("monitor_items: index handle closed, terminating")
            return
        if eos:
            log.debug("monitor_items: stream closed, terminating")
            return


def spawn(stream: EmbeddingStream, index: IndexHandle) -> asyncio.Task:
    return asyncio.get_running_loop().create_task(
        run(stream, index), name="monitor-items"
    )
