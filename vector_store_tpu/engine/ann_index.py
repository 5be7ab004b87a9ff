"""ANN index backend — the usearch actor role on the device.

Per-index actor wrapping a device `SlotIndex` plus the key bimap
(reference: src/index/usearch.rs — actor at :105-146, bimap :109-113,
add_or_replace :214-232, ann :251-306, count :308-311).  Differences by
design:

  * queries go through a micro-batcher that coalesces concurrent Ann
    requests into one padded device step (replaces the per-query rayon
    spawn throttled by a semaphore, usearch.rs:115-118,274-277);
  * mutations are applied by the actor in ingest batches: consecutive
    AddOrReplace/Remove messages in the mailbox are drained and applied
    as one batched insert/delete step.
"""

from __future__ import annotations

import asyncio
import logging
import threading
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from ..core.index import SlotIndex
from ..types import IndexId, IndexMetadata, IndexParams, PrimaryKey
from .actor import (
    Add,
    AddOrReplace,
    AddOrReplaceBatch,
    Ann,
    Compact,
    Count,
    IndexHandle,
    Remove,
    RemoveBatch,
    Search,
    spawn_index_actor,
)
from ..utils import metrics
from .batcher import MicroBatcher
from .keymap import KeyMap

log = logging.getLogger("vst.ann")


@dataclass
class _UpsertRun:
    """Coalesced run of consecutive AddOrReplace/AddOrReplaceBatch
    messages — applied as ONE batched device insert.

    `spans[j]` is the (start, end) item range carried by `replies[j]`:
    an acked message whose items fail validation gets the error routed
    to ITS reply, not a blanket success (the reference routes the
    dim-check ValueError to the caller, usearch.rs:259-272)."""

    items: list  # [(PrimaryKey, np.ndarray raw)]
    replies: list = field(default_factory=list)  # [asyncio.Future]
    spans: list = field(default_factory=list)  # [(start, end)] per reply


@dataclass
class _RemoveRun:
    """Coalesced run of consecutive Remove messages — one delete step."""

    keys: list


class AnnIndexBackend:
    """Message processor for one ANN index."""

    def __init__(
        self,
        index_id: IndexId,
        params: IndexParams,
        exact: bool = False,
        max_batch: int = 256,
        window_s: float = 0.002,
        n_devices: int = 1,
        backend: str = "graph",
        reserve_rows: int = 0,
    ) -> None:
        self.index_id = index_id
        self.params = params
        if exact:
            backend = "exact"
        if n_devices > 1 and backend == "ivf":
            # document-sharded IVF over the device mesh (same
            # add/remove/search/count API as the single-chip IvfIndex)
            from ..shard.sharded_ivf import ShardedIvfIndex

            self.index = ShardedIvfIndex(params, n_devices=n_devices)
        elif n_devices > 1:
            # document-sharded graph/exact index over the device mesh
            from ..shard.sharded_index import ShardedSlotIndex

            self.index = ShardedSlotIndex(
                params, n_devices=n_devices, exact=backend == "exact"
            )
        elif backend == "ivf":
            from ..core.ivf import IvfIndex

            # reserve_rows: bulk-load hint — size the clustering AND the
            # staging bank for the expected final row count (one
            # recluster + one compiled shape set instead of one per
            # doubling; see core/ivf.py).  Very large reservations
            # (>2M × 768) should build the index directly with a small
            # initial_capacity so the staging bank stays small.
            self.index = IvfIndex(
                params,
                reserve_rows=reserve_rows,
                initial_capacity=reserve_rows or None,
            )
        else:
            self.index = SlotIndex(params, exact=backend == "exact")
        self.keymap = KeyMap()
        self._batcher = MicroBatcher(
            self._run_query_batch, max_batch=max_batch, window_s=window_s
        )
        self._loop = asyncio.get_running_loop()
        self._inflight: set[asyncio.Task] = set()
        # pairs (index state, keymap) atomically between the query flush
        # thread and the compaction swap: a query must never map NEW
        # slots through the OLD keymap (or vice versa)
        self._serve_lock = threading.Lock()

    # -- device-side batch execution (worker thread) ----------------------

    def _run_query_batch(self, items: list) -> list:
        """items: [(embedding, k)] → [(keys, distances)] per item."""
        k_max = max(k for _, k in items)
        queries = np.stack([e for e, _ in items])  # always 2-D → 2-D results
        metrics.counter("vst_ann_queries_total", index=str(self.index_id)).inc(
            len(items)
        )
        # the serve lock pairs the index state with its keymap: slots
        # from the pre-compact state must never map through the
        # post-compact keymap (and vice versa).  The lock covers the
        # DISPATCH and the keymap snapshot only — the host readback
        # (fetch) runs outside it, so several flush threads can keep
        # device batches in flight over a high-latency link
        # (MicroBatcher pipeline depth).  Compaction swaps in a brand-new
        # KeyMap object under this lock, so a snapshot taken with the
        # old state keeps mapping consistently through the old keymap.
        with self._serve_lock:
            with metrics.timed(
                "vst_ann_batch_seconds", backend=type(self.index).__name__
            ):
                if hasattr(self.index, "search_dispatch"):
                    fetch = self.index.search_dispatch(queries, k_max)
                else:  # sharded backends: full search under the lock
                    res = self.index.search(queries, k_max)
                    fetch = lambda: res  # noqa: E731
                keymap = self.keymap
        dist, slots = fetch()
        out = []
        for j, (_, k) in enumerate(items):
            keys, dists = [], []
            for s, d in zip(slots[j][:k], dist[j][:k]):
                if s < 0:
                    continue
                key = keymap.key_of(int(s))
                if key is None:
                    continue  # slot tombstoned between search and mapping
                keys.append(key)
                dists.append(float(d))
            out.append((keys, dists))
        return out

    def _apply_upserts(self, batch: list[tuple[PrimaryKey, np.ndarray]]) -> None:
        for key, _ in batch:
            # Probe hashability BEFORE the device insert: a bad key must
            # not leave an orphan row that count() sees but no lookup can
            # ever reach.
            try:
                hash(key)
            except TypeError as exc:
                raise ValueError(f"unusable primary key {key!r}: {exc}") from exc
        vecs = np.stack([v for _, v in batch])
        metrics.counter("vst_ann_upserts_total", index=str(self.index_id)).inc(
            len(batch)
        )
        slots = self.index.add(vecs)
        dead = []
        for (key, _), slot in zip(batch, slots):
            old = self.keymap.bind(key, int(slot))
            if old is not None:
                dead.append(old)
        if dead:
            self.index.remove(np.asarray(dead, dtype=np.int64))

    # -- actor message handling ------------------------------------------

    def _check_dims(self, embedding: np.ndarray) -> np.ndarray:
        embedding = np.asarray(embedding, dtype=np.float32).reshape(-1)
        if embedding.shape[0] != self.params.dimensions:
            # reference: ann dimension validation, usearch.rs:259-272
            raise ValueError(
                f"index {self.index_id}: expected embedding of "
                f"{self.params.dimensions} dimensions, got {embedding.shape[0]}"
            )
        return embedding

    def coalesce(self, msgs: list) -> list:
        """Mailbox-drain hook (actor.py loop): merge consecutive mutation
        messages so N queued upserts/removes cost one device step, not N.
        Runs never cross a message of another type, so per-key ordering
        (e.g. Remove(k) … AddOrReplace(k)) is preserved."""
        out: list = []
        for msg in msgs:
            prev = out[-1] if out else None
            if isinstance(msg, AddOrReplace):
                if not isinstance(prev, _UpsertRun):
                    prev = _UpsertRun(items=[])
                    out.append(prev)
                start = len(prev.items)
                prev.items.append((msg.primary_key, msg.embedding))
                if msg.reply is not None:
                    prev.replies.append(msg.reply)
                    prev.spans.append((start, len(prev.items)))
            elif isinstance(msg, AddOrReplaceBatch):
                if not isinstance(prev, _UpsertRun):
                    prev = _UpsertRun(items=[])
                    out.append(prev)
                start = len(prev.items)
                prev.items.extend(msg.items)
                if msg.reply is not None:
                    prev.replies.append(msg.reply)
                    prev.spans.append((start, len(prev.items)))
            elif isinstance(msg, Remove):
                if not isinstance(prev, _RemoveRun):
                    prev = _RemoveRun(keys=[])
                    out.append(prev)
                prev.keys.append(msg.key)
            elif isinstance(msg, RemoveBatch):
                if not isinstance(prev, _RemoveRun):
                    prev = _RemoveRun(keys=[])
                    out.append(prev)
                prev.keys.extend(msg.keys)
            else:
                out.append(msg)
        return out

    async def _apply_upsert_run(self, run: _UpsertRun) -> None:
        items = []
        errors: dict[int, ValueError] = {}
        for j, (k, e) in enumerate(run.items):
            # per-item validation: a malformed upsert in a coalesced run
            # must not poison its neighbours (reference logs-and-drops,
            # opensearch.rs:166-172) — but an ACKED message whose items
            # were dropped must get the error, not a silent success
            try:
                items.append((k, self._check_dims(e)))
            except ValueError as exc:
                errors[j] = exc
                log.exception("index %s: dropping bad upsert", self.index_id)
        if items:
            await self._loop.run_in_executor(None, self._apply_upserts, items)
        for reply, (start, end) in zip(run.replies, run.spans):
            if reply.done():
                continue
            err = next(
                (errors[j] for j in range(start, end) if j in errors), None
            )
            if err is not None:
                reply.set_exception(err)
            else:
                reply.set_result(None)

    async def _apply_remove_run(self, run: _RemoveRun) -> None:
        slots = [
            s
            for s in (self.keymap.unbind(k) for k in run.keys)
            if s is not None
        ]
        if slots:
            await self._loop.run_in_executor(
                None, self.index.remove, np.asarray(slots, dtype=np.int64)
            )

    async def __call__(self, msg) -> None:
        if isinstance(msg, (AddOrReplace, AddOrReplaceBatch)):
            # direct path (no coalescing loop, e.g. tests driving the
            # backend object): wrap in a one-message run
            await self._apply_upsert_run(self.coalesce([msg])[0])
        elif isinstance(msg, _UpsertRun):
            await self._apply_upsert_run(msg)
        elif isinstance(msg, Remove):
            await self._apply_remove_run(_RemoveRun(keys=[msg.key]))
        elif isinstance(msg, RemoveBatch):
            await self._apply_remove_run(_RemoveRun(keys=list(msg.keys)))
        elif isinstance(msg, _RemoveRun):
            await self._apply_remove_run(msg)
        elif isinstance(msg, Ann):
            emb = self._check_dims(msg.embedding)
            # Detach: awaiting the batched result here would stall the
            # actor loop, so at most one query would ever be in flight and
            # the micro-batcher could never coalesce (every query would
            # still pay the full batching window).  The task resolves the
            # reply when the batch it rode in completes.
            task = self._loop.create_task(
                self._answer_ann(emb, msg), name=f"ann-{self.index_id}"
            )
            self._inflight.add(task)
            task.add_done_callback(self._inflight.discard)
        elif isinstance(msg, Count):
            msg.reply.set_result(self.index.count())
        elif isinstance(msg, Compact):
            if not hasattr(self.index, "compact"):
                raise TypeError("backend does not support compaction")
            if hasattr(self.index, "compact_prepare"):
                # slot-moving backends (graph/exact): rebuild OFFLINE
                # while queries keep serving the old (state, keymap)
                # pair, then swap state + keymap in one serve-lock
                # critical section (the rebuild runs in an executor; the
                # install is a cheap pointer swap)
                scratch, remap = await self._loop.run_in_executor(
                    None, self.index.compact_prepare
                )
                keys = [
                    (self.keymap.key_of(old), new) for old, new in remap.items()
                ]
                new_keymap = KeyMap()
                for key, new in keys:
                    if key is not None:
                        new_keymap.bind(key, new)
                with self._serve_lock:
                    self.index.compact_install(scratch)
                    self.keymap = new_keymap
            else:
                # id-stable backends (IVF): compact() recluters under the
                # index's own lock and returns {} — keymap untouched
                remap = await self._loop.run_in_executor(
                    None, self.index.compact
                )
                assert not remap, "id-stable backend returned a remap"
            msg.reply.set_result(self.index.count())
        elif isinstance(msg, (Add, Search)):
            raise TypeError("ANN index does not serve the text protocol")
        else:
            raise TypeError(f"unknown message {msg!r}")

    async def _answer_ann(self, emb: np.ndarray, msg: Ann) -> None:
        try:
            res = await self._batcher.submit((emb, msg.limit.value))
            if not msg.reply.done():
                msg.reply.set_result(res)
        except Exception as exc:  # noqa: BLE001 — route to the caller
            if not msg.reply.done():
                msg.reply.set_exception(exc)

    async def shutdown(self) -> None:
        if self._inflight:
            await asyncio.gather(*self._inflight, return_exceptions=True)
        await self._batcher.close()


class AnnIndexFactory:
    """Factory producing ANN index actors (factory.rs:10-12 seam;
    the usearch `new_usearch` role, usearch.rs:47-57)."""

    def __init__(
        self,
        default_params: Optional[IndexParams] = None,
        exact: bool = False,
        max_batch: int = 256,
        window_s: float = 0.002,
        n_devices: int = 1,
        backend: str = "graph",
        reserve_rows: int = 0,
    ) -> None:
        self.default_params = default_params
        self.exact = exact
        self.max_batch = max_batch
        self.window_s = window_s
        self.n_devices = n_devices
        self.backend = backend
        self.reserve_rows = reserve_rows

    def create_index(
        self, index_id: IndexId, metadata: Optional[IndexMetadata] = None
    ) -> IndexHandle:
        params = (
            metadata.params
            if metadata is not None
            else self.default_params
        )
        if params is None:
            raise ValueError(f"no params for index {index_id}")
        backend = AnnIndexBackend(
            index_id,
            params,
            exact=self.exact,
            max_batch=self.max_batch,
            window_s=self.window_s,
            n_devices=self.n_devices,
            backend=self.backend,
            reserve_rows=self.reserve_rows,
        )
        return spawn_index_actor(backend, name=str(index_id))
