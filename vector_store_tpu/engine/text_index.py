"""Text index backend — the OpenSearch actor role, device-resident.

Per-index actor serving the live text protocol (Add/Remove/Search,
reference: src/index/actor.rs:13-27) over the BM25 device index instead
of a remote OpenSearch cluster (src/index/opensearch.rs).  Behavioural
parity notes:

  * the reference actor recreates the remote index on spawn
    (delete-then-create, opensearch.rs:99-105) — here a fresh actor IS a
    fresh index, same observable effect;
  * Add is acked (actor.rs:36-46); Search returns keys ranked by score
    (opensearch.rs:196-209 parses hits[]._id);
  * the reference's Remove was a stub (opensearch.rs:148-150) — ours
    actually removes, because the capability exists in the ANN twin and
    a no-op remove would be an astonishing regression to keep.
"""

from __future__ import annotations

import asyncio
import logging
from typing import Optional

from ..text.bm25 import BM25Index
from ..types import IndexId, IndexMetadata
from .actor import Add, Ann, Count, IndexHandle, Remove, RemoveBatch, Search, spawn_index_actor
from .batcher import MicroBatcher
from .keymap import KeyMap

log = logging.getLogger("vst.text")


class TextIndexBackend:
    def __init__(
        self,
        index_id: IndexId,
        max_batch: int = 64,
        window_s: float = 0.002,
        n_devices: int = 1,
    ) -> None:
        self.index_id = index_id
        if n_devices > 1:
            # document-sharded BM25 over the device mesh (same flat-slot
            # API — see text/sharded_bm25.py)
            from ..text.sharded_bm25 import ShardedBM25Index

            self.index = ShardedBM25Index(n_devices=n_devices)
        else:
            self.index = BM25Index()
        self.keymap = KeyMap()
        self._batcher = MicroBatcher(
            self._run_query_batch, max_batch=max_batch, window_s=window_s
        )
        self._loop = asyncio.get_running_loop()
        self._inflight: set[asyncio.Task] = set()

    def _run_query_batch(self, items: list) -> list:
        texts = [t for t, _ in items]
        k_max = max(k for _, k in items)
        per_query = self.index.search(texts, k_max)
        out = []
        for hits, (_, k) in zip(per_query, items):
            keys = []
            for slot, _score in hits[:k]:
                key = self.keymap.key_of(slot)
                if key is not None:
                    keys.append(key)
            out.append(keys)
        return out

    async def __call__(self, msg) -> None:
        if isinstance(msg, Add):
            slot = await self._loop.run_in_executor(None, self.index.add, msg.text)
            old = self.keymap.bind(msg.key, slot)
            if old is not None:
                self.index.remove(old)
            if not msg.reply.done():
                msg.reply.set_result(None)
        elif isinstance(msg, Remove):
            slot = self.keymap.unbind(msg.key)
            if slot is not None:
                self.index.remove(slot)
        elif isinstance(msg, RemoveBatch):
            for key in msg.keys:
                slot = self.keymap.unbind(key)
                if slot is not None:
                    self.index.remove(slot)
        elif isinstance(msg, Search):
            # detach so concurrent searches coalesce into one device batch
            # (awaiting here would serialize the actor loop — see
            # ann_index.py for the same pattern)
            task = self._loop.create_task(
                self._answer_search(msg), name=f"search-{self.index_id}"
            )
            self._inflight.add(task)
            task.add_done_callback(self._inflight.discard)
        elif isinstance(msg, Count):
            msg.reply.set_result(self.index.count())
        elif isinstance(msg, Ann):
            raise TypeError("text index does not serve the ANN protocol")
        else:
            raise TypeError(f"unknown message {msg!r}")

    async def _answer_search(self, msg: Search) -> None:
        try:
            keys = await self._batcher.submit((msg.text, msg.limit.value))
            if not msg.reply.done():
                msg.reply.set_result(keys)
        except Exception as exc:  # noqa: BLE001 — route to the caller
            if not msg.reply.done():
                msg.reply.set_exception(exc)

    async def shutdown(self) -> None:
        if self._inflight:
            await asyncio.gather(*self._inflight, return_exceptions=True)
        await self._batcher.close()


class TextIndexFactory:
    """Factory for text index actors (the `new_opensearch` role,
    opensearch.rs:51-60)."""

    def __init__(
        self,
        max_batch: int = 64,
        window_s: float = 0.002,
        n_devices: int = 1,
    ) -> None:
        self.max_batch = max_batch
        self.window_s = window_s
        self.n_devices = n_devices

    def create_index(
        self, index_id: IndexId, metadata: Optional[IndexMetadata] = None
    ) -> IndexHandle:
        return spawn_index_actor(
            TextIndexBackend(
                index_id,
                max_batch=self.max_batch,
                window_s=self.window_s,
                n_devices=self.n_devices,
            ),
            name=str(index_id),
        )
