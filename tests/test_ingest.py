"""Ingestion tests: LWW bridge flow + full fake-DB pipeline.

Ports the reference's monitor_items `flow` test (monitor_items.rs:82-207)
and the db_basic-driven end-to-end pipeline test (tests/integration/
usearch.rs:22-135) onto the device engine, zero external processes.
"""

import asyncio

import numpy as np
import pytest

from vector_store_tpu.engine import AnnIndexFactory, new_engine
from vector_store_tpu.engine.actor import (
    AddOrReplace,
    AddOrReplaceBatch,
    IndexHandle,
    Remove,
    spawn_index_actor,
)
from vector_store_tpu.ingest import MemDb, MonitorIndexes, monitor_items
from vector_store_tpu.ingest.source import EmbeddingStream
from vector_store_tpu.types import DbEmbedding, IndexId, Limit, Timestamp


@pytest.mark.asyncio
async def test_monitor_items_lww_flow():
    """Hand-fed events: out-of-order timestamps dropped, None → Remove,
    clean shutdown on stream close (monitor_items.rs:82-207).

    The bridge coalesces queued events into batched upserts (a batching
    deviation from the reference's one-message-per-event), so the assert
    replays the applied operations and checks per-key FINAL state plus
    that the stale write never reached the index."""
    received = []

    async def recorder(msg):
        if isinstance(msg, AddOrReplace):
            received.append(("add", msg.primary_key, msg.embedding.tolist()))
            if msg.reply is not None:
                msg.reply.set_result(None)
        elif isinstance(msg, AddOrReplaceBatch):
            for key, emb in msg.items:
                received.append(("add", key, np.asarray(emb).tolist()))
            if msg.reply is not None:
                msg.reply.set_result(None)
        elif isinstance(msg, Remove):
            received.append(("remove", msg.key))

    handle = spawn_index_actor(recorder, name="recorder")
    stream = EmbeddingStream(("pk",))
    task = monitor_items.spawn(stream, handle)

    e = lambda k, v, t: DbEmbedding((k,), None if v is None else np.array(v, np.float32), Timestamp(t))
    await stream.put(e(1, [1.0], 10))
    await stream.put(e(1, [2.0], 5))   # stale — dropped
    await stream.put(e(1, [3.0], 20))  # newer — applied
    await stream.put(e(2, None, 7))    # tombstone → Remove
    await stream.put(e(2, [9.0], 7))   # equal timestamp → applied (LWW uses <)
    await stream.close()

    await asyncio.wait_for(task, 10)  # terminates on stream close
    handle.close()
    await handle.join()
    # the stale t=5 write must never have been applied
    assert ("add", (1,), [2.0]) not in received
    # replay: per-key final state matches the reference's ordered flow
    state = {}
    for op, key, *rest in received:
        state[key] = rest[0] if op == "add" else None
    assert state == {(1,): [3.0], (2,): [9.0]}


@pytest.mark.asyncio
async def test_full_pipeline_on_memdb():
    """add table+index+3 vectors → poll count==3 → ann nearest → del index
    → poll list empty (tests/integration/usearch.rs:22-135)."""
    db = MemDb()
    engine = await new_engine(AnnIndexFactory())
    mon = MonitorIndexes(db, engine, tick_s=0.01)
    mon.spawn()
    try:
        db.add_table("vectors", ("id",), 3)
        await db.insert_values("vectors", (1,), [1.0, 1.0, 1.0])
        await db.insert_values("vectors", (2,), [2.0, -2.0, 2.0])
        await db.insert_values("vectors", (3,), [3.0, 3.0, 3.0])
        # l2: the probe vectors are colinear, cosine would tie them
        from vector_store_tpu.types import IndexParams

        db.add_index("ks.idx", "vectors", IndexParams(dimensions=3, space="l2"))

        async with asyncio.timeout(20):
            while (await engine.get_index_ids()) == []:
                await asyncio.sleep(0)
            actor = await engine.get_index(IndexId("ks.idx"))
            while await actor.count() != 3:
                await asyncio.sleep(0)

        keys, dists = await actor.ann(np.array([2.2, -2.2, 2.2]), Limit(1))
        assert keys == [(2,)]

        # live CDC: post-scan upsert + delete reach the index
        await db.insert_values("vectors", (4,), [2.2, -2.2, 2.2])
        async with asyncio.timeout(20):
            while await actor.count() != 4:
                await asyncio.sleep(0)
        keys, _ = await actor.ann(np.array([2.2, -2.2, 2.2]), Limit(1))
        assert keys == [(4,)]
        await db.delete_values("vectors", (4,))
        async with asyncio.timeout(20):
            while await actor.count() != 3:
                await asyncio.sleep(0)

        # drop the index → engine list drains (usearch.rs:124-135)
        db.del_index("ks.idx")
        async with asyncio.timeout(20):
            while (await engine.get_index_ids()) != []:
                await asyncio.sleep(0)
    finally:
        await mon.stop()
        await db.close_streams()
        await engine.close()


@pytest.mark.asyncio
async def test_pipeline_random_churn_converges():
    await churn_converges_once(23)


async def churn_converges_once(seed: int) -> None:
    """Randomized upsert/delete storm (with out-of-order timestamps)
    through the memdb CDC path: the index must converge to exactly the
    DB's LWW-resolved live rows, and every live key must self-lookup.
    (Seed-parameterized so scripts/fuzz_soak.py can loop fresh seeds.)"""
    from vector_store_tpu.types import IndexParams

    db = MemDb()
    engine = await new_engine(AnnIndexFactory())
    mon = MonitorIndexes(db, engine, tick_s=0.01)
    mon.spawn()
    rng = np.random.default_rng(seed)
    d = 8
    try:
        db.add_table("t", ("id",), d)
        db.add_index("ks.fz", "t", IndexParams(dimensions=d, space="l2"))
        inserted: set = set()
        for step in range(120):
            key = (int(rng.integers(0, 40)),)
            if rng.random() < 0.25 and key in inserted:
                await db.delete_values("t", key)
            else:
                v = rng.normal(size=(d,)).astype(np.float32)
                ts = None
                if rng.random() < 0.2:
                    # stale write: must lose LWW against any prior write
                    ts = Timestamp(1)
                await db.insert_values("t", key, v, timestamp=ts)
                inserted.add(key)
        # expected state from the db's own LWW store
        live = {
            k: r.embedding
            for k, r in db._tables["t"].rows.items()
            if r.embedding is not None
        }
        async with asyncio.timeout(60):
            while (await engine.get_index_ids()) == []:
                await asyncio.sleep(0)
            actor = await engine.get_index(IndexId("ks.fz"))
            while await actor.count() != len(live):
                await asyncio.sleep(0.01)
        for key in list(live)[:10]:
            keys, dists = await actor.ann(live[key], Limit(1))
            assert keys == [key], f"{key} self-lookup -> {keys}"
    finally:
        await mon.stop()
        await db.close_streams()
        await engine.close()
