"""MicroBatcher unit tests: coalescing, overflow, error fan-out."""

import asyncio

import pytest

from vector_store_tpu.engine.batcher import MicroBatcher


@pytest.mark.asyncio
async def test_batcher_coalesces_concurrent_submissions():
    batches = []

    def flush(items):
        batches.append(list(items))
        return [x * 2 for x in items]

    b = MicroBatcher(flush, max_batch=64, window_s=0.005)
    results = await asyncio.gather(*(b.submit(i) for i in range(10)))
    assert results == [i * 2 for i in range(10)]
    # all ten went through few flushes (coalesced), not ten
    assert len(batches) <= 3
    await b.close()


@pytest.mark.asyncio
async def test_batcher_max_batch_overflow():
    sizes = []

    def flush(items):
        sizes.append(len(items))
        return items

    b = MicroBatcher(flush, max_batch=4, window_s=0.001)
    results = await asyncio.gather(*(b.submit(i) for i in range(10)))
    assert sorted(results) == list(range(10))
    assert max(sizes) <= 4
    await b.close()


@pytest.mark.asyncio
async def test_batcher_error_propagates_to_all_waiters():
    def flush(items):
        raise RuntimeError("device on fire")

    b = MicroBatcher(flush, max_batch=8, window_s=0.001)
    results = await asyncio.gather(
        *(b.submit(i) for i in range(3)), return_exceptions=True
    )
    assert all(isinstance(r, RuntimeError) for r in results)
    await b.close()


@pytest.mark.asyncio
async def test_batcher_rejects_after_close():
    b = MicroBatcher(lambda items: items, max_batch=8)
    await b.close()
    with pytest.raises(RuntimeError):
        await b.submit(1)


@pytest.mark.asyncio
async def test_batcher_short_results_fail_loudly():
    """A flush_fn returning fewer results than items must fail every
    future in the batch (zip() once silently stranded the rest)."""

    async def run():
        batcher = MicroBatcher(lambda items: [0] * (len(items) - 1), window_s=0.01)
        subs = [asyncio.create_task(batcher.submit(i)) for i in range(4)]
        res = await asyncio.gather(*subs, return_exceptions=True)
        assert all(isinstance(r, RuntimeError) for r in res), res
        await batcher.close()

    await asyncio.wait_for(run(), 30)


@pytest.mark.asyncio
async def test_batcher_pipeline_depth_bounds_inflight():
    """Up to `depth` flushes run concurrently; results still route."""
    inflight = 0
    peak = 0

    async def _noop():
        await asyncio.sleep(0.02)

    def flush(items):
        nonlocal inflight, peak
        inflight += 1
        peak = max(peak, inflight)
        import time as _t

        _t.sleep(0.02)  # hold the slot so flushes overlap
        inflight -= 1
        return [x + 100 for x in items]

    b = MicroBatcher(flush, max_batch=2, window_s=0.0, depth=3)
    results = await asyncio.gather(*(b.submit(i) for i in range(12)))
    assert sorted(results) == [i + 100 for i in range(12)]
    assert peak <= 3
    assert peak >= 2  # it actually pipelined
    await b.close()


@pytest.mark.asyncio
async def test_batcher_depth_one_is_serial():
    inflight = 0

    def flush(items):
        nonlocal inflight
        inflight += 1
        assert inflight == 1
        import time as _t

        _t.sleep(0.005)
        inflight -= 1
        return items

    b = MicroBatcher(flush, max_batch=2, window_s=0.0, depth=1)
    results = await asyncio.gather(*(b.submit(i) for i in range(8)))
    assert sorted(results) == list(range(8))
    await b.close()
