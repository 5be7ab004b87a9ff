"""Checkpoint/restore round-trip (the gap the reference left open, SURVEY §5)."""

import os
import tempfile

import numpy as np
import pytest

from vector_store_tpu.core import SlotIndex, persist
from vector_store_tpu.types import IndexParams


def test_snapshot_roundtrip(rng):
    idx = SlotIndex(
        IndexParams(dimensions=16, space="l2", dtype="float32"),
        initial_capacity=2048,
    )
    x = rng.normal(size=(500, 16)).astype(np.float32)
    slots = idx.add(x)
    idx.remove(slots[:50])

    d0, i0 = idx.search(x[100], 5)

    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "snap.npz")
        persist.save(path, idx, keymap_blob={"hello": 1})
        restored, blob = persist.load(path)

    assert blob == {"hello": 1}
    assert restored.count() == 450
    d1, i1 = restored.search(x[100], 5)
    np.testing.assert_array_equal(i0, i1)
    np.testing.assert_allclose(d0, d1, rtol=1e-5)

    # restored index accepts further writes
    more = restored.add(rng.normal(size=(10, 16)).astype(np.float32))
    assert restored.count() == 460
    assert more[0] == 500


def test_snapshot_roundtrip_int8(rng):
    """Quantized banks round-trip exactly (raw int8 values + scales)."""
    idx = SlotIndex(
        IndexParams(dimensions=16, space="cosine", dtype="int8"),
        initial_capacity=2048,
    )
    x = rng.normal(size=(200, 16)).astype(np.float32)
    idx.add(x)
    d0, i0 = idx.search(x[42], 3)

    import os
    import tempfile

    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "snap8.npz")
        persist.save(path, idx)
        restored, _ = persist.load(path)
        # int8 banks snapshot in native width — the file must be nearer
        # 1 byte/dim than the 4 bytes/dim an f32 cast would produce
        raw = 2048 * 16  # capacity × dims bytes at 1 B/dim
        assert os.path.getsize(path) < 3 * raw
    assert restored.state.vectors.dtype.name == "int8"
    d1, i1 = restored.search(x[42], 3)
    assert i1[0] == i0[0] == 42


def test_snapshot_preserves_exact_mode_block(rng):
    """Exact-mode indexes restore with their big ingest block.

    Regression: round 1 hardcoded insert_block=256 on load, so a
    restored exact index silently reverted to small-block ingest."""
    idx = SlotIndex(
        IndexParams(dimensions=8, space="l2", dtype="float32"),
        exact=True,
    )
    x = rng.normal(size=(100, 8)).astype(np.float32)
    idx.add(x)
    assert idx.insert_block >= 4096

    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "snap_exact.npz")
        persist.save(path, idx)
        restored, _ = persist.load(path)
    assert restored._exact is True
    assert restored.insert_block == idx.insert_block
    d, i = restored.search(x[7], 1)
    assert i[0] == 7


@pytest.mark.slow
def test_bm25_snapshot_roundtrip(tmp_path):
    """Text-index checkpoint: scores, expansions, and df bookkeeping all
    survive a save -> load cycle (single-chip and sharded)."""
    from vector_store_tpu.text.bm25 import BM25Index
    from vector_store_tpu.text.sharded_bm25 import ShardedBM25Index

    src = BM25Index()
    s0 = src.add("the quick brown fox jumps over the lazy dog")
    s1 = src.add("appliance parts and apple catalogs")
    s2 = src.add("tensor processing units score text")
    src.remove(s1)
    src.add("a quick brown cat sleeps")  # reuses no slot; frontier grows
    path = str(tmp_path / "bm25.npz")
    src.save(path)

    for cls, kw in ((BM25Index, {}), (ShardedBM25Index, {"n_devices": 4})):
        idx = cls.load(path, **kw)
        assert idx.count() == src.count()
        want = src.search(["quick fox", "tensor units"], 4)
        got = idx.search(["quick fox", "tensor units"], 4)
        for w, g in zip(want, got):
            assert [s for s, _ in w] == [s for s, _ in g]
            np.testing.assert_allclose(
                [x for _, x in w], [x for _, x in g], rtol=1e-5
            )
        # removed doc's unique terms must not expand (df rebuilt at 0)
        assert idx.expand_prefix("applianc", 5) == []
        assert set(idx.expand_prefix("quic", 5)) == set(
            src.expand_prefix("quic", 5)
        )
        # phrase sequences restored (host verify path)
        assert {h[0] for h in idx.search(['"quick brown"'], 5)[0]} == {
            h[0] for h in src.search(['"quick brown"'], 5)[0]
        }
        # post-load mutations keep working
        s_new = idx.add("fox fox fox")
        assert idx.search(["fox"], 1)[0][0][0] == s_new
        assert s2 in {h[0] for h in idx.search(["tensor"], 3)[0]}


def _with_retired_cfg_key(path):
    """Rewrite a snapshot's meta as older builds wrote it: `cfg` carried
    a `fused_gather` execution flag, a field that no longer exists."""
    import json

    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    meta = json.loads(bytes(arrays["meta"]).decode())
    meta["cfg"]["fused_gather"] = True
    arrays["meta"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    np.savez(path, **arrays)


def test_snapshot_with_retired_fused_gather_loads(rng):
    """A snapshot whose config still holds `fused_gather` loads, and the
    restored index answers as the saved one did."""
    idx = SlotIndex(IndexParams(dimensions=16), initial_capacity=2048)
    x = rng.normal(size=(300, 16)).astype(np.float32)
    idx.add(x)
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "snap.npz")
        persist.save(path, idx)
        _with_retired_cfg_key(path)
        restored, _ = persist.load(path)
    assert not hasattr(restored.cfg, "fused_gather")
    d0, i0 = idx.search(x[:8], 5)
    d1, i1 = restored.search(x[:8], 5)
    assert (i0 == i1).all()
    restored.add(rng.normal(size=(32, 16)).astype(np.float32))
    assert restored.count() == 332


def test_sharded_snapshot_with_retired_fused_gather_loads(rng, tmp_path):
    """Same for the sharded graph index's snapshot."""
    from vector_store_tpu.shard.sharded_index import ShardedSlotIndex

    idx = ShardedSlotIndex(IndexParams(dimensions=16), n_devices=2)
    x = rng.normal(size=(200, 16)).astype(np.float32)
    idx.add(x)
    path = str(tmp_path / "sharded.npz")
    idx.save(path)
    _with_retired_cfg_key(path)
    restored = ShardedSlotIndex.load(path)
    _, i0 = idx.search(x[:4], 3)
    _, i1 = restored.search(x[:4], 3)
    assert (i0 == i1).all()
