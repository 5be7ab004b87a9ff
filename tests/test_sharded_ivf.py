"""Sharded-IVF parity with the single-device IvfIndex.

The IVF backend is the fastest serving tier; these tests prove it is a
drop-in on the 8-virtual-device CPU mesh: staging→clustered transition,
stable ids across recluster, tombstone churn, persistence, and the
engine-level backend="ivf", n_devices>1 wiring (previously a silent
fall-through to the graph backend).
"""

import numpy as np
import pytest

from vector_store_tpu.shard.sharded_ivf import ShardedIvfIndex
from vector_store_tpu.types import IndexParams


def _data(n, d, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(32, d)).astype(np.float32)
    return centers[rng.integers(0, 32, n)] + 0.3 * rng.normal(
        size=(n, d)
    ).astype(np.float32)


def _recall(ids, exact):
    q, k = exact.shape
    return np.mean([len(set(ids[i][:k]) & set(exact[i])) / k for i in range(q)])


def test_sharded_ivf_staging_then_clustered():
    d = 16
    x = _data(6000, d, seed=1)
    idx = ShardedIvfIndex(
        IndexParams(dimensions=d, space="cosine"), n_devices=8, cluster_min=4000
    )
    gids = idx.add(x)
    assert idx.count() == 6000
    assert idx._clustered  # crossed cluster_min → per-shard recluster ran
    # self-lookup at probes=16 on a 32-cluster mixture
    dist, ids = idx.search(x[:64], 1, probes=16)
    assert (ids[:, 0] == gids[:64]).all()
    # recall vs the cross-shard exact oracle
    rng = np.random.default_rng(2)
    q = x[rng.choice(len(x), 64, replace=False)] + 0.05 * rng.normal(
        size=(64, d)
    ).astype(np.float32)
    _, exact = idx.exact_search(q, 10)
    _, got = idx.search(q, 10, probes=32)
    assert _recall(got, exact) >= 0.9


def test_sharded_ivf_ids_stable_across_compact():
    d = 16
    x = _data(5000, d, seed=3)
    idx = ShardedIvfIndex(
        IndexParams(dimensions=d, space="cosine"), n_devices=8, cluster_min=4000
    )
    gids = idx.add(x)
    remap = idx.compact()  # recluster — ids must NOT move
    assert remap == {}
    assert idx.count() == 5000
    _, ids = idx.search(x[:32], 1, probes=16)
    assert (ids[:, 0] == gids[:32]).all()


def test_sharded_ivf_remove_churn():
    d = 12
    x = _data(5000, d, seed=4)
    idx = ShardedIvfIndex(
        IndexParams(dimensions=d, space="l2"), n_devices=8, cluster_min=4000
    )
    gids = idx.add(x)
    idx.remove(gids[:500])
    assert idx.count() == 4500
    idx.remove(gids[:500])  # double remove: no-op
    assert idx.count() == 4500
    idx.remove(np.asarray([10**6 + 1]))  # never-issued gid: no-op
    assert idx.count() == 4500
    # removed rows never come back from a search
    _, ids = idx.search(x[:16], 3, probes=32)
    dead = set(gids[:500].tolist())
    assert not (set(ids.reshape(-1).tolist()) & dead)
    # reinsert reuses tombstoned slots (no bucket growth at flat count)
    b_before = idx.bucket
    idx.add(x[:500])
    assert idx.count() == 5000
    assert idx.bucket == b_before


def test_sharded_ivf_int8_and_persist(tmp_path):
    d = 16
    x = _data(5000, d, seed=5)
    idx = ShardedIvfIndex(
        IndexParams(dimensions=d, space="cosine", dtype="int8"),
        n_devices=8,
        cluster_min=4000,
    )
    import jax.numpy as jnp

    gids = idx.add(x)
    assert idx.state.vectors.dtype == jnp.int8
    idx.remove(gids[:7])
    path = str(tmp_path / "sharded_ivf.npz")
    idx.save(path)
    idx2 = ShardedIvfIndex.load(path, n_devices=8)
    assert idx2.count() == idx.count()
    q = x[100:132]
    d1, i1 = idx.search(q, 5, probes=16)
    d2, i2 = idx2.search(q, 5, probes=16)
    assert (i1 == i2).all()
    np.testing.assert_allclose(d1, d2, rtol=1e-5, atol=1e-6)
    # restored index keeps ingesting
    idx2.add(x[:16])
    assert idx2.count() == idx.count() + 16


def test_sharded_kernel_matches_probe_interpret():
    """The per-shard kernel plumbing (mode='kernel' in _sh_search,
    interpreted) returns what the XLA probe path returns on the CPU
    mesh; the compiled kernel is checked on the card (test_gpu.py)."""
    from vector_store_tpu.shard.sharded_ivf import _sh_search

    d = 24
    x = _data(6000, d, seed=6)
    idx = ShardedIvfIndex(
        IndexParams(dimensions=d, space="cosine"), n_devices=4, cluster_min=1000
    )
    idx.add(x)
    assert idx._clustered

    rng = np.random.default_rng(7)
    q = x[:8] + 0.05 * rng.normal(size=(8, d)).astype(np.float32)
    d_k, i_k = _sh_search(
        idx._state, q, "cosine", 10, 4, "kernel", idx._holder, interpret=True
    )
    d_p, i_p = _sh_search(idx._state, q, "cosine", 10, 4, "probe", idx._holder)
    assert (np.asarray(i_k) == np.asarray(i_p)).all()
    np.testing.assert_allclose(
        np.asarray(d_k), np.asarray(d_p), rtol=1e-4, atol=1e-4
    )


@pytest.mark.asyncio
async def test_engine_ivf_sharded_backend():
    """backend='ivf' + n_devices>1 now builds the sharded IVF (
    it silently built the graph backend instead)."""
    from vector_store_tpu.engine.ann_index import AnnIndexFactory
    from vector_store_tpu.types import IndexId, IndexMetadata, Limit

    factory = AnnIndexFactory(n_devices=8, backend="ivf")
    meta = IndexMetadata(
        index_id=IndexId("ks.sivf"),
        params=IndexParams(dimensions=8, space="l2"),
        key_columns=("id",),
    )
    handle = factory.create_index(IndexId("ks.sivf"), meta)
    handle.metadata = meta
    try:
        x = _data(64, 8, seed=9)
        await handle.add_or_replace_batch([((i,), row) for i, row in enumerate(x)])
        assert await handle.count() == 64
        keys, dists = await handle.ann(x[7], Limit(1))
        assert keys[0] == (7,)
    finally:
        handle.close()
        await handle.join()


def test_default_factory_routes_ivf_to_sharded():
    """new_index_factory(n_devices=8) must forward n_devices into the
    'ivf' kind so a served deployment actually gets the sharded tier
    (it once built a single-device IvfIndex while 7 devices idled)."""
    import vector_store_tpu as vst

    factory = vst.new_index_factory(n_devices=8)
    for kind in ("ann", "ivf"):
        assert factory._by_kind[kind].n_devices == 8, kind


def test_sharded_ivf_single_row_adds_balance():
    """A stream of single-row add() calls must spread over shards via the
    rotating cursor (same fix as ShardedSlotIndex: every call previously
    restarted the deal at shard 0)."""
    d = 8
    idx = ShardedIvfIndex(
        IndexParams(dimensions=d, space="l2"), n_devices=8, cluster_min=10_000
    )
    rng = np.random.default_rng(3)
    gids = []
    for _ in range(17):
        gids.extend(idx.add(rng.normal(size=(1, d)).astype(np.float32)))
    assert idx.count() == 17
    sizes = [b.n_live for b in idx._books]
    assert max(sizes) - min(sizes) <= 1, sizes
    assert len(set(int(g) for g in gids)) == 17
    # every row still self-looks-up through the staging scan
    d_, ids = idx.search(
        np.stack([rng.normal(size=(d,)) for _ in range(2)]).astype(np.float32), 5
    )
    assert ids.shape == (2, 5)


@pytest.mark.slow
def test_sharded_ivf_two_stage_recall_and_mutation():
    """coarse=True routes searches through the per-shard two-stage scan
    (int4 coarse + int8 rescore, gid-merged); recall must track the
    single-stage int8 path and the derived bank must follow mutations."""
    d = 64
    x = _data(6000, d, seed=8)
    base = ShardedIvfIndex(
        IndexParams(dimensions=d, space="cosine", dtype="int8"),
        n_devices=8,
        cluster_min=4000,
        coarse=False,
    )
    two = ShardedIvfIndex(
        IndexParams(dimensions=d, space="cosine", dtype="int8"),
        n_devices=8,
        cluster_min=4000,
        coarse=True,
        rescore=16,  # int4 noise ~1/sqrt(D): D=64 wants a big overfetch
    )
    gb = base.add(x)
    gt_ids = two.add(x)
    assert two.coarse and two._clustered
    np.testing.assert_array_equal(gb, gt_ids)

    rng = np.random.default_rng(9)
    q = x[rng.choice(len(x), 64, replace=False)] + 0.05 * rng.normal(
        size=(64, d)
    ).astype(np.float32)
    _, exact_i = base.exact_search(q, 10)
    _, i_base = base.search(q, 10, probes=16)
    _, i_two = two.search(q, 10, probes=16)
    r_base, r_two = _recall(i_base, exact_i), _recall(i_two, exact_i)
    assert r_two >= r_base - 0.03, (r_two, r_base)
    assert r_two >= 0.9

    # mutation invalidates the derived bank; new rows are findable
    assert not two._coarse_stale
    new_g = two.add(x[:8] + 0.001)
    assert two._coarse_stale
    _, ids = two.search(x[0] + 0.001, 1, probes=16)
    assert ids[0] in (new_g[0], gt_ids[0])

    # tombstones never surface through the two-stage path
    two.remove(gt_ids[:32])
    two.remove(new_g)
    _, ids = two.search(x[:16], 1, probes=16)
    assert not set(ids[:, 0].tolist()) & set(gt_ids[:32].tolist())


def test_sharded_ivf_two_stage_persist(tmp_path):
    d = 64
    x = _data(5000, d, seed=10)
    idx = ShardedIvfIndex(
        IndexParams(dimensions=d, space="cosine", dtype="int8"),
        n_devices=8,
        cluster_min=4000,
        coarse=True,
    )
    idx.add(x)
    p = str(tmp_path / "sh_ivf4.npz")
    idx.save(p)
    back = ShardedIvfIndex.load(p, n_devices=8)
    assert back.coarse and back._coarse_stale
    q = x[50:82]
    d1, i1 = idx.search(q, 5, probes=16)
    d2, i2 = back.search(q, 5, probes=16)
    assert (np.asarray(i1) == np.asarray(i2)).all()
