"""IVF bucketed backend tests — core/ivf.py mechanics + engine kind.

Small cluster_min forces the staging→clustered transition at test scale.
"""

import numpy as np
import pytest

from vector_store_tpu.core.ivf import IvfIndex
from vector_store_tpu.types import IndexParams


def _clustered(n, d, seed=0, n_clusters=64):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n_clusters, d)).astype(np.float32)
    return centers[rng.integers(0, n_clusters, n)] + 0.3 * rng.normal(
        size=(n, d)
    ).astype(np.float32)


def _recall(ids, exact):
    q, k = exact.shape
    return np.mean(
        [len(set(ids[i][:k]) & set(exact[i])) / k for i in range(q)]
    )


def test_staging_phase_exact():
    """Before clustering, IVF serves exact scans over sequential buckets."""
    d = 24
    x = _clustered(500, d, seed=1)
    idx = IvfIndex(IndexParams(dimensions=d, space="cosine"), cluster_min=10_000)
    ids = idx.add(x)
    assert idx.count() == 500 and not idx._clustered
    assert (ids == np.arange(500)).all()
    dist, got = idx.search(x[:16], 1)
    assert (got[:, 0] == np.arange(16)).all()
    # remove works in staging
    idx.remove(ids[:3])
    assert idx.count() == 497
    _, got = idx.search(x[0], 1)
    assert got[0] != 0


def test_staging_add_survives_bucket_growth():
    """One add() larger than the initial K*B bank must not overwrite
    rows placed before the mid-add _grow_bucket() (the
    flat-cursor placement remapped occupied slots after B doubled,
    silently losing ~28% of a 300K-row bulk add)."""
    d = 8
    n = 300_000
    rng = np.random.default_rng(11)
    x = rng.normal(size=(n, d)).astype(np.float32)
    idx = IvfIndex(
        IndexParams(dimensions=d, space="l2"), initial_capacity=0, cluster_min=4_000
    )
    assert idx.n_clusters * idx.state.bucket < n  # growth WILL happen mid-add
    idx.cluster_min = 10**9  # keep the staging path under test (no recluster)
    ids = idx.add(x)
    assert idx.count() == n
    live = idx._rowid_h[idx._valid_h]
    assert len(live) == n  # no slot was overwritten
    assert len(np.unique(live)) == n
    # overwritten rows also stale _loc: removing must still be exact
    idx.remove(ids[:100])
    assert idx.count() == n - 100
    d_, i_ = idx.exact_search(x[100:108], 1)
    assert (i_[:, 0] == np.arange(100, 108)).all()


@pytest.fixture(scope="module")
def clustered_ivf():
    d = 32
    x = _clustered(12_000, d, seed=2)
    idx = IvfIndex(
        IndexParams(dimensions=d, space="cosine"),
        cluster_min=4_000,
        probes=16,
    )
    idx.add(x)
    return idx, x


def test_clustered_recall(clustered_ivf):
    idx, x = clustered_ivf
    assert idx._clustered
    rng = np.random.default_rng(5)
    qi = rng.choice(len(x), 128, replace=False)
    q = x[qi] + 0.1 * rng.normal(size=(128, x.shape[1])).astype(np.float32)
    _, exact = idx.exact_search(q, 10)
    _, got = idx.search(q, 10)
    assert _recall(got, exact) >= 0.9


def test_two_stage_xla_recall():
    """Single-device two-stage scan (int4 coarse + int8 rescore) through
    IvfIndex.search must track the plain int8 probe-scan's recall (the
    sharded twin is in test_sharded_ivf)."""
    d, n = 64, 9_000
    x = _clustered(n, d, seed=11)

    def build(coarse):
        idx = IvfIndex(
            IndexParams(dimensions=d, space="cosine", dtype="int8"),
            cluster_min=4_000,
            coarse=coarse,
            rescore=16,  # D=64: int4 rank noise ~1/sqrt(D) wants 16x
        )
        idx.add(x)
        assert idx._clustered
        return idx

    one, two = build(False), build(True)
    assert two.coarse
    rng = np.random.default_rng(3)
    qi = rng.choice(n, 64, replace=False)
    q = x[qi] + 0.05 * rng.normal(size=(64, d)).astype(np.float32)
    _, exact = one.exact_search(q, 10)
    _, got1 = one.search(q, 10, probes=16)
    _, got2 = two.search(q, 10, probes=16)
    assert not two._coarse_stale  # the search derived + cached the bank
    r1, r2 = _recall(got1, exact), _recall(got2, exact)
    assert r2 >= r1 - 0.05 and r2 >= 0.85, (r1, r2)


def test_large_k_routes_to_xla_path(clustered_ivf):
    """A large k (50, past any serving k) returns exact-consistent
    results: the query row first, distances ascending."""
    idx, x = clustered_ivf
    k = 50
    rng = np.random.default_rng(6)
    qi = rng.choice(len(x), 16, replace=False)
    dist, got = idx.search(x[qi], k, probes=32)
    assert got.shape == (16, k)
    # top-1 must be the query row itself; distances ascending
    assert (got[:, 0] == qi).all()
    finite = np.isfinite(dist)
    assert (np.diff(np.where(finite, dist, np.inf), axis=1) >= -1e-6).all()


def test_ids_stable_across_recluster(clustered_ivf):
    """Reclustering (and compact) must never invalidate issued ids."""
    idx, x = clustered_ivf
    probe = x[:8]
    _, before = idx.search(probe, 1)
    idx.compact(full=True)  # full recluster
    _, after = idx.search(probe, 1)
    assert (before == after).all()
    # ids survive growth + further adds too
    rng = np.random.default_rng(9)
    new = (5.0 + rng.random((4, x.shape[1]))).astype(np.float32)
    nid = idx.add(new)
    _, got = idx.search(new, 1)
    assert (got[:, 0] == nid).all()
    _, again = idx.search(probe, 1)
    assert (again == before).all()


def test_remove_and_tombstones(clustered_ivf):
    idx, x = clustered_ivf
    n0 = idx.count()
    _, top = idx.search(x[100], 1)
    victim = top[0]
    idx.remove([victim])
    assert idx.count() == n0 - 1
    _, got = idx.search(x[100], 5)
    assert victim not in got
    # double-remove and unknown ids are no-ops
    idx.remove([victim, 10**9, -5])
    assert idx.count() == n0 - 1
    # compact drops tombstones, ids unchanged
    idx.compact()
    assert idx.count() == n0 - 1
    _, got = idx.search(x[100], 5)
    assert victim not in got


def test_bucket_overflow_spills_and_grows():
    """Hammer one region so buckets overflow: spill + growth keep all rows."""
    d = 16
    rng = np.random.default_rng(3)
    base = _clustered(5000, d, seed=4)
    idx = IvfIndex(IndexParams(dimensions=d, space="cosine"), cluster_min=2_000)
    idx.add(base)
    assert idx._clustered
    # 4000 near-duplicates of one point — far more than any bucket holds
    hot = base[7] + 0.01 * rng.normal(size=(4000, d)).astype(np.float32)
    ids = idx.add(hot)
    assert idx.count() == 9000
    _, got = idx.search(hot[:32], 1)
    d0, _ = idx.search(hot[:32], 1)
    assert np.isfinite(d0).all()
    # every hot row findable (its own nearest within the dup cloud is fine)
    assert set(got[:, 0]).issubset(set(ids.tolist()) | {7})


@pytest.mark.asyncio
async def test_ivf_kind_over_http():
    """kind=ivf serves the same ANN REST surface."""
    import asyncio

    from aiohttp.test_utils import TestClient, TestServer

    from vector_store_tpu import new_index_factory
    from vector_store_tpu.api.routes import build_app
    from vector_store_tpu.engine.engine import new_engine

    engine = await new_engine(new_index_factory())
    c = TestClient(TestServer(build_app(engine)))
    await c.start_server()
    try:
        r = await c.put(
            "/api/v1/indexes/ks/iv",
            json={"dimensions": 8, "kind": "ivf", "key_columns": ["id"]},
        )
        assert r.status == 200
        for i in range(32):
            v = np.zeros(8)
            v[i % 8] = 1.0 + i / 64
            r = await c.post(
                "/api/v1/indexes/ks/iv/add",
                json={"primary_key": [i], "embedding": v.tolist()},
            )
            assert r.status == 200
        async with asyncio.timeout(60):
            while await (await c.get("/api/v1/indexes/ks/iv/count")).json() != 32:
                await asyncio.sleep(0)
        r = await c.post(
            "/api/v1/indexes/ks/iv/ann",
            json={"embedding": [1.0, 0, 0, 0, 0, 0, 0, 0], "limit": 2},
        )
        body = await r.json()
        assert r.status == 200 and len(body["distances"]) == 2
        r = await c.post(
            "/api/v1/indexes/ks/iv/compact", json={}
        )
        assert (await r.json())["count"] == 32
    finally:
        await c.close()
        await engine.close()


def test_incremental_compact_recovers_spill_recall():
    """compact() after churn (live count flat) runs the INCREMENTAL pass:
    only spilled rows move, centroids stay, ids stay, and recall at the
    same probe count does not regress (the full
    Lloyd+assign+permute compact cost minutes inline in the bench)."""
    d = 16
    x = _clustered(8_000, d, seed=21)
    idx = IvfIndex(IndexParams(dimensions=d, space="cosine"), cluster_min=4_000)
    ids = idx.add(x)
    assert idx._clustered
    anchor_ids = ids[:8]
    _, anchor_before = idx.search(x[:8], 1)
    rng = np.random.default_rng(5)
    kill = rng.choice(len(ids), 2_400, replace=False)
    idx.remove(ids[kill])
    # near-duplicate reinserts oversubscribe hot clusters → spills
    fresh = x[kill] + 0.05 * rng.normal(size=(2_400, d)).astype(np.float32)
    idx.add(fresh)
    assert idx.count() == 8_000
    q = fresh[:128] + 0.02 * rng.normal(size=(128, d)).astype(np.float32)
    _, gt = idx.exact_search(q, 10)
    _, before = idx.search(q, 10, probes=8)
    rec_before = _recall(before, gt)
    clustered_at = idx._clustered_at
    remap = idx.compact()  # auto: live count flat → incremental
    assert remap == {}
    assert idx._clustered_at == clustered_at  # no full recluster ran
    assert idx.count() == 8_000
    _, gt2 = idx.exact_search(q, 10)
    _, after = idx.search(q, 10, probes=8)
    assert _recall(after, gt2) >= rec_before - 1e-9
    # issued ids still resolve after the moves
    _, anchor_after = idx.search(x[:8], 1)
    surviving = ~np.isin(anchor_ids, ids[kill])
    assert (anchor_after[surviving] == anchor_before[surviving]).all()


def test_churn_reuses_tombstoned_slots():
    """Delete/reinsert churn must NOT grow buckets: freed positions are
    reused by later inserts (round-2: leaked slots forced bucket-doubling
    bank reallocations at flat live count)."""
    d = 16
    x = _clustered(6_000, d, seed=11)
    idx = IvfIndex(
        IndexParams(dimensions=d, space="cosine"), cluster_min=4_000
    )
    ids = idx.add(x)
    assert idx._clustered
    bucket0 = idx.state.bucket
    rng = np.random.default_rng(3)
    live = list(ids)
    for round_ in range(6):
        kill_idx = rng.choice(len(live), 900, replace=False)
        kill = np.asarray([live[i] for i in kill_idx])
        idx.remove(kill)
        keep = set(live) - set(kill.tolist())
        fresh = _clustered(900, d, seed=100 + round_)
        new_ids = idx.add(fresh)
        live = list(keep) + list(new_ids)
        assert idx.count() == len(live)
    # reclusters may legitimately resize; churn alone must not
    assert idx.state.bucket == bucket0, (
        f"bucket grew {bucket0} -> {idx.state.bucket} under flat churn"
    )
    # spot-check correctness after heavy reuse: fresh rows are findable
    _, got = idx.search(fresh[:32], 1)
    assert (got[:, 0] == new_ids[:32]).all()


def test_host_staged_recluster_equivalent(monkeypatch):
    """When two banks won't fit HBM, the recluster permutes through host
    RAM — results must be identical to the device permute path."""
    from vector_store_tpu.core import ivf as ivf_mod

    d = 16
    x = _clustered(6_000, d, seed=21)
    q = x[64:96]

    def build(host_staged):
        if host_staged:
            monkeypatch.setattr(ivf_mod, "HOST_PERMUTE_SHARE", 0)
        else:
            monkeypatch.setattr(ivf_mod, "HOST_PERMUTE_SHARE", 1.0)
        idx = IvfIndex(
            IndexParams(dimensions=d, space="cosine", dtype="int8"),
            cluster_min=4_000,
        )
        ids = idx.add(x)
        idx.remove(ids[:100])
        idx.compact(full=True)
        return idx

    a, b = build(False), build(True)
    assert a.count() == b.count() == 5_900
    da, ia = a.search(q, 5)
    db, ib = b.search(q, 5)
    assert (ia == ib).all()
    np.testing.assert_allclose(da, db, rtol=1e-5, atol=1e-6)


def test_ivf_persist_roundtrip(tmp_path):
    """save/load preserves search results, ids, free lists and counts."""
    d = 16
    x = _clustered(6_000, d, seed=31)
    idx = IvfIndex(
        IndexParams(dimensions=d, space="cosine", dtype="int8"),
        cluster_min=4_000,
    )
    ids = idx.add(x)
    idx.remove(ids[100:200])
    path = str(tmp_path / "ivf.npz")
    idx.save(path)
    idx2 = IvfIndex.load(path)
    assert idx2.count() == idx.count() == 5_900
    q = x[500:532]
    d1, i1 = idx.search(q, 5)
    d2, i2 = idx2.search(q, 5)
    assert (i1 == i2).all()
    np.testing.assert_allclose(d1, d2, rtol=1e-5, atol=1e-6)
    # restored index keeps ingesting (free lists intact: removed slots
    # get reused, so the bucket width must not grow)
    b0 = idx2.state.bucket
    more = idx2.add(x[:100])
    assert idx2.count() == 6_000 and idx2.state.bucket == b0
    _, got = idx2.search(x[:4], 1)
    assert set(got[:, 0]).issubset(set(more.tolist()) | set(ids.tolist()))


def test_reserve_rows_single_recluster():
    """Bulk-load mode: ONE recluster sized for the reservation, and no
    further reclusters until the live count overshoots it."""
    from vector_store_tpu.core.ivf import IvfIndex, k_for

    rng = np.random.default_rng(5)
    n, d = 3000, 32
    idx = IvfIndex(
        IndexParams(dimensions=d, space="cosine", dtype="int8"),
        cluster_min=512,
        reserve_rows=n,
        initial_capacity=n,
    )
    reclusters = []
    orig = IvfIndex._recluster_locked

    def spy(self):
        reclusters.append(self._n_live)
        return orig(self)

    IvfIndex._recluster_locked = spy
    try:
        for off in range(0, n, 500):
            idx.add(rng.normal(size=(500, d)).astype(np.float32))
    finally:
        IvfIndex._recluster_locked = orig
    assert len(reclusters) == 1, reclusters  # one, at cluster_min
    assert idx._clustered
    assert idx.state.n_clusters == k_for(n)  # sized for the reservation
    # queries still work and find self
    q = rng.normal(size=(4, d)).astype(np.float32)
    sl = idx.add(q)
    d_, i_ = idx.search(q, 1, probes=idx.n_clusters)
    assert (i_[:, 0] == sl).all()


def test_remove_batch_message_tombstones():
    """RemoveBatch through the actor == N Removes (one device step)."""
    import asyncio

    from vector_store_tpu.engine.ann_index import AnnIndexFactory
    from vector_store_tpu.types import IndexId, IndexMetadata

    async def run():
        rng = np.random.default_rng(6)
        meta = IndexMetadata(
            index_id=IndexId("ks.rb"),
            params=IndexParams(dimensions=16, space="cosine"),
            version="v1",
            key_columns=("id",),
        )
        h = AnnIndexFactory(backend="ivf").create_index(meta.index_id, meta)
        x = rng.normal(size=(40, 16)).astype(np.float32)
        await h.add_or_replace_batch([((j,), x[j]) for j in range(40)])
        assert await h.count() == 40
        await h.remove_batch([(j,) for j in range(0, 40, 2)])
        # removals are fire-and-forget: count() rides the same mailbox,
        # so by the time it answers the tombstones are applied
        assert await h.count() == 20
        h.close()
        await h.join()

    asyncio.run(run())


def test_overflow_places_instead_of_growing(monkeypatch):
    """When bucket-doubling is HBM-capped, cluster overflow lands in
    other clusters' free slots (dirty-marked) instead of growing."""
    from vector_store_tpu.core import ivf as ivf_mod
    from vector_store_tpu.core.ivf import IvfIndex

    monkeypatch.setattr(ivf_mod, "GROW_SHARE", 0)  # never grow
    rng = np.random.default_rng(9)
    d = 16
    idx = IvfIndex(
        IndexParams(dimensions=d, space="cosine"),
        cluster_min=256,
        initial_capacity=256,
        # suppress the doubling recluster (it would legitimately
        # re-home the overflow and clear the dirty set)
        reserve_rows=4096,
    )
    base = rng.normal(size=(256, d)).astype(np.float32)
    idx.add(base)
    assert idx._clustered
    b0 = idx.state.bucket
    # hammer ONE point: every new row wants the same cluster
    hot = np.tile(base[:1], (b0 * 3, 1)) + 0.001 * rng.normal(
        size=(b0 * 3, d)
    ).astype(np.float32)
    idx.add(hot)
    assert idx.state.bucket == b0  # no growth
    assert idx.count() == 256 + b0 * 3
    assert idx._dirty  # overflow targets marked for incremental compact
    # every row is still findable at full probes
    d_, i_ = idx.search(hot[:4], 1, probes=idx.n_clusters)
    assert (i_[:, 0] >= 0).all()
