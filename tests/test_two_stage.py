"""Two-stage IVF scan: int4 coarse probe + int8 exact rescore.

The coarse bank (core/quantize.py pack_int4_from_int8) is a DERIVED
cache of the int8 bank — these tests pin the pack/unpack algebra, the
recall contract of the two-stage search (search must stay within a
whisker of the single-stage int8 scan after the rescore), and the
cache-invalidation protocol
(dirty clusters after inserts, full staleness after recluster/growth).
"""

import numpy as np
import pytest

from vector_store_tpu.core.ivf import IvfIndex, derive_coarse
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


def test_int4_pack_roundtrip():
    """Split-layout nibble packing: unpack(pack(q8)) == round(q8*7/127)."""
    import jax.numpy as jnp

    from vector_store_tpu.core.quantize import (
        pack_int4_from_int8,
        unpack_int4,
    )

    rng = np.random.default_rng(7)
    q8 = rng.integers(-127, 128, size=(33, 64), dtype=np.int8)
    packed = pack_int4_from_int8(jnp.asarray(q8))
    assert packed.shape == (33, 32) and packed.dtype == jnp.uint8
    got = np.asarray(unpack_int4(packed))
    want = np.clip(np.round(q8.astype(np.float64) * 7.0 / 127.0), -7, 7)
    np.testing.assert_array_equal(got, want.astype(np.int8))


@pytest.mark.parametrize("space", ["cosine", "l2"])
def test_two_stage_recall_close_to_single_stage(space):
    """Recall through the coarse tier must track the plain int8 scan —
    the 4x-overfetch rescore absorbs int4 rank noise."""
    d = 64
    x = _clustered(8000, d, seed=5)
    q = x[:64] + 0.05 * np.random.default_rng(9).normal(size=(64, d)).astype(
        np.float32
    )
    base = IvfIndex(
        IndexParams(dimensions=d, space=space, dtype="int8"),
        cluster_min=4000,
        coarse=False,
    )
    two = IvfIndex(
        IndexParams(dimensions=d, space=space, dtype="int8"),
        cluster_min=4000,
        coarse=True,
        rescore=16,  # int4 noise ~1/sqrt(D): D=64 needs 16x overfetch
    )
    base.add(x)
    two.add(x)
    assert two.coarse and two._clustered
    exact_d, exact_i = base.exact_search(q, 10)
    _, ids_base = base.search(q, 10, probes=16)
    _, ids_two = two.search(q, 10, probes=16)
    r_base = _recall(ids_base, exact_i)
    r_two = _recall(ids_two, exact_i)
    assert r_two >= r_base - 0.02, (r_two, r_base)
    assert r_two >= 0.9


def test_coarse_cache_tracks_mutations():
    """Incremental dirty-cluster repack after inserts must equal a fresh
    full derive; recluster/growth invalidate wholesale."""
    d = 64
    x = _clustered(6000, d, seed=11)
    idx = IvfIndex(
        IndexParams(dimensions=d, space="cosine", dtype="int8"),
        cluster_min=4000,
        coarse=True,
    )
    idx.add(x[:5000])
    idx._refresh_coarse_locked()  # derive now; later adds go dirty path
    assert not idx._coarse_stale
    idx.add(x[5000:5200])  # clustered inserts → per-cluster dirty set
    assert idx._coarse_dirty
    got = np.asarray(idx._refresh_coarse_locked())
    want = np.asarray(derive_coarse(idx.state.vectors))
    np.testing.assert_array_equal(got, want)
    assert not idx._coarse_dirty

    # searches through the incremental cache still find the new rows
    _, ids = idx.search(x[5100], 1, probes=16)
    assert ids[0] == 5100


def test_two_stage_save_load_roundtrip(tmp_path):
    d = 64
    x = _clustered(5000, d, seed=13)
    idx = IvfIndex(
        IndexParams(dimensions=d, space="cosine", dtype="int8"),
        cluster_min=4000,
        coarse=True,
    )
    idx.add(x)
    p = str(tmp_path / "ivf4.npz")
    idx.save(p)
    back = IvfIndex.load(p)
    assert back.coarse and back._coarse_stale
    _, a = idx.search(x[:8], 5, probes=16)
    _, b = back.search(x[:8], 5, probes=16)
    np.testing.assert_array_equal(a, b)
