"""IVF probe-scan kernel (core/ivf_pallas.py) against numpy, in the
Pallas interpreter, plus the Triton lowering and the path choice.

The compiled kernel runs only on a GPU; tests/test_gpu.py checks it
there at real widths.
"""

import functools

import numpy as np
import pytest

from vector_store_tpu.core.ivf import IvfIndex
from vector_store_tpu.types import IndexParams


def _clustered(n, d, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(64, d)).astype(np.float32)
    return centers[rng.integers(0, 64, n)] + 0.3 * rng.normal(
        size=(n, d)
    ).astype(np.float32)


def _pool_reference(vectors, scales, rid_masked, nlive, q, cids, space):
    """float64 numpy twin of probe_scan: [Q, p*B] distances, +inf past
    each bucket's live bound and on SENTINEL rowids."""
    from vector_store_tpu.core.ivf_pallas import SENTINEL

    vec = np.asarray(vectors).astype(np.float64)
    vec = vec * np.asarray(scales, np.float64)[..., None]
    Q, p = cids.shape
    B = vec.shape[1]
    out = np.full((Q, p * B), np.inf)
    for i in range(Q):
        for r in range(p):
            c = int(cids[i, r])
            x = vec[c]
            qv = np.asarray(q[i], np.float64)
            if space == "l2":
                d = ((x - qv) ** 2).sum(-1)
            elif space == "dot":
                d = -(x @ qv)
            else:
                d = 1.0 - x @ qv
            ok = (np.arange(B) < nlive[c]) & (rid_masked[c] != SENTINEL)
            out[i, r * B : (r + 1) * B] = np.where(ok, d, np.inf)
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("space", ["cosine", "l2", "dot"])
def test_probe_scan_matches_numpy(space, dtype):
    """Interpreted kernel ≡ the numpy pool on a bank with a D that is not
    a power of two (masked chunk), partly filled and tombstoned
    buckets."""
    import jax.numpy as jnp

    from vector_store_tpu.core import distance as dist_mod
    from vector_store_tpu.core.ivf_pallas import SENTINEL, live_rows, probe_scan
    from vector_store_tpu.core.quantize import quantize_rows

    rng = np.random.default_rng(7)
    K, B, D, Q, p = 6, 128, 96, 3, 4
    raw = dist_mod.preprocess(
        jnp.asarray(rng.normal(size=(K * B, D)).astype(np.float32)), space
    )
    if dtype == "int8":
        rows, scl = quantize_rows(raw)
        vectors, scales = rows.reshape(K, B, D), scl.reshape(K, B)
    else:
        vectors = raw.astype(jnp.dtype(dtype)).reshape(K, B, D)
        scales = jnp.ones((K, B), jnp.float32)
    valid = np.zeros((K, B), bool)
    for c, n in enumerate([128, 70, 0, 1, 64, 100]):
        valid[c, :n] = True
    valid[1, 5:9] = False  # tombstones inside the live prefix
    rowid = np.arange(K * B, dtype=np.int32).reshape(K, B)
    rid_masked = np.where(valid, rowid, SENTINEL).astype(np.int32)
    nlive = np.asarray(live_rows(jnp.asarray(valid)))
    q = np.asarray(
        dist_mod.preprocess(
            jnp.asarray(rng.normal(size=(Q, D)).astype(np.float32)), space
        )
    )
    cids = rng.integers(0, K, (Q, p)).astype(np.int32)
    got = np.asarray(
        probe_scan(
            vectors,
            scales,
            jnp.asarray(rid_masked),
            jnp.asarray(nlive),
            jnp.asarray(q),
            jnp.asarray(cids),
            space,
            interpret=True,
        )
    )
    want = _pool_reference(
        np.asarray(vectors.astype(jnp.float32)),
        np.asarray(scales),
        rid_masked,
        nlive,
        q,
        cids,
        space,
    )
    assert got.shape == (Q, p * B)
    assert (np.isinf(got) == np.isinf(want)).all()
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-4, atol=1e-4)


def test_live_rows_semantics():
    """live_rows = last live slot + 1 per cluster, 0 for empty buckets —
    the kernel never reads past it."""
    import jax.numpy as jnp

    from vector_store_tpu.core.ivf_pallas import live_rows

    valid = np.zeros((4, 512), bool)
    valid[0, :10] = True
    valid[1, 200] = True  # lone live row at 200
    valid[2, :512] = True
    # bucket 3 stays empty
    assert np.asarray(live_rows(jnp.asarray(valid))).tolist() == [10, 201, 512, 0]


@pytest.mark.parametrize("dims", [768, 96])
def test_probe_scan_lowers_to_triton(dims):
    """The kernel lowers through the Triton route for a CUDA target
    (lowering needs no card; compiling to PTX happens on the GPU)."""
    import jax
    import jax.numpy as jnp

    from vector_store_tpu.core.ivf import init, search_clustered_kernel

    st = init(dims, 128, 256, "int8")
    q = jnp.zeros((8, dims), jnp.float32)
    lowered = (
        jax.jit(search_clustered_kernel, static_argnums=(2, 3, 4))
        .trace(st, q, "cosine", 10, 16)
        .lower(lowering_platforms=("cuda",))
    )
    text = lowered.as_text()
    assert "ivf_probe_scan" in text and "triton" in text.lower()


@pytest.mark.parametrize(
    "platform,kernel", [("gpu", True), ("cpu", False)]
)
def test_scan_path_chosen_by_platform(platform, kernel):
    from vector_store_tpu.core.ivf import scan_kernel_for

    assert scan_kernel_for(platform) is kernel


@pytest.mark.parametrize("space", ["cosine", "l2"])
def test_kernel_search_matches_xla(monkeypatch, space):
    """IvfIndex.search on the kernel path (interpreted) returns what the
    XLA scan returns: same ids, same distances."""
    from vector_store_tpu.core import ivf as ivf_mod

    d = 48
    x = _clustered(6000, d, seed=5)
    idx = IvfIndex(IndexParams(dimensions=d, space=space), cluster_min=4000)
    ids = idx.add(x)
    idx.remove(ids[:40])  # tombstones must never surface
    assert idx._clustered and not idx._kernel  # CPU: XLA path by default
    q = x[40:56]
    d_x, r_x = idx.search(q, 10, probes=8)
    monkeypatch.setattr(
        ivf_mod,
        "search_clustered_kernel",
        functools.partial(ivf_mod.search_clustered_kernel, interpret=True),
    )
    idx._kernel = True
    d_k, r_k = idx.search(q, 10, probes=8)
    assert (r_k == r_x).all()
    np.testing.assert_allclose(d_k, d_x, rtol=1e-4, atol=1e-4)
    assert not set(r_k.ravel().tolist()) & set(ids[:40].tolist())
