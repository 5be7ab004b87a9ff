"""Device paths against plain numpy references.

Each test runs twice: on the CPU at a small size, and — marked `gpu`,
skipped without a card — on the GPU at real widths (768-d), where XLA's
GPU code and the compiled Triton kernel run.  chip_smoke.py runs the
`gpu` cases on the card.
"""

import numpy as np
import pytest

from vector_store_tpu.types import IndexParams

CARD = pytest.param(True, marks=pytest.mark.gpu, id="gpu")
HOST = pytest.param(False, id="cpu")


def _clustered(n, d, seed=0, n_clusters=64):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n_clusters, d)).astype(np.float32)
    return centers[rng.integers(0, n_clusters, n)] + 0.3 * rng.normal(
        size=(n, d)
    ).astype(np.float32)


def _cosine64(q, x):
    q = q.astype(np.float64)
    x = x.astype(np.float64)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    x /= np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), 1e-30)
    return 1.0 - q @ x.T


@pytest.fixture
def device_or_host(request):
    """True on the card (via the `gpu` fixture, which skips without one)."""
    if request.param:
        request.getfixturevalue("gpu")
    return request.param


@pytest.mark.parametrize("device_or_host", [HOST, CARD], indirect=True)
def test_exact_scan_matches_numpy(device_or_host):
    """bruteforce.search (approx=False) top-10 ids ≡ float64 numpy top-10
    on a float32 bank; on the card the f32 products may run in TF32."""
    import jax.numpy as jnp

    from vector_store_tpu.core import bruteforce
    from vector_store_tpu.core import distance as dist_mod

    n, d = (200_000, 768) if device_or_host else (5_000, 48)
    x = _clustered(n, d, seed=1)
    rng = np.random.default_rng(2)
    q = x[rng.choice(n, 64, replace=False)] + 0.2 * rng.normal(
        size=(64, d)
    ).astype(np.float32)
    bank = dist_mod.preprocess(jnp.asarray(x), "cosine")
    qp = dist_mod.preprocess(jnp.asarray(q), "cosine")
    dist, ids = bruteforce.search(
        qp, bank, jnp.ones((n,), bool), "cosine", 10, approx=False
    )
    ref = _cosine64(q, x)
    truth = np.argsort(ref, axis=1)[:, :10]
    ids, dist = np.asarray(ids), np.asarray(dist)
    recall = np.mean([len(set(ids[i]) & set(truth[i])) / 10 for i in range(64)])
    assert recall >= 0.99, recall
    got = np.take_along_axis(ref, ids, axis=1)
    np.testing.assert_allclose(dist, got, atol=1e-2 if device_or_host else 1e-5)


def _expand_reference(state, cfg, q, pool):
    """float64 numpy twin of search._expand_round (merge_pool_fast):
    returns {id: (dist, expanded)} of the merged pool's finite entries
    and the P-th smallest candidate distance (the pool boundary)."""
    vec = np.asarray(state.vectors).astype(np.float64)
    if cfg.quantized:
        vec = vec * np.asarray(state.scales, np.float64)[:, None]
    nbr = np.asarray(state.neighbors)
    C, P, Bw = vec.shape[0], pool[0].shape[1], cfg.beam_width
    pd, pi, pe = (np.asarray(a) for a in pool)
    out, bounds = [], []
    for j in range(pd.shape[0]):
        frontier = np.where(pe[j], np.inf, pd[j])
        sel = np.argsort(frontier, kind="stable")[:Bw]
        live = np.isfinite(frontier[sel])
        entries = {
            int(i): (float(dd), bool(e))
            for i, dd, e in zip(pi[j], pd[j], pe[j])
            if np.isfinite(dd)
        }
        for s in sel[live]:
            entries[int(pi[j][s])] = (float(pd[j][s]), True)
        cand = nbr[pi[j][sel[live]]].reshape(-1)
        cand = np.unique(cand[cand < C])
        qv = np.asarray(q[j], np.float64)
        for c in cand:
            if int(c) in entries:
                continue
            if cfg.space == "l2":
                dist = float(((vec[c] - qv) ** 2).sum())
            else:
                dist = 1.0 - float(vec[c] @ qv)
            entries[int(c)] = (dist, False)
        ranked = sorted(entries.items(), key=lambda kv: kv[1][0])
        bounds.append(ranked[P - 1][1][0] if len(ranked) >= P else np.inf)
        out.append(dict(ranked[:P]))
    return out, bounds


@pytest.mark.parametrize("device_or_host", [HOST, CARD], indirect=True)
def test_graph_expand_round_matches_numpy(device_or_host):
    """Three expand rounds of the graph beam search, each from the
    device's previous pool, against the numpy twin: same pool ids (up
    to ties at the pool boundary), same distances, same expanded
    flags."""
    import jax
    import jax.numpy as jnp

    from vector_store_tpu.core import SlotIndex
    from vector_store_tpu.core import distance as dist_mod
    from vector_store_tpu.core import search as search_mod

    n, d = (16_384, 768) if device_or_host else (3_000, 32)
    tol = 1e-2 if device_or_host else 1e-4
    x = _clustered(n, d, seed=3)
    idx = SlotIndex(IndexParams(dimensions=d), initial_capacity=n)
    idx.add(x)
    cfg, st = idx.cfg, idx.state
    rng = np.random.default_rng(4)
    q = x[rng.choice(n, 32, replace=False)] + 0.1 * rng.normal(
        size=(32, d)
    ).astype(np.float32)
    qp = dist_mod.preprocess(jnp.asarray(q), cfg.space).astype(cfg.compute_dtype)
    pool = jax.jit(search_mod._init_pool, static_argnums=(2,))(st, qp, cfg)
    step = jax.jit(search_mod._expand_round, static_argnums=(2,))
    q64 = np.asarray(qp, np.float64)
    for _ in range(3):
        want, bounds = _expand_reference(st, cfg, q64, pool)
        pool = step(st, qp, cfg, pool)
        pd, pi, pe = (np.asarray(a) for a in pool)
        for j in range(len(q)):
            fin = np.isfinite(pd[j])
            assert (np.diff(pd[j][fin]) >= 0).all()
            got = {
                int(i): (float(dd), bool(e))
                for i, dd, e in zip(pi[j], pd[j], pe[j])
                if np.isfinite(dd)
            }
            for i in set(got) ^ set(want[j]):
                dd = got[i][0] if i in got else want[j][i][0]
                assert abs(dd - bounds[j]) <= 2 * tol, (j, i, dd, bounds[j])
            for i in set(got) & set(want[j]):
                assert abs(got[i][0] - want[j][i][0]) <= tol
                assert got[i][1] == want[j][i][1], (j, i)


def _pool64(st, q, cids, nlive, rid_masked):
    from vector_store_tpu.core.ivf_pallas import SENTINEL

    B = st.bucket
    out = np.full((len(q), cids.shape[1] * B), np.inf)
    for i in range(len(q)):
        for r, c in enumerate(cids[i]):
            x = np.asarray(st.vectors[int(c)]).astype(np.float64)
            x *= np.asarray(st.scales[int(c)], np.float64)[:, None]
            ok = (np.arange(B) < nlive[c]) & (rid_masked[c] != SENTINEL)
            out[i, r * B : (r + 1) * B] = np.where(ok, 1.0 - x @ q[i], np.inf)
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,dims", [("int8", 768), ("float32", 96)])
def test_probe_scan_compiled_matches_numpy(gpu, dtype, dims):
    """The compiled Triton probe-scan's [Q, p·B] pool ≡ float64 numpy
    over the same probed blocks, at a real width and at a width that is
    not a power of two."""
    import jax.numpy as jnp

    from vector_store_tpu.core import distance as dist_mod
    from vector_store_tpu.core.ivf import IvfIndex, _route
    from vector_store_tpu.core.ivf_pallas import SENTINEL, live_rows, probe_scan

    x = _clustered(70_000, dims, seed=5, n_clusters=512)
    idx = IvfIndex(IndexParams(dimensions=dims, space="cosine", dtype=dtype))
    ids = idx.add(x)
    idx.remove(ids[::97])
    assert idx._clustered and idx._kernel
    st = idx.state
    q = jnp.asarray(x[:16])
    _, cids, _ = _route(st, q, "cosine", 16)
    qf = dist_mod.preprocess(q, "cosine")
    rid_masked = jnp.where(st.valid, st.rowid, SENTINEL)
    nlive = live_rows(st.valid)
    got = np.asarray(
        probe_scan(st.vectors, st.scales, rid_masked, nlive, qf, cids, "cosine")
    )
    want = _pool64(
        st,
        np.asarray(qf, np.float64),
        np.asarray(cids),
        np.asarray(nlive),
        np.asarray(rid_masked),
    )
    assert (np.isinf(got) == np.isinf(want)).all()
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], atol=1e-4)


@pytest.mark.gpu
def test_ivf_search_paths_agree_on_card(gpu):
    """IvfIndex.search through the kernel and through the XLA scan: same
    top-1 and near-identical top-10 (the XLA path scores in bf16, the
    kernel in f32)."""
    x = _clustered(100_000, 768, seed=6, n_clusters=1024)
    from vector_store_tpu.core.ivf import IvfIndex

    idx = IvfIndex(IndexParams(dimensions=768, space="cosine", dtype="int8"))
    idx.add(x)
    noise = np.random.default_rng(7).normal(size=(128, 768)).astype(np.float32)
    q = x[:128] + 0.05 * noise
    d_k, r_k = idx.search(q, 10)
    idx._kernel = False
    d_x, r_x = idx.search(q, 10)
    assert (r_k[:, 0] == r_x[:, 0]).mean() >= 0.97
    overlap = np.mean([len(set(r_k[i]) & set(r_x[i])) / 10 for i in range(128)])
    assert overlap >= 0.95, overlap
    np.testing.assert_allclose(d_k, d_x, atol=2e-2)
