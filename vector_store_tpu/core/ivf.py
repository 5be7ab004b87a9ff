"""IVF bucketed backend — cluster-partitioned storage, scanned in blocks.

The graph index (core/graph.py) replaces usearch's pointer-chasing HNSW
traversal (reference: src/index/usearch.rs:274-277) with batched gathers,
whose cost is one row fetch per visited node.  This backend removes them
from the hot path at the 1M-100M scale:

  storage is bucketed by k-means cluster: vectors[K, B, D].  A probed
  cluster is one CONTIGUOUS block, so candidate fetch is a block read
  (p blocks of B·D bytes per query at full memory bandwidth, not one
  scattered row per candidate), and scoring is a dense batched
  contraction.  Per batch: one [Q, K] centroid matmul → top-`probes`
  buckets → block scan → [Q, p·B] exact distances → top-k.

Row ids are an indirection (`rowid[K, B]`), never positional: a row's
public id is a monotonic counter, so reclustering — triggered whenever
the live count doubles — re-places every row WITHOUT invalidating ids.
No remap event ever reaches the caller (the graph backend's compaction
needs one; here compact() is just a recluster that drops tombstones).

Trade against the graph backend: queries scan p·B rows instead of
walking ~ef·beam edges, so per-query work is higher at small N but flat
in N (probes stay constant as K grows), and throughput at batch is
bound by memory bandwidth instead of gathers.  Deletes are tombstones;
inserts append to bucket tails (spilling to the next-nearest cluster
when full); both are exactly the usearch add/remove semantics
(src/index/usearch.rs:174-249).
"""

from __future__ import annotations

import functools
import os
import threading
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from ..utils.persistio import atomic_savez

from ..types import IndexParams
from ..utils.memory import device_memory_bytes
from . import distance as dist_mod
from .topk import INF, SENTINEL, topk_ascending

# Rows accumulated (sequential buckets) before the first clustering.
CLUSTER_MIN_ROWS = 1 << 16
# Spill candidates per insert: a row tries its A nearest clusters in order.
SPILL = 4
# Query-batch chunk for the block-gather step (bounds the [q, g·B, D]
# transient).
QCHUNK = 256
# Rows per place() scatter dispatch.  Ingest chunks larger than this are
# shipped as several fixed-shape scatters of one compiled variant, so
# ragged ingest sizes never compile a new scatter.
SCATTER_BLOCK = 1024
PROBE_DEFAULT = 16
# Probed clusters scored per step of the XLA scan: the gather transient
# is [Q, PROBE_GROUP, B, D], where one monolithic [Q, p, B, D] gather
# would cost 8GB at probes=64, 1M×768.
PROBE_GROUP = 4
# Bank-doubling ceiling, as a share of device memory: once a doubled
# bank would pass it, cluster overflow places rows into the least-filled
# clusters (marked dirty for the incremental compact) instead of
# doubling the whole bank — one hot cluster's overflow must not double
# a multi-GB bank mid-load.
GROW_SHARE = 1 / 4
# Recluster stages its permutation through host RAM once the old and
# the new bank together would pass this share of device memory (they
# coexist during the on-device permute, which adds only index arrays).
HOST_PERMUTE_SHARE = 3 / 4


class IvfState(NamedTuple):
    centroids: jnp.ndarray  # [K, D] compute dtype
    vectors: jnp.ndarray  # [K, B, D] storage dtype
    scales: jnp.ndarray  # [K, B] f32 (int8 dequant; 1.0 otherwise)
    valid: jnp.ndarray  # [K, B] bool
    rowid: jnp.ndarray  # [K, B] int32 public ids (indirection)

    @property
    def n_clusters(self) -> int:
        return self.vectors.shape[0]

    @property
    def bucket(self) -> int:
        return self.vectors.shape[1]

    @property
    def dims(self) -> int:
        return self.vectors.shape[2]


# Rows per bucket target.  170 ≈ 256/1.5: with buckets 128-rounded, B
# lands on exactly 256 at slack 1.5 (a 128-row target rounds B up to
# 2.05x the data).  Larger targets trade probe granularity (recall per
# scanned byte) for larger contiguous blocks per probe; bucket rounding
# is geometry-dependent, so a larger target can also round the bank
# well past the data (340 at 8M x 768: +25%, against +0.2% at 170).
ROWS_PER_BUCKET = int(os.environ.get("VST_IVF_ROWS_PER_BUCKET", "170"))


def k_for(rows: int, rows_per_bucket: int | None = None) -> int:
    """Cluster count: ~rows_per_bucket rows each, a multiple of 128,
    ≤64K."""
    rpb = rows_per_bucket or ROWS_PER_BUCKET
    k = min(max(rows // rpb, 1024), 1 << 16)
    return max((k // 128) * 128, 128)


def bucket_for(rows: int, k: int) -> int:
    """Bucket width with slack for skew + future inserts.  A multiple
    of 128, so the probe-scan kernel's row tiles divide it."""
    return max(int(np.ceil(1.5 * rows / k / 128)) * 128, 128)


def _storage_dtype(dtype: str):
    return {"float32": jnp.float32, "bfloat16": jnp.bfloat16, "int8": jnp.int8}[
        dtype
    ]


def _compute_dtype(dtype: str):
    return jnp.float32 if dtype == "float32" else jnp.bfloat16


def init(dims: int, k: int, bucket: int, dtype: str) -> IvfState:
    return IvfState(
        centroids=jnp.zeros((k, dims), dtype=_compute_dtype(dtype)),
        vectors=jnp.zeros((k, bucket, dims), dtype=_storage_dtype(dtype)),
        scales=jnp.ones((k, bucket), dtype=jnp.float32),
        valid=jnp.zeros((k, bucket), dtype=bool),
        rowid=jnp.full((k, bucket), SENTINEL, dtype=jnp.int32),
    )


# --------------------------------------------------------------------------
# jitted device steps


@functools.partial(jax.jit, static_argnames=("space", "a"), donate_argnums=())
def assign_top(
    centroids: jnp.ndarray, vecs: jnp.ndarray, space: str, a: int
) -> jnp.ndarray:
    """[M, D] preprocessed rows → their `a` nearest clusters [M, a]."""
    d = dist_mod.pairwise(vecs, centroids, space)
    _, cids = jax.lax.top_k(-d, a)
    return cids.astype(jnp.int32)


def place_impl(
    state: IvfState,
    vecs_raw: jnp.ndarray,  # [M, D] raw f32
    ks: jnp.ndarray,  # [M] target cluster (K = dropped lane)
    poss: jnp.ndarray,  # [M] target position
    rowids: jnp.ndarray,  # [M] int32
    space: str,
    dtype: str,
) -> IvfState:
    """Scatter a prepared batch into its (cluster, position) slots.
    Un-jitted body — the sharded backend re-wraps it under shard_map."""
    vecs = dist_mod.preprocess(vecs_raw.astype(jnp.float32), space)
    if dtype == "int8":
        from .quantize import quantize_rows

        rows, scl = quantize_rows(vecs)
    else:
        rows = vecs.astype(_storage_dtype(dtype))
        scl = jnp.ones((vecs.shape[0],), dtype=jnp.float32)
    return state._replace(
        vectors=state.vectors.at[ks, poss].set(rows, mode="drop"),
        scales=state.scales.at[ks, poss].set(scl, mode="drop"),
        valid=state.valid.at[ks, poss].set(True, mode="drop"),
        rowid=state.rowid.at[ks, poss].set(rowids, mode="drop"),
    )


place = jax.jit(
    place_impl, static_argnames=("space", "dtype"), donate_argnums=(0,)
)


def unvalidate_impl(
    state: IvfState, ks: jnp.ndarray, poss: jnp.ndarray
) -> IvfState:
    return state._replace(
        valid=state.valid.at[ks, poss].set(False, mode="drop")
    )


unvalidate = jax.jit(unvalidate_impl)


@functools.partial(jax.jit, static_argnames=("space", "k", "probes"))
def search_clustered(
    state: IvfState,
    queries: jnp.ndarray,  # [q, D] raw f32 (q ≤ QCHUNK)
    space: str,
    k: int,
    probes: int,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Probe-and-scan: (dist[q, k] ascending, rowids[q, k]; +inf/SENTINEL
    padded).

    Probed clusters are scored PROBE_GROUP at a time under a lax.scan
    with a running per-query top-k as carry — same total work as one
    monolithic gather, but the device transient is [Q, g, B, D] instead
    of [Q, p, B, D] (which at probes=64, 1M×768 f32 is 8GB)."""
    cdt = state.centroids.dtype
    q, cids, p = _route(state, queries, space, probes)
    Q = q.shape[0]
    K, B, D = state.vectors.shape
    g = min(PROBE_GROUP, p)
    steps = -(-p // g)
    p_pad = steps * g

    # pad the probe list to a multiple of g; padded lanes are masked out
    # (NOT deduped — masking keeps duplicate rowids impossible)
    lane_ok = jnp.arange(p_pad) < p  # [p_pad]
    if p_pad > p:
        cids = jnp.pad(cids, ((0, 0), (0, p_pad - p)))
    xs = (
        jnp.transpose(cids.reshape(Q, steps, g), (1, 0, 2)),  # [steps, Q, g]
        lane_ok.reshape(steps, g)[:, None, :],  # [steps, 1, g]
    )

    kk = min(k, p * B)

    def step(carry, x):
        bd, bi = carry  # [Q, kk] running ascending dists / rowids
        cg, ok = x  # [Q, g], [1, g]
        blocks = jnp.take(state.vectors, cg, axis=0)  # [Q, g, B, D]
        scl = jnp.take(state.scales, cg, axis=0)  # [Q, g, B]
        vld = jnp.take(state.valid, cg, axis=0) & ok[:, :, None]
        rid = jnp.take(state.rowid, cg, axis=0)
        cand = blocks.reshape(Q, g * B, D)
        if state.vectors.dtype == jnp.int8:
            cand = (
                cand.astype(jnp.float32) * scl.reshape(Q, g * B)[..., None]
            ).astype(cdt)
        else:
            cand = cand.astype(cdt)
        d = dist_mod.gathered(q, cand, space)  # [Q, g*B]
        d = jnp.where(vld.reshape(Q, g * B), d, INF)
        md, pos = topk_ascending(jnp.concatenate([bd, d], axis=-1), kk)
        mi = jnp.take_along_axis(
            jnp.concatenate([bi, rid.reshape(Q, g * B)], axis=-1), pos, axis=-1
        )
        return (md, mi), None

    init = (
        jnp.full((Q, kk), INF, dtype=jnp.float32),
        jnp.full((Q, kk), SENTINEL, dtype=jnp.int32),
    )
    (top_d, top_r), _ = jax.lax.scan(step, init, xs)
    top_r = jnp.where(jnp.isinf(top_d), SENTINEL, top_r)
    if k > kk:
        top_d = jnp.pad(top_d, ((0, 0), (0, k - kk)), constant_values=jnp.inf)
        top_r = jnp.pad(top_r, ((0, 0), (0, k - kk)), constant_values=2**31 - 1)
    return top_d, top_r


@functools.partial(jax.jit, static_argnames=("space", "k", "probes", "interpret"))
def search_clustered_kernel(
    state: IvfState,
    queries: jnp.ndarray,  # [q, D] raw f32
    space: str,
    k: int,
    probes: int,
    interpret: bool = False,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """search_clustered's contract, with the probe-scan as one Pallas
    kernel (ivf_pallas.probe_scan) followed by one top-k."""
    from .ivf_pallas import live_rows, probe_scan

    _, cids, p = _route(state, queries, space, probes)
    qf = dist_mod.preprocess(queries.astype(jnp.float32), space)
    K, B, _ = state.vectors.shape
    rid_masked = jnp.where(state.valid, state.rowid, SENTINEL)
    pool = probe_scan(
        state.vectors,
        state.scales,
        rid_masked,
        live_rows(state.valid),
        qf,
        cids,
        space,
        interpret=interpret,
    )  # [Q, p*B]
    kk = min(k, p * B)
    top_d, pos = topk_ascending(pool, kk)
    c = jnp.take_along_axis(cids, pos // B, axis=-1)
    top_r = jnp.where(jnp.isinf(top_d), SENTINEL, rid_masked[c, pos % B])
    if k > kk:
        top_d = jnp.pad(top_d, ((0, 0), (0, k - kk)), constant_values=jnp.inf)
        top_r = jnp.pad(top_r, ((0, 0), (0, k - kk)), constant_values=2**31 - 1)
    return top_d, top_r


def scan_kernel_for(platform: str) -> bool:
    """The one choice of probe-scan path, for IvfIndex and
    ShardedIvfIndex alike: the Pallas kernel where it compiles for the
    device (a GPU), the XLA scan elsewhere."""
    return platform == "gpu"


# Clusters scanned per chunk of the full-bank scan.  k_for keeps K a
# multiple of 128, so CH=128 always divides K — no clamped (duplicating)
# tail slice, and the [Q, CH*B] distance transient stays a few hundred MB.
FLAT_SCAN_CLUSTERS = 128


@functools.partial(jax.jit, static_argnames=("space", "k", "approx"))
def search_flat(
    state: IvfState, queries: jnp.ndarray, space: str, k: int, approx: bool = True
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Full-bank exact scan (staging-phase serving + the recall oracle).

    Scans the bucketed bank [K, B, D] in CH-cluster chunks under a
    lax.scan with a running top-k — a flat `reshape(K*B, D)` inside jit
    materializes a second full bank (13.9GB at 8M).
    The oracle path (exact_search) passes approx=False — an oracle built
    on approximate top-k caps measured recall at the selector's own
    recall."""
    cdt = state.centroids.dtype
    q = dist_mod.preprocess(queries.astype(jnp.float32), space).astype(cdt)
    Q = q.shape[0]
    K, B, D = state.vectors.shape
    CH = min(FLAT_SCAN_CLUSTERS, K)
    steps = -(-K // CH)
    quantized = state.vectors.dtype == jnp.int8

    def body(carry, k0):
        bd, bi = carry
        blk = jax.lax.dynamic_slice(
            state.vectors, (k0, 0, 0), (CH, B, D)
        ).reshape(CH * B, D)
        vld = jax.lax.dynamic_slice(state.valid, (k0, 0), (CH, B)).reshape(-1)
        rid = jax.lax.dynamic_slice(state.rowid, (k0, 0), (CH, B)).reshape(-1)
        cand = blk.astype(jnp.float32)
        if quantized:
            scl = jax.lax.dynamic_slice(
                state.scales, (k0, 0), (CH, B)
            ).reshape(-1)
            cand = cand * scl[:, None]
        d = dist_mod.pairwise(q, cand.astype(cdt), space)  # [Q, CH*B]
        d = jnp.where(vld[None, :], d, INF)
        kk = min(k, CH * B)
        if approx and CH * B >= (1 << 14):
            from .topk import topk_ascending_approx

            cd, pos = topk_ascending_approx(d, kk)
        else:
            cd, pos = topk_ascending(d, kk)
        cr = jnp.take(rid, jnp.clip(pos, 0, CH * B - 1))
        md, mpos = topk_ascending(jnp.concatenate([bd, cd], axis=-1), k)
        mi = jnp.take_along_axis(
            jnp.concatenate([bi, cr], axis=-1), mpos, axis=-1
        )
        return (md, mi), None

    init = (
        jnp.full((Q, k), INF, dtype=jnp.float32),
        jnp.full((Q, k), SENTINEL, dtype=jnp.int32),
    )
    offs = jnp.arange(steps, dtype=jnp.int32) * CH
    (top_d, top_r), _ = jax.lax.scan(body, init, offs)
    top_r = jnp.where(jnp.isinf(top_d), SENTINEL, top_r)
    return top_d, top_r


# --------------------------------------------------------------------------
# two-stage scan: int4 coarse probe + int8 exact rescore
#
# The probe-scan is memory-bandwidth-bound, so one QPS lever is fewer
# bytes per scanned row: a derived nibble-packed copy of the bank
# (core/quantize.py::pack_int4_from_int8 — 0.5 byte/dim) serves the
# first pass, and only the top-`cand` survivors per query are rescored
# against their int8 rows (a [Q, cand] row gather — ~1% of the scanned
# bytes at cand=4k).  int4 rank noise at D=768 is ~0.006 cosine std, so
# survivors of a 4x overfetch contain the true top-k; the rescore
# restores exact int8 ordering.  Memory: +0.5 byte/dim (1.5B/dim total
# — still 2.7x under the f32 reference bank, BASELINE config 3).

# Clusters repacked per derive step (128 always divides K — see k_for).
_COARSE_CHUNK = 128


@jax.jit
def derive_coarse(vectors: jnp.ndarray) -> jnp.ndarray:
    """[K, B, D] int8 bank → nibble-packed [K, B, D/2] uint8 (chunked
    scan: the unpack transient stays [CH, B, D] instead of a full-bank
    f32 copy)."""
    from .quantize import pack_int4_from_int8

    K, B, D = vectors.shape
    ch = min(_COARSE_CHUNK, K)

    def body(_, k0):
        blk = jax.lax.dynamic_slice(vectors, (k0, 0, 0), (ch, B, D))
        return None, pack_int4_from_int8(blk)

    offs = jnp.arange(K // ch, dtype=jnp.int32) * ch
    _, out = jax.lax.scan(body, None, offs)
    return out.reshape(K, B, D // 2)


@functools.partial(jax.jit, donate_argnums=(0,))
def update_coarse(
    coarse: jnp.ndarray, vectors: jnp.ndarray, ks: jnp.ndarray
) -> jnp.ndarray:
    """Repack only the touched clusters (ks padded to a pow2 bucket —
    duplicate ids are idempotent)."""
    from .quantize import pack_int4_from_int8

    return coarse.at[ks].set(pack_int4_from_int8(vectors[ks]))


def _route(state: IvfState, queries: jnp.ndarray, space: str, probes: int):
    """Shared probe selection: preprocessed queries (compute dtype) +
    top-`probes` clusters.  Selection is exact below 16K clusters (a
    missed best cluster is a recall loss no extra probe recovers);
    above, `approx_min_k` with a tight target — on a GPU, JAX lowers
    it as sort-and-slice, so it is exact there too."""
    cdt = state.centroids.dtype
    q = dist_mod.preprocess(queries.astype(jnp.float32), space).astype(cdt)
    cd = dist_mod.pairwise(q, state.centroids, space)
    K = state.n_clusters
    p = min(probes, K)
    if K >= (1 << 14):
        _, cids = jax.lax.approx_min_k(cd, p, recall_target=0.999)
    else:
        _, cids = jax.lax.top_k(-cd, p)
    return q, cids.astype(jnp.int32), p


def _rescore_flat(
    state: IvfState,
    q: jnp.ndarray,  # [Q, D] preprocessed, compute dtype
    bd: jnp.ndarray,  # [Q, C] coarse dists (INF = masked)
    bflat: jnp.ndarray,  # [Q, C] flat bank positions (k*B + pos)
    space: str,
    k: int,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Exact int8 rescore of the coarse survivors → final top-k."""
    cdt = state.centroids.dtype
    K, B, D = state.vectors.shape
    flat_v = state.vectors.reshape(K * B, D)
    safe = jnp.clip(bflat, 0, K * B - 1)
    rows = jnp.take(flat_v, safe, axis=0).astype(jnp.float32)  # [Q, C, D]
    if state.vectors.dtype == jnp.int8:
        scl = jnp.take(state.scales.reshape(K * B), safe)
        rows = rows * scl[..., None]
    d = dist_mod.gathered(q, rows.astype(cdt), space)  # [Q, C]
    d = jnp.where(jnp.isinf(bd), INF, d)
    rid = jnp.take(state.rowid.reshape(K * B), safe)
    kk = min(k, d.shape[1])
    top_d, pos = topk_ascending(d, kk)
    top_r = jnp.take_along_axis(rid, pos, axis=-1)
    top_r = jnp.where(jnp.isinf(top_d), SENTINEL, top_r)
    if k > kk:
        top_d = jnp.pad(top_d, ((0, 0), (0, k - kk)), constant_values=jnp.inf)
        top_r = jnp.pad(
            top_r, ((0, 0), (0, k - kk)), constant_values=2**31 - 1
        )
    return top_d, top_r


@functools.partial(jax.jit, static_argnames=("space", "k", "probes", "cand"))
def search_two_stage(
    state: IvfState,
    coarse: jnp.ndarray,  # [K, B, D/2] uint8 derived bank
    queries: jnp.ndarray,  # [q, D] raw f32
    space: str,
    k: int,
    probes: int,
    cand: int,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """int4 coarse probe-scan → top-`cand` per query → int8 rescore.

    Same contract as search_clustered; the coarse scan runs as XLA
    gathers of the packed bank, PROBE_GROUP clusters per step."""
    q, cids, p = _route(state, queries, space, probes)
    Q = q.shape[0]
    K, B, D = state.vectors.shape
    C = min(cand, p * B)

    from .quantize import unpack_int4

    g = min(PROBE_GROUP, p)
    steps = -(-p // g)
    p_pad = steps * g
    lane_ok = jnp.arange(p_pad) < p
    cg_all = cids
    if p_pad > p:
        cg_all = jnp.pad(cids, ((0, 0), (0, p_pad - p)))
    xs = (
        jnp.transpose(cg_all.reshape(Q, steps, g), (1, 0, 2)),
        lane_ok.reshape(steps, g)[:, None, :],
    )
    cdt = state.centroids.dtype

    def step(carry, x):
        bd, bf = carry
        cg, ok = x  # [Q, g], [1, g]
        blocks = jnp.take(coarse, cg, axis=0)  # [Q, g, B, D/2] uint8
        codes = unpack_int4(blocks.reshape(Q, g * B, D // 2))
        scl = jnp.take(state.scales, cg, axis=0).reshape(Q, g * B)
        scl = scl * (127.0 / 7.0)
        vld = (jnp.take(state.valid, cg, axis=0) & ok[:, :, None]).reshape(
            Q, g * B
        )
        rows = (codes.astype(jnp.float32) * scl[..., None]).astype(cdt)
        d = dist_mod.gathered(q, rows, space)
        d = jnp.where(vld, d, INF)
        flat = (cg[:, :, None] * B + jnp.arange(B)[None, None, :]).reshape(
            Q, g * B
        )
        md, pos = topk_ascending(jnp.concatenate([bd, d], axis=-1), C)
        mf = jnp.take_along_axis(
            jnp.concatenate([bf, flat], axis=-1), pos, axis=-1
        )
        return (md, mf), None

    init_c = (
        jnp.full((Q, C), INF, dtype=jnp.float32),
        jnp.zeros((Q, C), dtype=jnp.int32),
    )
    (bd, bflat), _ = jax.lax.scan(step, init_c, xs)

    return _rescore_flat(state, q, bd, bflat, space, k)


# --- recluster kernels: each device pass is ONE dispatch (lax.scan over
#     index chunks), not one eager gather per chunk — a per-chunk
#     reshape+take pays a full-bank copy and a dispatch per 4096 rows.


def _chunked(idx: np.ndarray, a: int) -> np.ndarray:
    """Row-major [C, a] chunking of an index list, -1 padded."""
    n = len(idx)
    c = max(-(-n // a), 1)
    out = np.full((c * a,), -1, dtype=np.int32)
    out[:n] = idx
    return out.reshape(c, a)


@jax.jit
def _gather_dequant(vectors, scales, ids):
    """Flat-bank row gather with int8 dequant → [n, D] f32."""
    K, B, D = vectors.shape
    flat = vectors.reshape(K * B, D)
    rows = jnp.take(flat, ids, axis=0).astype(jnp.float32)
    if vectors.dtype == jnp.int8:
        rows = rows * jnp.take(scales.reshape(K * B), ids)[:, None]
    return rows


@functools.partial(jax.jit, static_argnames=("space",))
def _lloyd_iter(vectors, scales, centroids, chunks, space):
    """One full Lloyd iteration over chunked sample indices — a single
    dispatch: scan(gather → assign → scatter-add) then the mean/normalize
    update."""
    K, B, D = vectors.shape
    flat = vectors.reshape(K * B, D)
    sflat = scales.reshape(K * B)
    cdt = centroids.dtype
    k = centroids.shape[0]

    def body(carry, ids):
        sums, cnts = carry
        ok = ids >= 0
        safe = jnp.clip(ids, 0, K * B - 1)
        rows = jnp.take(flat, safe, axis=0).astype(jnp.float32)
        if vectors.dtype == jnp.int8:
            rows = rows * jnp.take(sflat, safe)[:, None]
        d = dist_mod.pairwise(rows.astype(cdt), centroids, space)
        cid = jnp.argmin(d, axis=1)
        w = ok.astype(jnp.float32)
        sums = sums.at[cid].add(rows * w[:, None])
        cnts = cnts.at[cid].add(w)
        return (sums, cnts), None

    (sums, cnts), _ = jax.lax.scan(
        body,
        (jnp.zeros((k, D), jnp.float32), jnp.zeros((k,), jnp.float32)),
        chunks,
    )
    mean = sums / jnp.maximum(cnts, 1.0)[:, None]
    if space == "cosine":
        mean = dist_mod.normalize(mean)
    return jnp.where((cnts > 0)[:, None], mean.astype(cdt), centroids)


@functools.partial(jax.jit, static_argnames=("space", "a"))
def _assign_pass(vectors, scales, centroids, chunks, space, a):
    """Top-`a` cluster assignment for every chunked row — one dispatch.
    Returns [C, A, a]; padding lanes carry garbage (caller slices)."""
    K, B, D = vectors.shape
    flat = vectors.reshape(K * B, D)
    sflat = scales.reshape(K * B)
    cdt = centroids.dtype

    def body(_, ids):
        safe = jnp.clip(ids, 0, K * B - 1)
        rows = jnp.take(flat, safe, axis=0).astype(jnp.float32)
        if vectors.dtype == jnp.int8:
            rows = rows * jnp.take(sflat, safe)[:, None]
        d = dist_mod.pairwise(rows.astype(cdt), centroids, space)
        _, cid = jax.lax.top_k(-d, a)
        return None, cid.astype(jnp.int32)

    _, out = jax.lax.scan(body, None, chunks)
    return out


def permute_build_impl(
    old: IvfState,
    new: IvfState,
    perm: jnp.ndarray,  # [K', B'] flat source index into old (SENTINEL=empty)
) -> IvfState:
    """Recluster materialisation: gather old flat rows into new buckets."""
    Ko, Bo, D = old.vectors.shape
    flat_v = old.vectors.reshape(Ko * Bo, D)
    flat_s = old.scales.reshape(Ko * Bo)
    flat_r = old.rowid.reshape(Ko * Bo)
    ok = perm != SENTINEL
    src = jnp.clip(perm, 0, Ko * Bo - 1)
    return new._replace(
        vectors=jnp.take(flat_v, src, axis=0),
        scales=jnp.take(flat_s, src, axis=0),
        valid=ok,
        rowid=jnp.where(ok, jnp.take(flat_r, src, axis=0), SENTINEL),
    )


permute_build = jax.jit(permute_build_impl, donate_argnums=(1,))


# --------------------------------------------------------------------------


def plan_placement(
    cids: np.ndarray,
    n_used: np.ndarray,
    bucket: int,
    free: dict[int, list[int]] | None = None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Host-side slot allocation with spill cascade.

    cids [M, A] preference-ordered clusters per row.  Returns
    (ks, poss, unplaced_mask); n_used (and `free`, when given) are
    updated in place.  Tombstoned positions in `free` are reused
    before the append cursor advances, so delete/reinsert churn does
    not leak slots (leaked slots forced bucket-doubling reallocations
    of the whole bank even at flat live count)."""
    m = len(cids)
    ks = np.full((m,), -1, dtype=np.int64)
    poss = np.zeros((m,), dtype=np.int64)
    pending = np.arange(m)
    for a in range(cids.shape[1]):
        if len(pending) == 0:
            break
        want = cids[pending, a]
        order = np.argsort(want, kind="stable")
        w_sorted = want[order]
        starts = np.r_[0, np.flatnonzero(np.diff(w_sorted)) + 1]
        ends = np.r_[starts[1:], len(w_sorted)]
        still = []
        for s0, s1 in zip(starts, ends):
            c = int(w_sorted[s0])
            rows = pending[order[s0:s1]]
            fl = free.get(c) if free is not None else None
            take = min(len(fl), len(rows)) if fl else 0
            if take:
                got = rows[:take]
                ks[got] = c
                poss[got] = [fl.pop() for _ in range(take)]
                if not fl:
                    free.pop(c, None)
                rows = rows[take:]
            if len(rows):
                fit = min(len(rows), max(bucket - int(n_used[c]), 0))
                if fit:
                    got = rows[:fit]
                    ks[got] = c
                    poss[got] = n_used[c] + np.arange(fit)
                    n_used[c] += fit
                    rows = rows[fit:]
            if len(rows):
                still.append(rows)
        pending = (
            np.concatenate(still) if still else np.empty((0,), np.int64)
        )
    return ks, poss, ks < 0


class IvfIndex:
    """Host wrapper: same numpy-in/numpy-out surface as SlotIndex.

    Ids are monotonic rowids — stable across bucket growth, reclustering
    and compaction (the engine keymap never needs a remap event from this
    backend).
    """

    def __init__(
        self,
        params: IndexParams,
        initial_capacity: int | None = None,
        probes: int = PROBE_DEFAULT,
        cluster_min: int = CLUSTER_MIN_ROWS,
        rows_per_bucket: int | None = None,
        coarse: bool | None = None,
        rescore: int = 8,
        reserve_rows: int = 0,
    ) -> None:
        self.params = params
        self.space = params.space
        self.dtype = (
            params.dtype if params.dtype in ("float32", "int8") else "bfloat16"
        )
        self.dims = params.dimensions
        self.probes = probes
        # two-stage scan (int4 coarse + int8 rescore): explicit arg wins,
        # else VST_IVF_COARSE=1 opts in; only meaningful for int8 banks
        env4 = os.environ.get("VST_IVF_COARSE")
        if coarse is None:
            coarse = env4 == "1"
        elif env4 == "0":
            coarse = False
        self.coarse = bool(coarse) and self.dtype == "int8" and self.dims % 2 == 0
        # rescored candidates per query = max(rescore*k, 64): int4 rank
        # noise scales ~1/sqrt(D), so low-D banks want a bigger overfetch
        # (measured: D=64 needs 16x for parity with int8; D=768 is fine
        # at 4-8x) — the rescore row-gather is the cost knob
        self.rescore = rescore
        self._coarse_bank: jnp.ndarray | None = None
        self._coarse_stale = True
        self._coarse_dirty: set[int] = set()
        self.cluster_min = cluster_min
        self.rows_per_bucket = rows_per_bucket or ROWS_PER_BUCKET
        # Bulk-load mode: the expected final row count.  The first
        # clustering (at cluster_min live rows) sizes k AND the bucket
        # for `reserve_rows`, and the doubling-recluster policy is
        # suspended until the live count exceeds it — one recluster per
        # bulk load instead of O(log n), and the big bank is built by
        # ONE on-device permute while the staging bank is still small
        # (a recluster at the final size would need two full banks in
        # device memory at once).  Assumes the
        # stream's distribution is stationary across the load, like the
        # reference's initial full-table scan (db_index.rs:217-237).
        self._reserve = int(reserve_rows or 0)
        rows0 = max(initial_capacity or 0, cluster_min)
        k = k_for(rows0, self.rows_per_bucket)
        b = bucket_for(rows0, k)
        self._state = init(self.dims, k, b, self.dtype)
        self._clustered = False
        self._clustered_at = 0  # live count at last recluster
        # host mirrors (placement bookkeeping without device readbacks)
        self._n_used = np.zeros((k,), dtype=np.int64)
        self._valid_h = np.zeros((k, b), dtype=bool)
        self._rowid_h = np.full((k, b), -1, dtype=np.int64)
        self._loc = np.full((0, 2), -1, dtype=np.int64)  # rowid → (k, pos)
        # tombstoned (cluster → positions) free for reuse: without this,
        # delete/reinsert churn leaks slots (the append cursor never
        # retreats) and forces bucket-doubling reallocations of the whole
        # bank even though live count is flat
        self._free: dict[int, list[int]] = {}
        # clusters that received SPILLED rows (placed past their first-
        # choice cluster) — the incremental compact's work list
        self._dirty: set[int] = set()
        self._next_rowid = 0
        self._n_live = 0
        self._lock = threading.Lock()
        self._kernel = scan_kernel_for(jax.devices()[0].platform)

    # -- introspection ------------------------------------------------------

    def count(self) -> int:
        return self._n_live

    @property
    def state(self) -> IvfState:
        return self._state

    @property
    def n_clusters(self) -> int:
        return self._state.n_clusters

    # -- helpers ------------------------------------------------------------

    def _grow_loc(self, n: int) -> None:
        if self._next_rowid + n > len(self._loc):
            new_len = max(2 * len(self._loc), self._next_rowid + n, 1024)
            pad = np.full((new_len - len(self._loc), 2), -1, dtype=np.int64)
            self._loc = np.concatenate([self._loc, pad])

    def _grow_bucket(self) -> None:
        """Double B (pad axis 1) — realloc event, ids unaffected."""
        s = self._state
        K, B, D = s.vectors.shape
        self._state = IvfState(
            centroids=s.centroids,
            vectors=jnp.pad(s.vectors, ((0, 0), (0, B), (0, 0))),
            scales=jnp.pad(s.scales, ((0, 0), (0, B)), constant_values=1.0),
            valid=jnp.pad(s.valid, ((0, 0), (0, B))),
            rowid=jnp.pad(s.rowid, ((0, 0), (0, B)), constant_values=int(SENTINEL)),
        )
        self._valid_h = np.pad(self._valid_h, ((0, 0), (0, B)))
        self._rowid_h = np.pad(
            self._rowid_h, ((0, 0), (0, B)), constant_values=-1
        )
        self._coarse_stale = True  # bank shape changed; re-derive
        self._coarse_bank = None

    def _plan_placement(
        self,
        cids: np.ndarray,
        n_used: np.ndarray,
        bucket: int,
        free: dict[int, list[int]] | None = None,
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        return plan_placement(cids, n_used, bucket, free)

    # -- mutation -----------------------------------------------------------

    def add(self, vectors: np.ndarray) -> np.ndarray:
        # device-resident blocks (jnp arrays) skip the host round-trip:
        # `place` casts/quantizes on device, so a corpus that already
        # lives in device memory (bench generators, device-side ETL)
        # never crosses the host link
        if not isinstance(vectors, jnp.ndarray):
            vectors = np.asarray(vectors, dtype=np.float32)
        if vectors.ndim == 1:
            vectors = vectors[None, :]
        n, d = vectors.shape
        if d != self.dims:
            raise ValueError(f"dimension mismatch: index {self.dims}, got {d}")
        with self._lock:
            self._grow_loc(n)
            rowids = np.arange(
                self._next_rowid, self._next_rowid + n, dtype=np.int64
            )
            self._next_rowid += n
            # per-dispatch ingest block (~12MB shipped), with the dispatch
            # queue synced every ~100MB so a long ingest cannot queue
            # unbounded host->device transfers (core/index.py has the
            # same discipline)
            chunk = 8192
            for i, off in enumerate(range(0, n, chunk)):
                blk = vectors[off : off + chunk]
                rid = rowids[off : off + chunk]
                if self._clustered:
                    self._add_clustered(blk, rid)
                else:
                    self._add_staging(blk, rid)
                if (i + 1) % 8 == 0:
                    jax.block_until_ready(self._state.valid)
            self._n_live += n
            self._maybe_recluster()
        return rowids

    def _to_dev(self, blk: np.ndarray) -> jnp.ndarray:
        """One host->device ship per ingest block, in the cheapest dtype
        the bank's precision allows (bf16 for bf16/int8 banks — transfer
        is the ingest bottleneck, not the scatter)."""
        if isinstance(blk, jnp.ndarray):
            return blk  # already device-resident; place() casts on device
        if self.dtype != "float32":
            import ml_dtypes

            blk = np.asarray(blk).astype(ml_dtypes.bfloat16)
        return jnp.asarray(blk)

    def _scatter(self, blk, ks, poss, rid) -> None:
        dev = blk if isinstance(blk, jnp.ndarray) else self._to_dev(blk)
        m = dev.shape[0]
        # Ship every scatter in SCATTER_BLOCK rows.  Every block
        # (including the tail and small direct adds, whose sizes are
        # RAGGED on the ingest-bridge path — a distinct compile each
        # otherwise) is padded up to SCATTER_BLOCK; pad lanes carry
        # ks=K, which mode="drop" discards.
        SB = SCATTER_BLOCK
        K = self._state.n_clusters
        for off in range(0, m, SB):
            end = min(off + SB, m)
            bs, kk = dev[off:end], ks[off:end]
            pp, rr = poss[off:end], rid[off:end]
            mm = end - off
            # ONE compiled shape: every block pads to SB
            if mm < SB:
                pad = SB - mm
                bs = jnp.pad(bs, ((0, pad), (0, 0)))
                kk = np.pad(np.asarray(kk), (0, pad), constant_values=K)
                pp = np.pad(np.asarray(pp), (0, pad))
                rr = np.pad(np.asarray(rr), (0, pad))
            self._state = place(
                self._state,
                bs,
                jnp.asarray(kk, dtype=jnp.int32),
                jnp.asarray(pp, dtype=jnp.int32),
                jnp.asarray(rr, dtype=jnp.int32),
                self.space,
                self.dtype,
            )
        self._valid_h[ks, poss] = True
        self._rowid_h[ks, poss] = rid
        self._loc[rid, 0] = ks
        self._loc[rid, 1] = poss
        if self.coarse and not self._coarse_stale:
            self._coarse_dirty.update(int(x) for x in np.unique(ks))

    def _add_staging(self, blk: np.ndarray, rid: np.ndarray) -> None:
        """Sequential fill before the first clustering.

        Placement derives from per-cluster fill counts, NOT a global
        flat cursor: rows placed before a `_grow_bucket()` were laid out
        with the OLD bucket width, so a `flat // B` mapping computed
        with the new width would land on occupied slots and silently
        overwrite them (every add() larger than K*B hit this)."""
        blk = self._to_dev(blk)
        m = len(blk)
        K, B = self._state.n_clusters, self._state.bucket
        while int(self._n_used.sum()) + m > K * B:
            self._grow_bucket()
            B = self._state.bucket
        rem = B - self._n_used  # free tail slots per cluster, in order
        cum = np.cumsum(rem)
        j = np.arange(m)
        ks = np.searchsorted(cum, j, side="right")
        prev = np.where(ks > 0, cum[np.maximum(ks - 1, 0)], 0)
        poss = self._n_used[ks] + (j - prev)
        np.add.at(self._n_used, ks, 1)
        self._scatter(blk, ks, poss, rid)

    @staticmethod
    def _place_overflow(ks, poss, unplaced, used, bucket) -> bool:
        """Assign overflow rows to the clusters with the most free tail
        slots (mutates ks/poss/used in place).  False if the whole bank
        is genuinely full (caller must grow after all)."""
        over = np.flatnonzero(unplaced)
        space = np.maximum(bucket - used, 0)
        order = np.argsort(-space, kind="stable")
        cum = np.cumsum(space[order])
        if cum[-1] < len(over):
            return False
        j = np.searchsorted(cum, np.arange(1, len(over) + 1), side="left")
        target = order[j]
        prev = np.r_[0, cum[:-1]]
        off = np.arange(len(over)) - prev[j]
        ks[over] = target
        poss[over] = used[target] + off
        np.add.at(used, target, 1)
        return True

    def _add_clustered(self, blk: np.ndarray, rid: np.ndarray) -> None:
        blk = self._to_dev(blk)  # ONE transfer, shared by assign + place
        # pad the assign to ONE fixed shape: the ingest bridge ships
        # RAGGED batch sizes, and every distinct row count would
        # otherwise compile its own [m, K] assign matmul.  Pad rows are
        # zeros — their (nan) scores are row-independent and sliced
        # off.  8192 = the add() chunk bound.
        m = blk.shape[0]
        want = 8192
        blk_a = jnp.pad(blk, ((0, want - m), (0, 0))) if m < want else blk
        prep = dist_mod.preprocess(
            blk_a.astype(jnp.float32), self.space
        ).astype(self._state.centroids.dtype)
        cids = np.asarray(
            assign_top(self._state.centroids, prep, self.space, SPILL)
        )[:m]
        while True:
            used = self._n_used.copy()
            free_try = {k: v[:] for k, v in self._free.items()}
            ks, poss, unplaced = self._plan_placement(
                cids, used, self._state.bucket, free=free_try
            )
            if not unplaced.any():
                self._n_used = used
                self._free = free_try
                break
            K, B, D = self._state.vectors.shape
            bank_bytes = K * B * D * self._state.vectors.dtype.itemsize
            if 2 * bank_bytes > GROW_SHARE * device_memory_bytes():
                # growth-capped: place the overflow into the emptiest
                # clusters instead of doubling a multi-GB bank.  These
                # rows are reachable only through their actual cluster's
                # probes; `spilled` marks the targets dirty and the
                # incremental compact re-homes them later.
                done = self._place_overflow(ks, poss, unplaced, used, B)
                if done:
                    self._n_used = used
                    self._free = free_try
                    break
            self._grow_bucket()
        spilled = ks != cids[:, 0]
        if spilled.any():
            self._dirty.update(int(c) for c in np.unique(ks[spilled]))
        self._scatter(blk, ks, poss, rid)

    def remove(self, rowids: np.ndarray) -> None:
        rowids = np.unique(np.asarray(rowids, dtype=np.int64).reshape(-1))
        rowids = rowids[(rowids >= 0) & (rowids < self._next_rowid)]
        if rowids.size == 0:
            return
        with self._lock:
            ks = self._loc[rowids, 0]
            live = ks >= 0
            rowids = rowids[live]
            if rowids.size == 0:
                return
            ks, poss = self._loc[rowids, 0], self._loc[rowids, 1]
            if self._clustered:
                for k, p in zip(ks.tolist(), poss.tolist()):
                    self._free.setdefault(k, []).append(p)
            # chunk + pad to ONE fixed shape (drop lanes at ks=K):
            # remove sizes are arbitrary, and each distinct size would
            # compile its own scatter variant
            K = self._state.n_clusters
            SB = SCATTER_BLOCK
            for off in range(0, len(ks), SB):
                kk, pp = ks[off : off + SB], poss[off : off + SB]
                if len(kk) < SB:
                    pad = SB - len(kk)
                    kk = np.pad(kk, (0, pad), constant_values=K)
                    pp = np.pad(pp, (0, pad))
                self._state = unvalidate(
                    self._state,
                    jnp.asarray(kk, dtype=jnp.int32),
                    jnp.asarray(pp, dtype=jnp.int32),
                )
            self._valid_h[ks, poss] = False
            self._loc[rowids] = -1
            self._n_live -= len(rowids)

    # -- clustering ---------------------------------------------------------

    def _maybe_recluster(self) -> None:
        if self._n_live < self.cluster_min:
            return
        if self._clustered and (
            self._n_live < 2 * self._clustered_at
            # bulk-load mode: k/bucket were sized for _reserve at the
            # first clustering — hold the centroid set until the load
            # overshoots the reservation
            or self._n_live <= self._reserve
        ):
            return
        self._recluster_locked()

    def compact(self, full: bool | None = None) -> dict:
        """Maintenance pass; ids are stable — the returned remap is empty
        by design (engine contract: no rebinding needed).

        full=True: recluster from scratch (fresh Lloyd, drops tombstoned
        slots).  full=False: incremental — re-place only rows that
        spilled past their first-choice cluster.  Default (None) picks
        full only when the live count doubled since the last recluster:
        a full Lloyd + assign + permute over the whole bank costs minutes
        at the 1M tier and is wasted work after mere churn."""
        with self._lock:
            if self._n_live == 0:
                return {}
            if full is None:
                full = (
                    not self._clustered
                    or self._n_live >= 2 * self._clustered_at
                )
            if full:
                self._recluster_locked()
            else:
                self._reassign_dirty_locked()
        return {}

    def _reassign_dirty_locked(self) -> None:
        """Incremental recluster: re-place rows living in clusters that
        received spilled inserts, moving each to its best cluster with
        space (centroids unchanged; full Lloyd only on doubling).  After
        churn the freed tombstone slots make first-choice placements
        succeed again, recovering the recall the spills cost."""
        from .cluster import ASSIGN_CHUNK

        if not self._dirty or not self._clustered:
            self._dirty = set()
            return
        s = self._state
        K, B, D = s.vectors.shape
        dirty = np.fromiter(self._dirty, dtype=np.int64)
        self._dirty = set()
        rows_k, rows_p = np.nonzero(self._valid_h[dirty])
        if len(rows_k) == 0:
            return
        flat = dirty[rows_k] * B + rows_p
        a_chunk = ASSIGN_CHUNK if K <= (1 << 15) else 1024
        cids = np.asarray(
            _assign_pass(
                s.vectors,
                s.scales,
                s.centroids,
                jnp.asarray(_chunked(flat, a_chunk)),
                self.space,
                SPILL,
            )
        ).reshape(-1, SPILL)[: len(flat)]
        cur = flat // B
        move = cids[:, 0] != cur
        if not move.any():
            return
        # first-choice ONLY: a move either lands the row where the router
        # will actually probe for it, or doesn't happen.  Lateral
        # spill→spill moves (2nd choice to another 2nd choice) are pure
        # churn with no recall benefit, so unplaceable rows stay put and
        # their clusters stay on the dirty list for a later pass
        flat_mv, first_mv = flat[move], cids[move, :1]
        # plan BEFORE freeing the movers' own slots: new slots then never
        # alias a mover's source slot, so chunked gather+place below can
        # read from the evolving bank safely
        used = self._n_used.copy()
        free_try = {k: v[:] for k, v in self._free.items()}
        ks, poss, unplaced = plan_placement(first_mv, used, B, free=free_try)
        if unplaced.any():
            self._dirty.update(int(c) for c in np.unique(flat_mv[unplaced] // B))
        placed = ~unplaced
        if not placed.any():
            return
        self._n_used = used
        self._free = free_try
        flat_mv, ks, poss = flat_mv[placed], ks[placed], poss[placed]
        old_k, old_p = flat_mv // B, flat_mv % B
        rowids = self._rowid_h[old_k, old_p]
        m = len(flat_mv)
        CH = 16384
        for off in range(0, m, CH):
            hi = min(off + CH, m)
            n_sl = hi - off
            src = np.zeros((CH,), dtype=np.int32)
            src[:n_sl] = flat_mv[off:hi]
            kk = np.full((CH,), K, dtype=np.int32)  # K = dropped lane
            kk[:n_sl] = ks[off:hi]
            pp = np.zeros((CH,), dtype=np.int32)
            pp[:n_sl] = poss[off:hi]
            rr = np.full((CH,), int(SENTINEL), dtype=np.int32)
            rr[:n_sl] = rowids[off:hi]
            rows = _gather_dequant(
                self._state.vectors, self._state.scales, jnp.asarray(src)
            )
            # rows are stored preprocessed; preprocess is idempotent
            self._state = place(
                self._state,
                rows,
                jnp.asarray(kk),
                jnp.asarray(pp),
                jnp.asarray(rr),
                self.space,
                self.dtype,
            )
        self._state = unvalidate(
            self._state,
            jnp.asarray(old_k, dtype=jnp.int32),
            jnp.asarray(old_p, dtype=jnp.int32),
        )
        # coarse cache: moved rows wrote new codes into `ks` (the vacated
        # slots only flipped validity, which the scan reads live)
        if self.coarse and not self._coarse_stale:
            self._coarse_dirty.update(int(c) for c in np.unique(ks))
        # host mirrors: vacate old slots, claim new ones
        self._valid_h[old_k, old_p] = False
        for k_, p_ in zip(old_k.tolist(), old_p.tolist()):
            self._free.setdefault(int(k_), []).append(int(p_))
        self._valid_h[ks, poss] = True
        self._rowid_h[ks, poss] = rowids
        self._loc[rowids, 0] = ks
        self._loc[rowids, 1] = poss

    def _recluster_locked(self) -> None:
        from .cluster import ASSIGN_CHUNK, LLOYD_ITERS, LLOYD_SAMPLE

        s = self._state
        K, B, D = s.vectors.shape
        flat_live = np.flatnonzero(self._valid_h.reshape(-1))
        n = len(flat_live)
        if n == 0:
            return
        # bulk-load mode sizes the new bank for the reservation, not the
        # current live count (see __init__ reserve_rows)
        k_new = k_for(max(n, self._reserve), self.rows_per_bucket)
        cdt = s.centroids.dtype
        # the per-chunk [A, k_new] distance transient must stay ~256MB
        a_chunk = ASSIGN_CHUNK if k_new <= (1 << 15) else 1024

        # --- k-means: strided live sample init + Lloyd iterations (each
        # iteration is ONE device dispatch — see _lloyd_iter)
        stride = max(n // k_new, 1)
        centroids = _gather_dequant(
            s.vectors,
            s.scales,
            jnp.asarray(flat_live[::stride][:k_new], dtype=jnp.int32),
        ).astype(cdt)
        if centroids.shape[0] < k_new:  # pad degenerate case
            reps = -(-k_new // centroids.shape[0])
            centroids = jnp.tile(centroids, (reps, 1))[:k_new]
        sample_n = min(n, LLOYD_SAMPLE)
        s_stride = max(n // sample_n, 1)
        sample_chunks = jnp.asarray(
            _chunked(flat_live[::s_stride][:sample_n], a_chunk)
        )
        for _ in range(LLOYD_ITERS):
            centroids = _lloyd_iter(
                s.vectors, s.scales, centroids, sample_chunks, self.space
            )

        # --- assign every live row (top-SPILL for the placement cascade)
        all_cids = np.asarray(
            _assign_pass(
                s.vectors,
                s.scales,
                centroids,
                jnp.asarray(_chunked(flat_live, a_chunk)),
                self.space,
                SPILL,
            )
        ).reshape(-1, SPILL)[:n]

        # --- host placement into fresh buckets, then device permute-build
        b_new = bucket_for(max(n, self._reserve), k_new)
        while True:
            used = np.zeros((k_new,), dtype=np.int64)
            ks, poss, unplaced = self._plan_placement(all_cids, used, b_new)
            if not unplaced.any():
                break
            b_new = -(-int(b_new * 1.5) // 128) * 128  # stay 128-aligned
        perm = np.full((k_new, b_new), int(SENTINEL), dtype=np.int64)
        perm[ks, poss] = flat_live
        old_rowid_h = self._rowid_h
        rowid_flat = old_rowid_h.reshape(-1)

        itemsize = s.vectors.dtype.itemsize
        old_bytes = K * B * D * itemsize
        new_bytes = k_new * b_new * D * itemsize
        if old_bytes + new_bytes > HOST_PERMUTE_SHARE * device_memory_bytes():
            # Two banks cannot coexist in device memory: stage the
            # permutation through host RAM — pull the old bank down in
            # slices, FREE it, gather on host, push the new bank up.  It
            # happens once per bank doubling.
            box = [s]
            del s  # the box holds the ONLY reference to the old bank now
            self._state = None
            self._state = self._permute_via_host(
                box, centroids, perm, k_new, b_new, D
            )
        else:
            new = init(D, k_new, b_new, self.dtype)._replace(
                centroids=centroids
            )
            self._state = permute_build(
                s, new, jnp.asarray(perm, dtype=jnp.int32)
            )

        # host mirrors follow the same permutation
        self._rowid_h = np.full((k_new, b_new), -1, dtype=np.int64)
        self._rowid_h[ks, poss] = rowid_flat[flat_live]
        self._valid_h = np.zeros((k_new, b_new), dtype=bool)
        self._valid_h[ks, poss] = True
        self._n_used = used
        placed_rowids = rowid_flat[flat_live]
        self._loc[placed_rowids, 0] = ks
        self._loc[placed_rowids, 1] = poss
        self._free = {}  # every tombstone was just dropped
        # rows the recluster itself had to spill stay on the incremental
        # work list (hot clusters oversubscribe under churny data)
        spilled = ks != all_cids[:, 0]
        self._dirty = (
            {int(c) for c in np.unique(ks[spilled])} if spilled.any() else set()
        )
        self._clustered = True
        self._clustered_at = self._n_live
        self._coarse_stale = True  # whole bank permuted; re-derive
        self._coarse_bank = None

    def _permute_via_host(
        self, box: list, centroids, perm, k_new, b_new, D
    ) -> IvfState:
        """Recluster materialisation staged through host RAM (big banks).

        `box` holds the sole reference to the old state — it is drained
        as soon as the bank is pulled down, so the old and new device
        banks never coexist."""
        import ml_dtypes

        s = box[0]
        K, B = s.vectors.shape[0], s.vectors.shape[1]
        KB = K * B
        np_store = (
            ml_dtypes.bfloat16
            if s.vectors.dtype == jnp.bfloat16
            else np.dtype(str(jnp.dtype(s.vectors.dtype)))
        )
        # Pull K-slices WITHOUT a device reshape: an eager reshape of the
        # [K, B, D] bank materializes a second full copy in HBM — the
        # exact allocation this path exists to avoid.
        vec_h = np.empty((KB, D), dtype=np_store)
        kstep = max((1 << 28) // (B * D * np.dtype(np_store).itemsize), 1)
        for k0 in range(0, K, kstep):
            blk = np.asarray(s.vectors[k0 : k0 + kstep])  # [kk, B, D]
            vec_h[k0 * B : (k0 + blk.shape[0]) * B] = blk.reshape(-1, D)
        scl_h = np.asarray(s.scales).reshape(-1)
        del blk, s
        box.clear()  # free the old device bank before allocating new

        perm_flat = perm.reshape(-1)
        sel = perm_flat != int(SENTINEL)  # empty slots carry SENTINEL, not -1
        new_vec = np.zeros((k_new * b_new, D), dtype=np_store)
        new_vec[sel] = vec_h[perm_flat[sel]]
        del vec_h
        new_scl = np.ones((k_new * b_new,), dtype=np.float32)
        new_scl[sel] = scl_h[perm_flat[sel]]
        rid_src = self._rowid_h.reshape(-1)
        new_rid = np.full((k_new * b_new,), int(SENTINEL), dtype=np.int32)
        new_rid[sel] = rid_src[perm_flat[sel]]
        return IvfState(
            centroids=centroids,
            vectors=jnp.asarray(new_vec.reshape(k_new, b_new, D)).astype(
                _storage_dtype(self.dtype)
            ),
            scales=jnp.asarray(new_scl.reshape(k_new, b_new)),
            valid=jnp.asarray(sel.reshape(k_new, b_new)),
            rowid=jnp.asarray(new_rid.reshape(k_new, b_new)),
        )

    # -- query ----------------------------------------------------------------

    def _refresh_coarse_locked(self) -> jnp.ndarray:
        """Bring the derived int4 bank up to date (called under the lock
        before a two-stage search).  Full re-derive on shape changes /
        recluster; per-cluster repack (pow2-padded id list, idempotent
        duplicates) after ordinary inserts."""
        if self._coarse_bank is None or self._coarse_stale:
            self._coarse_bank = derive_coarse(self._state.vectors)
            self._coarse_stale = False
            self._coarse_dirty.clear()
            return self._coarse_bank
        if self._coarse_dirty:
            ks = np.fromiter(self._coarse_dirty, dtype=np.int64)
            self._coarse_dirty.clear()
            if len(ks) > self._state.n_clusters // 4:
                self._coarse_bank = derive_coarse(self._state.vectors)
            else:
                m = 1 << max(0, int(len(ks) - 1).bit_length())
                ks = np.pad(ks, (0, m - len(ks)), mode="edge")
                self._coarse_bank = update_coarse(
                    self._coarse_bank,
                    self._state.vectors,
                    jnp.asarray(ks, dtype=jnp.int32),
                )
        return self._coarse_bank

    def search_dispatch(
        self, queries: np.ndarray, k: int, probes: int | None = None
    ):
        """Dispatch a batched query; returns fetch() -> (dist, rowids).

        The device steps are issued under the index lock; the returned
        closure blocks on the readback and may run OUTSIDE the lock.
        Safe on a single ordered device stream: a later insert's
        donated-buffer step executes strictly after these kernels, and
        the fetched arrays are fresh outputs, never bank aliases.  This
        is what lets the serving path keep several device batches in
        flight (MicroBatcher pipeline depth).
        """
        probes = probes or self.probes
        queries = np.asarray(queries, dtype=np.float32)
        single = queries.ndim == 1
        if single:
            queries = queries[None, :]
        n, d = queries.shape
        if d != self.dims:
            raise ValueError(f"dimension mismatch: index {self.dims}, got {d}")
        outs_d, outs_i = [], []
        with self._lock:
            state = self._state
            clustered = self._clustered
            two_stage = clustered and self.coarse
            coarse_bank = self._refresh_coarse_locked() if two_stage else None
            for off in range(0, n, QCHUNK):
                blk = queries[off : off + QCHUNK]
                m = len(blk)
                # pad to a small bucket set so the jit cache stays small
                b = next(s for s in (8, 32, 128, QCHUNK) if m <= s)
                if b != m:
                    blk = np.pad(blk, ((0, b - m), (0, 0)))
                if two_stage:
                    cand = min(
                        max(self.rescore * k, 64),
                        min(probes, self.n_clusters) * state.bucket,
                    )
                    dd, ii = search_two_stage(
                        state,
                        coarse_bank,
                        jnp.asarray(blk),
                        self.space,
                        k,
                        probes,
                        cand,
                    )
                elif clustered and self._kernel:
                    dd, ii = search_clustered_kernel(
                        state, jnp.asarray(blk), self.space, k, probes
                    )
                elif clustered:
                    dd, ii = search_clustered(
                        state, jnp.asarray(blk), self.space, k, probes
                    )
                else:
                    dd, ii = search_flat(state, jnp.asarray(blk), self.space, k)
                outs_d.append(dd[:m])
                outs_i.append(ii[:m])

        def fetch() -> tuple[np.ndarray, np.ndarray]:
            # all chunk dispatches are in flight — fetch everything in one
            # pipelined device_get (async host copies issued up front)
            d_h, i_h = jax.device_get((outs_d, outs_i))
            dist = np.concatenate(d_h)
            ids = np.concatenate(i_h).astype(np.int64)
            ids[~np.isfinite(dist)] = -1
            if single:
                return dist[0], ids[0]
            return dist, ids

        return fetch

    def search(
        self, queries: np.ndarray, k: int, probes: int | None = None
    ) -> tuple[np.ndarray, np.ndarray]:
        """(dist[n, k] ascending, rowids[n, k]); absent results (-inf, -1)."""
        return self.search_dispatch(queries, k, probes)()

    # -- persistence ------------------------------------------------------

    def save(self, path: str) -> None:
        """Snapshot the bucketed bank to one npz (uncompressed: int8
        banks at the 10M tier are multi-GB and near-incompressible; the
        graph backend's compressed variant lives in core/persist.py).
        Closes the same gap as core/persist.py — the reference rebuilds
        from the source DB on every restart (SURVEY §5)."""
        import json
        from dataclasses import asdict

        with self._lock:
            s = self._state
            meta = {
                "format": 1,
                "kind": "ivf",
                "params": asdict(self.params),
                "dtype": self.dtype,
                "probes": self.probes,
                "cluster_min": self.cluster_min,
                "rows_per_bucket": self.rows_per_bucket,
                "coarse": self.coarse,
                "rescore": self.rescore,
                "clustered": self._clustered,
                "clustered_at": self._clustered_at,
                "n_live": self._n_live,
                "next_rowid": self._next_rowid,
                "free": {str(c): v for c, v in self._free.items()},
            }
            vectors = (
                np.asarray(s.vectors)
                if self.dtype != "bfloat16"
                # bf16 has no portable npz encoding; ride as f32
                else np.asarray(s.vectors.astype(jnp.float32))
            )
            atomic_savez(
                path,
                vectors=vectors,
                scales=np.asarray(s.scales),
                valid=np.asarray(s.valid),
                rowid=np.asarray(s.rowid),
                centroids=np.asarray(s.centroids.astype(jnp.float32)),
                n_used=self._n_used,
                meta=np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8),
            )

    @classmethod
    def load(cls, path: str) -> "IvfIndex":
        import json

        with np.load(path) as z:
            meta = json.loads(bytes(z["meta"]).decode())
            if meta.get("kind") != "ivf":
                raise ValueError("not an ivf snapshot (use core.persist.load)")
            idx = cls.__new__(cls)
            idx.params = IndexParams(**meta["params"])
            idx.space = idx.params.space
            idx.dtype = meta["dtype"]
            idx.dims = idx.params.dimensions
            idx.probes = meta["probes"]
            idx.cluster_min = meta["cluster_min"]
            idx.rows_per_bucket = meta.get("rows_per_bucket", ROWS_PER_BUCKET)
            # coarse bank is derived, not persisted — rebuilt on first use
            idx.coarse = (
                meta.get("coarse", os.environ.get("VST_IVF_COARSE") == "1")
                and idx.dtype == "int8"
                and idx.dims % 2 == 0
            )
            idx._coarse_bank = None
            idx._coarse_stale = True
            idx._coarse_dirty = set()
            idx.rescore = meta.get("rescore", 8)
            idx._clustered = meta["clustered"]
            idx._clustered_at = meta["clustered_at"]
            idx._n_live = meta["n_live"]
            idx._next_rowid = meta["next_rowid"]
            idx._free = {int(c): list(v) for c, v in meta["free"].items()}
            idx._dirty = set()
            idx._n_used = np.asarray(z["n_used"], dtype=np.int64)
            valid = np.asarray(z["valid"])
            rowid = np.asarray(z["rowid"])
            idx._valid_h = valid
            idx._rowid_h = np.where(valid, rowid.astype(np.int64), -1)
            idx._loc = np.full((max(idx._next_rowid, 1), 2), -1, dtype=np.int64)
            ks, poss = np.nonzero(valid)
            live_ids = rowid[ks, poss].astype(np.int64)
            idx._loc[live_ids, 0] = ks
            idx._loc[live_ids, 1] = poss
            idx._lock = threading.Lock()
            idx._kernel = scan_kernel_for(jax.devices()[0].platform)
            idx._state = IvfState(
                centroids=jnp.asarray(z["centroids"]).astype(
                    _compute_dtype(idx.dtype)
                ),
                vectors=jnp.asarray(z["vectors"]).astype(
                    _storage_dtype(idx.dtype)
                ),
                scales=jnp.asarray(z["scales"]),
                valid=jnp.asarray(valid),
                rowid=jnp.asarray(rowid),
            )
        return idx

    def exact_search(
        self, queries: np.ndarray, k: int
    ) -> tuple[np.ndarray, np.ndarray]:
        """Brute-force oracle over the same bank (recall measurement)."""
        queries = np.asarray(queries, dtype=np.float32)
        single = queries.ndim == 1
        if single:
            queries = queries[None, :]
        with self._lock:
            d, i = search_flat(
                self._state, jnp.asarray(queries), self.space, k, approx=False
            )
        d, i = jax.device_get((d, i))
        i = i.astype(np.int64)
        i[~np.isfinite(d)] = -1
        if single:
            return d[0], i[0]
        return d, i
