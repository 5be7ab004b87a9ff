"""Centroid router construction — the HNSW-upper-layers role, batched.

The reference's usearch HNSW reaches a query's neighbourhood through
log-many upper graph layers walked serially (src/index/usearch.rs —
C++ HNSW internals).  Serial pointer descent is the wrong shape for a
matrix machine, and the flat replacement — one matmul over a strided
sample — stops scaling past ~2M rows per device (the sample
gather and the [Q, S] distance matrix both grow linearly with the bank).

This module builds the two-level replacement:

  centroids [K, D]   k-means centroids of the bank (dense, matmul-scored:
                     the "upper layers" collapsed into ONE matmul)
  members   [K, Bm]  per-centroid ring of member slot ids (entry
                     candidates; ring-replaced, SENTINEL-padded)
  m_cnt     [K]      total assignments per centroid (ring write cursor)

Query-time routing (core/graph.py::routing_entries) is then:
one [Q, K] matmul → top-`probes` clusters → gather+score their ring
members (≤ probes × Bm rows per query) → best `entry_points` seed the
beam.  Nothing in the hot path scales with the bank size except the
centroid count K, which grows ~N/64.

Construction is device-side k-means: sampled init + a few Lloyd
iterations (assignment = chunked matmuls, update = scatter-add
segment means), then a full assignment pass fills the member rings.
Incremental maintenance happens at insert time (core/build.py calls
`ring_assign` for every new batch); the router is rebuilt from scratch
when the bank doubles (SlotIndex growth policy), which keeps centroids
tracking the data distribution without any device-side re-clustering in
the hot path.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from . import distance as dist_mod
from .graph import GraphConfig, GraphState, gather_vectors
from .topk import SENTINEL, rank_in_run

# Assignment matmul chunk: rows scored against the centroid bank per step.
ASSIGN_CHUNK = 4096
# Lloyd refinement sample cap — k-means quality saturates long before the
# full bank is used, and the sample gather is a one-time cost per rebuild.
LLOYD_SAMPLE = 1 << 18
LLOYD_ITERS = 2


def route_k_for(rows: int) -> int:
    """Centroid count policy: ~64 rows per cluster, a multiple of 128, capped.

    At 1M rows → 16K centroids (a [Q, 16K] routing matmul), at 8M → 64K.
    The cap bounds the routing matmul and centroid-bank memory; beyond
    512M rows per device the bank itself no longer fits anyway.
    """
    k = min(max(rows // 64, 4096), 1 << 16)
    return (k // 128) * 128


@functools.partial(jax.jit, static_argnames=("space",))
def assign(
    centroids: jnp.ndarray,  # [K, D] compute dtype
    vecs: jnp.ndarray,  # [M, D] compute dtype (preprocessed)
    space: str,
) -> jnp.ndarray:  # [M] int32 nearest-centroid id
    d = dist_mod.pairwise(vecs, centroids, space)
    return jnp.argmin(d, axis=-1).astype(jnp.int32)



def ring_assign(
    members: jnp.ndarray,  # [K, Bm] int32
    m_cnt: jnp.ndarray,  # [K] int32
    cids: jnp.ndarray,  # [M] int32 assigned centroid per row
    slots: jnp.ndarray,  # [M] int32 row ids
    live: jnp.ndarray,  # [M] bool
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Scatter a batch of rows into their centroids' member rings.

    Collision-free within the batch: rows are sorted by centroid and
    ranked within each run, so two same-cluster rows land at distinct
    ring positions (cursor + rank) mod Bm.
    """
    K, Bm = members.shape
    key = jnp.where(live, cids, jnp.int32(K))  # dead lanes sort last
    key_s, slot_s = jax.lax.sort((key, slots), num_keys=1)
    rank = rank_in_run(key_s)
    cursor = jnp.take(m_cnt, jnp.clip(key_s, 0, K - 1))
    pos = (cursor + rank) % Bm
    ok = key_s < K
    row = jnp.where(ok, key_s, K)  # OOB rows dropped by the scatter
    members = members.at[row, pos].set(slot_s, mode="drop")
    m_cnt = m_cnt.at[row].add(ok.astype(jnp.int32), mode="drop")
    return members, m_cnt


_ring_assign = jax.jit(ring_assign)


# --- jittable per-chunk steps ---------------------------------------------
# Every step takes only traced state + a python chunk offset, so the same
# functions drive the single-device build (host loop below) and the
# sharded build (the same loop with each step wrapped in shard_map,
# shard/sharded_index.py) — per-shard frontiers are handled by masking.


def seed_centroids(
    state: GraphState, cfg: GraphConfig, route_k: int
) -> jnp.ndarray:
    """Strided sample of allocated rows as initial centroids [K, D]."""
    f = jnp.maximum(state.frontier, 1)
    stride = jnp.maximum(f // route_k, 1)
    ids = ((jnp.arange(route_k, dtype=jnp.int32) * stride) % f).astype(
        jnp.int32
    )
    centroids, _ = gather_vectors(state, ids, cfg)
    return centroids.astype(cfg.compute_dtype)


def lloyd_chunk(
    state: GraphState,
    cfg: GraphConfig,
    centroids: jnp.ndarray,  # [K, D]
    off: int,
    sample_n_max: int,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Partial segment sums/counts for sample rows [off, off+CHUNK)."""
    k = centroids.shape[0]
    f = jnp.maximum(state.frontier, 1)
    sample_n = jnp.minimum(f, sample_n_max)
    stride = jnp.maximum(f // sample_n, 1)
    lane = off + jnp.arange(ASSIGN_CHUNK, dtype=jnp.int32)
    ids = ((lane * stride) % f).astype(jnp.int32)
    vecs, _ = gather_vectors(state, ids, cfg)
    vecs = vecs.astype(cfg.compute_dtype)
    live = (
        jnp.take(state.valid, jnp.clip(ids, 0, state.capacity - 1))
        & (lane < sample_n)
    )
    cid = assign(centroids, vecs, cfg.space)
    cid = jnp.where(live, cid, k)  # dead lanes drop out of the scatter
    sums = jnp.zeros((k, vecs.shape[1]), dtype=jnp.float32)
    cnts = jnp.zeros((k,), dtype=jnp.float32)
    sums = sums.at[cid].add(vecs.astype(jnp.float32), mode="drop")
    cnts = cnts.at[cid].add(1.0, mode="drop")
    return sums, cnts


def lloyd_finish(
    centroids: jnp.ndarray, sums: jnp.ndarray, cnts: jnp.ndarray, space: str
) -> jnp.ndarray:
    mean = sums / jnp.maximum(cnts, 1.0)[:, None]
    if space == "cosine":
        mean = dist_mod.normalize(mean)
    return jnp.where((cnts > 0)[:, None], mean.astype(centroids.dtype), centroids)


def fill_chunk(
    state: GraphState,
    cfg: GraphConfig,
    centroids: jnp.ndarray,
    members: jnp.ndarray,
    m_cnt: jnp.ndarray,
    off: int,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Assign rows [off, off+CHUNK) into member rings."""
    ids = off + jnp.arange(ASSIGN_CHUNK, dtype=jnp.int32)
    vecs, _ = gather_vectors(state, ids, cfg)
    live = jnp.take(state.valid, jnp.clip(ids, 0, state.capacity - 1)) & (
        ids < state.frontier
    )
    cid = assign(centroids, vecs.astype(cfg.compute_dtype), cfg.space)
    return ring_assign(members, m_cnt, cid, ids, live)


# `off` rides as a TRACED int32 scalar (the kernels only use it as
# `off + jnp.arange(...)`): a static `off` would compile one XLA
# executable per distinct chunk offset — ~2000 compilations of
# fill_chunk alone for a router build over an 8M-row bank.
_seed_centroids = jax.jit(seed_centroids, static_argnames=("cfg", "route_k"))
_lloyd_chunk = jax.jit(lloyd_chunk, static_argnames=("cfg", "sample_n_max"))
_lloyd_finish = jax.jit(lloyd_finish, static_argnames=("space",))
_fill_chunk = jax.jit(fill_chunk, static_argnames=("cfg",))


def build_router(
    state: GraphState,
    cfg: GraphConfig,
    route_k: int,
    members_per: int,
    lloyd_iters: int = LLOYD_ITERS,
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Cluster the bank and fill member rings (single-device driver).

    Returns (centroids [route_k, D], members [route_k, Bm], m_cnt [route_k])
    ready to slot into a GraphState whose cfg has route_k set.
    """
    frontier = int(state.frontier)
    assert frontier >= route_k, "not enough rows to seed centroids"

    centroids = _seed_centroids(state, cfg, route_k)

    sample_n = min(frontier, LLOYD_SAMPLE)
    for _ in range(lloyd_iters):
        sums = jnp.zeros((route_k, cfg.dims), dtype=jnp.float32)
        cnts = jnp.zeros((route_k,), dtype=jnp.float32)
        for off in range(0, sample_n, ASSIGN_CHUNK):
            s, c = _lloyd_chunk(state, cfg, centroids, off, LLOYD_SAMPLE)
            sums = sums + s
            cnts = cnts + c
        centroids = _lloyd_finish(centroids, sums, cnts, cfg.space)

    members = jnp.full((route_k, members_per), SENTINEL, dtype=jnp.int32)
    m_cnt = jnp.zeros((route_k,), dtype=jnp.int32)
    for off in range(0, frontier, ASSIGN_CHUNK):
        members, m_cnt = _fill_chunk(state, cfg, centroids, members, m_cnt, off)
    return centroids, members, m_cnt
