"""Device-resident ANN graph index — state and lifecycle.

This is the device replacement for the reference's C++ usearch HNSW
index (reference: src/index/usearch.rs:89-99).  Instead of a
pointer-chasing multi-layer heap structure mutated in place, the index
is a set of fixed-shape arrays living in device memory, updated
functionally by jitted steps:

  vectors   [C, D]   storage dtype (f32 / bf16 / int8+scale), ingest-
                     preprocessed (unit-norm for cosine space)
  neighbors [C, R]   int32 fixed-degree adjacency, SENTINEL-padded
  nbr_dist  [C, R]   f32 cached edge lengths (drives degree-clamped
                     reverse-edge updates without re-gathering vectors)
  valid     [C]      bool liveness (False = tombstone, reference remove
                     semantics: src/index/usearch.rs:235-249)
  size      []       int32 live count (reference count(): usearch.rs:308-311)
  frontier  []       int32 rows allocated so far (host-assigned, sequential)

Design notes (accelerator-first, not a translation):
  * single-layer navigable graph with a *routing stage* instead of HNSW's
    upper layers: each query first scores a strided sample of the bank with
    one matmul and starts the beam from the best hits.  Hierarchy-free
    means no serial per-level descent — the whole search is a fixed-trip
    `lax.scan`.
  * capacity is static per compilation; growth is a host-side buffer
    reallocation that doubles C (the reference grows usearch capacity when
    free space dips below a third: src/index/usearch.rs:60-66,201-212).
  * slot allocation/free-list lives on the host (engine/keymap.py), so the
    device steps never see dynamic shapes.
"""

from __future__ import annotations

from dataclasses import dataclass, fields
from typing import NamedTuple

import jax
import jax.numpy as jnp

from . import distance as dist_mod
from .topk import SENTINEL

INVALID = 2**31 - 1  # SENTINEL as python int


class GraphState(NamedTuple):
    vectors: jnp.ndarray  # [C, D] storage dtype (f32 / bf16 / int8)
    scales: jnp.ndarray  # [C] f32 per-row dequant scale (1.0 unless int8)
    neighbors: jnp.ndarray  # [C, R] int32
    nbr_dist: jnp.ndarray  # [C, R] f32
    valid: jnp.ndarray  # [C] bool
    size: jnp.ndarray  # [] int32
    frontier: jnp.ndarray  # [] int32
    # Hierarchical router (core/cluster.py) — the HNSW-upper-layers role.
    # Dummy 1-row arrays when cfg.route_k == 0 (flat strided routing).
    route_centroids: jnp.ndarray  # [K', D] compute dtype
    route_members: jnp.ndarray  # [K', Bm] int32 ring of member slots
    route_cnt: jnp.ndarray  # [K'] int32 ring cursors

    @property
    def capacity(self) -> int:
        return self.vectors.shape[0]

    @property
    def dims(self) -> int:
        return self.vectors.shape[1]


@dataclass(frozen=True)
class GraphConfig:
    """Static (hashable) compile-time configuration of the graph kernels.

    Maps the reference's usearch knobs (src/lib.rs:147-211) onto the
    batched design: `connectivity` → degree R, `expansion_search` → beam pool P,
    `expansion_add` → insert-time pool.
    """

    dims: int
    degree: int = 32  # R, usearch connectivity
    ef_search: int = 64  # beam pool P
    ef_add: int = 128  # insert candidate pool
    beam_width: int = 4  # nodes expanded per search iteration
    iters: int = 0  # 0 → derived: max(8, ef_search // beam_width)
    space: str = "cosine"
    dtype: str = "bfloat16"  # storage dtype: "float32" | "bfloat16" | "int8"
    routing_sample: int = 1024  # strided sample scored by matmul for entry
    entry_points: int = 8  # entries per query taken from the routing stage
    # Hierarchical routing (two-level, core/cluster.py).  route_k > 0
    # switches routing_entries from the flat strided sample to:
    # [Q, route_k] centroid matmul → top `route_probes` clusters →
    # score their ring members → top entry_points seed the beam.
    route_k: int = 0  # centroid count (0 = flat routing)
    route_members_per: int = 16  # ring size Bm per centroid
    route_probes: int = 8  # clusters probed per query
    prune_alpha: float = 1.2  # robust-prune slack (DiskANN-style)
    # Hybrid edge selection: the first `keep_nearest` edges are the plain
    # nearest candidates (guarantees the true k-NN stay edge-covered in
    # tight clusters); the rest are α-diverse (keeps long-range
    # navigability).  0 → pure diversity prune.  Default: half degree.
    keep_nearest: int = -1  # -1 → degree // 2
    # approx_min_k for the routing reduction and the sort-free pool merge.
    # On a GPU JAX lowers approx_min_k as sort-and-slice (exact); the
    # merge is sort-free either way.
    approx_topk: bool = True

    @classmethod
    def from_meta(cls, meta: dict, **overrides) -> "GraphConfig":
        """Config from a snapshot's `cfg` dict.  Keys of retired fields
        (`fused_gather`, an execution choice older snapshots recorded)
        are dropped, so old snapshots still load."""
        names = {f.name for f in fields(cls)}
        kept = {k: v for k, v in {**meta, **overrides}.items() if k in names}
        return cls(**kept)

    @property
    def n_keep_nearest(self) -> int:
        return self.degree // 2 if self.keep_nearest < 0 else self.keep_nearest

    @property
    def search_iters(self) -> int:
        return self.iters if self.iters > 0 else max(8, self.ef_search // self.beam_width)

    @property
    def jdtype(self):
        return {
            "float32": jnp.float32,
            "bfloat16": jnp.bfloat16,
            "int8": jnp.int8,
        }[self.dtype]

    @property
    def quantized(self) -> bool:
        return self.dtype == "int8"

    @property
    def compute_dtype(self):
        """Dtype distance math runs in (int8 banks dequantise to bf16)."""
        return jnp.float32 if self.dtype == "float32" else jnp.bfloat16


def router_shapes(cfg: GraphConfig) -> tuple[int, int]:
    """(K', Bm') array dims for the router fields — 1-wide dummies when
    hierarchical routing is off, so flat-mode states stay tiny."""
    if cfg.route_k > 0:
        return cfg.route_k, cfg.route_members_per
    return 1, 1


def init_router(cfg: GraphConfig) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    k, bm = router_shapes(cfg)
    return (
        jnp.zeros((k, cfg.dims), dtype=cfg.compute_dtype),
        jnp.full((k, bm), SENTINEL, dtype=jnp.int32),
        jnp.zeros((k,), dtype=jnp.int32),
    )


def init(cfg: GraphConfig, capacity: int) -> GraphState:
    """Fresh empty index with reserved capacity (usearch.rs:98-99 reserve)."""
    rc, rm, rn = init_router(cfg)
    return GraphState(
        vectors=jnp.zeros((capacity, cfg.dims), dtype=cfg.jdtype),
        scales=jnp.ones((capacity,), dtype=jnp.float32),
        neighbors=jnp.full((capacity, cfg.degree), INVALID, dtype=jnp.int32),
        nbr_dist=jnp.full((capacity, cfg.degree), jnp.inf, dtype=jnp.float32),
        valid=jnp.zeros((capacity,), dtype=bool),
        size=jnp.zeros((), dtype=jnp.int32),
        frontier=jnp.zeros((), dtype=jnp.int32),
        route_centroids=rc,
        route_members=rm,
        route_cnt=rn,
    )


def grow(state: GraphState, new_capacity: int) -> GraphState:
    """Host-side capacity growth: pad every buffer (keeps contents).

    Mirrors the reference's reserve-when-low policy
    (src/index/usearch.rs:201-212) as an explicit reallocation event —
    jitted steps recompile once per capacity, then hit the cache.
    """
    c = state.capacity
    assert new_capacity > c
    pad = new_capacity - c
    return GraphState(
        vectors=jnp.pad(state.vectors, ((0, pad), (0, 0))),
        scales=jnp.pad(state.scales, (0, pad), constant_values=1.0),
        neighbors=jnp.pad(state.neighbors, ((0, pad), (0, 0)), constant_values=INVALID),
        nbr_dist=jnp.pad(state.nbr_dist, ((0, pad), (0, 0)), constant_values=jnp.inf),
        valid=jnp.pad(state.valid, (0, pad)),
        size=state.size,
        frontier=state.frontier,
        # router arrays are capacity-independent (rebuilt on growth events)
        route_centroids=state.route_centroids,
        route_members=state.route_members,
        route_cnt=state.route_cnt,
    )


def gather_rows(
    vectors: jnp.ndarray, ids: jnp.ndarray
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Gather vector rows for (possibly SENTINEL) ids.

    Returns (vecs, is_sentinel).  Sentinel ids are clipped into range for the
    gather and must be masked by the caller via the returned flag.
    """
    is_sent = ids >= vectors.shape[0]
    safe = jnp.clip(ids, 0, vectors.shape[0] - 1)
    return jnp.take(vectors, safe, axis=0), is_sent


def gather_vectors(
    state: GraphState, ids: jnp.ndarray, cfg: GraphConfig
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Gather rows in compute dtype, dequantising int8 banks on the fly.

    The gather itself moves the narrow (1 byte/dim) representation from
    device memory; dequantisation happens after the gather, which is the
    whole point of the int8 mode (BASELINE config 3 memory parity)."""
    rows, is_sent = gather_rows(state.vectors, ids)
    if cfg.quantized:
        safe = jnp.clip(ids, 0, state.capacity - 1)
        sc = jnp.take(state.scales, safe)
        rows = (rows.astype(jnp.float32) * sc[..., None]).astype(
            cfg.compute_dtype
        )
    return rows, is_sent


def store_vectors(vecs_f32: jnp.ndarray, cfg: GraphConfig):
    """Preprocessed f32 rows → (storage rows, scales) for the bank."""
    from .quantize import quantize_rows

    if cfg.quantized:
        return quantize_rows(vecs_f32)
    return vecs_f32.astype(cfg.jdtype), jnp.ones(
        (vecs_f32.shape[0],), dtype=jnp.float32
    )


def _routed_entries(
    state: GraphState, queries: jnp.ndarray, cfg: GraphConfig
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Two-level entry selection via the centroid router (core/cluster.py):
    one [Q, K] matmul against the dense centroid bank → top `route_probes`
    clusters → gather + score their ring members → best `entry_points`.

    Unlike the flat path, nothing here gathers O(bank/8) rows per call —
    the centroid bank is dense and stationary, and the per-query member
    gather is ≤ probes × Bm rows.  This is what lets graph recall hold
    past ~2M rows per device (the flat sample's hard cap).
    """
    Q = queries.shape[0]
    K, Bm = state.route_members.shape
    cd = dist_mod.pairwise(
        queries, state.route_centroids.astype(queries.dtype), cfg.space
    )  # [Q, K]
    p = min(cfg.route_probes, K)
    if cfg.approx_topk and K >= 4096:
        from .topk import topk_ascending_approx

        _, cids = topk_ascending_approx(cd, p)
    else:
        _, cids = jax.lax.top_k(-cd, p)
    cand = jnp.take(state.route_members, cids, axis=0).reshape(Q, p * Bm)
    vecs, is_sent = gather_vectors(state, cand, cfg)  # [Q, p*Bm, D]
    d = dist_mod.gathered(queries, vecs, cfg.space)
    d = jnp.where(is_sent, jnp.inf, d)
    E = min(cfg.entry_points, p * Bm)
    neg, pos = jax.lax.top_k(-d, E)
    dist = -neg
    ids = jnp.take_along_axis(cand, pos, axis=-1)
    ids = jnp.where(jnp.isinf(dist), SENTINEL, ids)
    return dist, ids


def routing_entries(
    state: GraphState,
    queries: jnp.ndarray,  # [Q, D] preprocessed
    cfg: GraphConfig,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Entry-point selection: score a strided sample of allocated rows with
    one matmul and return the best `entry_points` per query.

    This replaces HNSW's upper-layer greedy descent with a single dense
    block — a batched way to cut graph hops.  With cfg.route_k set,
    the flat sample gives way to the two-level centroid router.
    Returns (dist[Q, E], ids[Q, E]).
    """
    if cfg.route_k > 0:
        return _routed_entries(state, queries, cfg)
    C = state.capacity
    S = min(cfg.routing_sample, C)
    # Strided sample over the full capacity; rows beyond the frontier are
    # masked.  Sequential host allocation makes a stride a uniform sample
    # over insertion order.
    stride = max(C // S, 1)
    sample_ids = (jnp.arange(S, dtype=jnp.int32) * stride) % C
    in_range = sample_ids < state.frontier
    sample_vecs, _ = gather_vectors(state, sample_ids, cfg)  # [S, D]
    d = dist_mod.pairwise(queries, sample_vecs, cfg.space)  # [Q, S]
    d = jnp.where(in_range[None, :], d, jnp.inf)
    E = min(cfg.entry_points, S)
    if cfg.approx_topk and S >= 1024:
        from .topk import topk_ascending_approx

        dist, pos = topk_ascending_approx(d, E)
    else:
        neg, pos = jax.lax.top_k(-d, E)
        dist = -neg
    ids = jnp.take(sample_ids, pos)
    ids = jnp.where(jnp.isinf(dist), SENTINEL, ids)
    return dist, ids
