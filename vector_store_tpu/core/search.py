"""Batched beam search over the device-resident graph.

Device replacement for usearch's C++ HNSW traversal (reference:
src/index/usearch.rs:274-277 — `idx.search` on a rayon pool).  The CPU
version walks one query at a time through pointer chains; here a whole
block of queries advances in lockstep through a fixed number of
expand-gather-score-merge rounds:

  per round (lax.scan body, all shapes static):
    1. pick the best `B` unexpanded pool entries per query        (top_k)
    2. gather their adjacency rows            neighbors[sel] → [Q, B*R]
    3. gather candidate vectors + batched mat-vec distances
    4. sort-based dedup + merge into the per-query pool         (topk.py)

The pool doubles as the visited set: merge_pool keeps the expanded flag of
entries already processed, so re-discovered nodes are never re-expanded —
no hash-table visited set needed (the C++ side uses one internally).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from . import distance as dist_mod
from .graph import GraphConfig, GraphState, gather_vectors, routing_entries
from .topk import INF, SENTINEL, merge_pool, topk_ascending


def _init_pool(
    state: GraphState, queries: jnp.ndarray, cfg: GraphConfig
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Seed the pool from the routing stage; pad to P with sentinels."""
    Q = queries.shape[0]
    P = cfg.ef_search
    e_dist, e_ids = routing_entries(state, queries, cfg)  # [Q, E]
    E = e_ids.shape[1]
    if E > P:
        # ef_search < entry_points: keep the best P entries rather than
        # crash jnp.pad with a negative width deep inside the trace
        e_dist, pos = topk_ascending(e_dist, P)
        e_ids = jnp.take_along_axis(e_ids, pos, axis=-1)
        E = P
    pad = P - E
    pool_dist = jnp.pad(e_dist, ((0, 0), (0, pad)), constant_values=jnp.inf)
    pool_ids = jnp.pad(e_ids, ((0, 0), (0, pad)), constant_values=2**31 - 1)
    pool_exp = jnp.zeros((Q, P), dtype=bool)
    return pool_dist, pool_ids, pool_exp


def _expand_round(state: GraphState, queries: jnp.ndarray, cfg: GraphConfig, pool):
    pool_dist, pool_ids, pool_exp = pool
    Q, P = pool_dist.shape
    B, R = cfg.beam_width, cfg.degree

    # 1. best B unexpanded entries per query.
    frontier_dist = jnp.where(pool_exp, INF, pool_dist)
    _, sel_pos = topk_ascending(frontier_dist, B)  # [Q, B] positions in pool
    sel_ids = jnp.take_along_axis(pool_ids, sel_pos, axis=-1)  # [Q, B]
    sel_live = jnp.take_along_axis(frontier_dist, sel_pos, axis=-1) < INF

    # 2. mark them expanded (scatter via one-hot OR — P is small).
    onehot = jax.nn.one_hot(sel_pos, P, dtype=bool)  # [Q, B, P]
    onehot = onehot & sel_live[..., None]
    pool_exp = pool_exp | jnp.any(onehot, axis=1)

    # 3. gather adjacency rows → candidate ids [Q, B*R].
    safe_sel = jnp.clip(sel_ids, 0, state.capacity - 1)
    nbrs = jnp.take(state.neighbors, safe_sel, axis=0)  # [Q, B, R]
    nbrs = jnp.where(sel_live[..., None], nbrs, SENTINEL)
    cand_ids = nbrs.reshape(Q, B * R)

    # 4. gather vectors, score, mask sentinels.
    cand_vecs, is_sent = gather_vectors(state, cand_ids, cfg)  # [Q, B*R, D]
    cand_dist = dist_mod.gathered(queries, cand_vecs, cfg.space)
    cand_dist = jnp.where(is_sent, INF, cand_dist)
    cand_ids = jnp.where(is_sent, SENTINEL, cand_ids)

    # 5. merge into pool (dedup keeps expanded copies).
    if cfg.approx_topk:
        from .topk import merge_pool_fast

        return merge_pool_fast(pool_dist, pool_ids, pool_exp, cand_dist, cand_ids)
    return merge_pool(pool_dist, pool_ids, pool_exp, cand_dist, cand_ids)


def search_pool(
    state: GraphState,
    queries: jnp.ndarray,  # [Q, D] already preprocessed (unit-norm if cosine)
    cfg: GraphConfig,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Run the fixed-trip beam search; returns the full sorted pool
    (dist[Q, P], ids[Q, P]) including tombstoned nodes (callers that serve
    user queries filter tombstones; the insert path deliberately keeps them
    as traversable waypoints)."""

    pool = _init_pool(state, queries, cfg)

    def body(pool, _):
        return _expand_round(state, queries, cfg, pool), None

    pool, _ = jax.lax.scan(body, pool, None, length=cfg.search_iters)
    pool_dist, pool_ids, _ = pool
    return pool_dist, pool_ids


def search_impl(
    state: GraphState,
    queries: jnp.ndarray,  # [Q, D] raw (preprocessing applied here)
    cfg: GraphConfig,
    k: int,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Public ANN query step: top-k live nodes per query.

    Returns (dist[Q, k] ascending, ids[Q, k]); absent results are
    (+inf, SENTINEL) — the reference returns fewer-than-k hits the same way
    by truncation (src/index/usearch.rs:284-303).

    Unjitted body — call `search` for the compiled single-device version,
    or use inside `shard_map` (shard/sharded_index.py).
    """
    queries = dist_mod.preprocess(
        queries.astype(jnp.float32), cfg.space
    ).astype(cfg.compute_dtype)
    pool_dist, pool_ids = search_pool(state, queries, cfg)

    # Tombstone filter: dead nodes helped traversal but must not be returned
    # (reference remove semantics: usearch.rs:235-249).
    safe = jnp.clip(pool_ids, 0, state.capacity - 1)
    alive = jnp.take(state.valid, safe) & (pool_ids != SENTINEL)
    pool_dist = jnp.where(alive, pool_dist, INF)
    pool_ids = jnp.where(alive, pool_ids, SENTINEL)

    k_eff = min(k, pool_dist.shape[1])
    top_d, pos = topk_ascending(pool_dist, k_eff)
    top_i = jnp.take_along_axis(pool_ids, pos, axis=-1)
    if k > k_eff:
        padn = k - k_eff
        top_d = jnp.pad(top_d, ((0, 0), (0, padn)), constant_values=jnp.inf)
        top_i = jnp.pad(top_i, ((0, 0), (0, padn)), constant_values=2**31 - 1)
    return top_d, top_i


search = jax.jit(search_impl, static_argnames=("cfg", "k"))
