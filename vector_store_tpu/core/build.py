"""Batched incremental graph construction (insert / delete).

Device replacement for usearch's `add` / `remove` (reference:
src/index/usearch.rs:174-249).  The CPU library inserts one vector at a
time under a RwLock; here a whole block of M new vectors is grafted into
the graph by one jitted functional step with donated buffers:

  1. candidate generation — beam-search the *existing* graph (pool size
     `ef_add`) plus an M×M brute-force block among the batch itself (which
     also bootstraps the very first batches when the graph is empty);
  2. robust prune (DiskANN-style α rule) selects ≤R diverse forward
     neighbours per new node — a vectorised `lax.scan` over the sorted
     candidate pool with the candidate-pairwise distances done as one
     batched matmul;
  3. forward edges + cached edge lengths written with row scatters;
  4. reverse edges applied in `G` collision-free rounds: edges are sorted
     by target, ranked within each target run, and round r applies rank-r
     edges — every round touches each target row at most once, so the
     gather → degree-clamped-replace → scatter is race-free.  (The
     reference gets this serialisation for free from its actor mailbox +
     RwLock, src/index/usearch.rs:98,200.)

Deletes are tombstones (valid=False): dead nodes keep routing traffic but
are filtered from results, matching usearch's lazy remove semantics.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp

from . import distance as dist_mod
from .graph import GraphConfig, GraphState, gather_vectors, store_vectors
from .search import search_pool
from .topk import INF, SENTINEL, topk_ascending, rank_in_run

# Reverse-edge collision rounds: edges ranked ≥ G per target are dropped
# (rare; only when many same-batch nodes pick one hub neighbour).
REVERSE_ROUNDS = 16


def _pairwise_batched(vecs: jnp.ndarray, space: str) -> jnp.ndarray:
    """[M, C, D] → per-node candidate-pairwise distances [M, C, C]."""
    dots = jax.lax.dot_general(
        vecs,
        vecs,
        dimension_numbers=(((2,), (2,)), ((0,), (0,))),
        preferred_element_type=jnp.float32,
    )
    if space == "dot":
        return -dots
    if space == "cosine":
        return 1.0 - dots
    sq = jnp.sum(jnp.square(vecs.astype(jnp.float32)), axis=-1)  # [M, C]
    return sq[:, :, None] + sq[:, None, :] - 2.0 * dots


def _robust_prune(
    cand_dist: jnp.ndarray,  # [M, C] ascending-sorted query→candidate dists
    cand_ids: jnp.ndarray,  # [M, C]
    cand_vecs: jnp.ndarray,  # [M, C, D]
    cfg: GraphConfig,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Select ≤R diverse neighbours per node (α-RobustPrune).

    Scanning candidates best-first: keep c unless some already-kept s has
    α·d(s, c) ≤ d(q, c); stop at R kept.  Returns (dist[M, R], ids[M, R])
    padded with (+inf, SENTINEL).
    """
    M, C = cand_dist.shape
    R = cfg.degree
    K_near = cfg.n_keep_nearest
    pd = _pairwise_batched(cand_vecs, cfg.space)  # [M, C, C]
    # comparison-only copies for the alpha rule: dot "distances" (-<a,b>)
    # can be negative, which inverts the alpha slack — multiplying a
    # negative LHS by alpha>1 makes domination FIRE MORE, over-pruning
    # diversity edges.  Shift both sides to non-negative by the
    # batch-wide minimum so alpha>1 strictly loosens domination, as
    # intended.  The returned distances stay unshifted.
    pd_cmp, cd_cmp = pd, cand_dist
    if cfg.space == "dot":
        m = jnp.minimum(
            jnp.min(jnp.where(jnp.isfinite(pd), pd, INF)),
            jnp.min(jnp.where(jnp.isfinite(cand_dist), cand_dist, INF)),
        )
        m = jnp.minimum(m, 0.0)
        pd_cmp = pd - m
        cd_cmp = cand_dist - m

    def body(carry, t):
        removed, kept, kept_cnt = carry
        # hybrid rule: the first K_near sorted candidates bypass the
        # domination check (pure nearest neighbours), the rest must
        # survive the α-diversity rule
        can_keep = (
            ((t < K_near) | ~removed[:, t])
            & (cand_dist[:, t] < INF)
            & (kept_cnt < R)
        )  # [M]
        kept = kept.at[:, t].set(can_keep)
        kept_cnt = kept_cnt + can_keep.astype(jnp.int32)
        # α rule: anything dominated by the newly kept candidate is removed.
        dominated = cfg.prune_alpha * pd_cmp[:, t, :] <= cd_cmp  # [M, C]
        removed = removed | (can_keep[:, None] & dominated)
        return (removed, kept, kept_cnt), None

    init = (
        jnp.zeros((M, C), dtype=bool),
        jnp.zeros((M, C), dtype=bool),
        jnp.zeros((M,), dtype=jnp.int32),
    )
    (_, kept, _), _ = jax.lax.scan(body, init, jnp.arange(C))

    sel_dist = jnp.where(kept, cand_dist, INF)
    sel_ids = jnp.where(kept, cand_ids, SENTINEL)
    top_d, pos = topk_ascending(sel_dist, R)
    top_i = jnp.take_along_axis(sel_ids, pos, axis=-1)
    top_i = jnp.where(jnp.isinf(top_d), SENTINEL, top_i)
    return top_d, top_i



def _apply_reverse_edges(
    neighbors: jnp.ndarray,  # [C, R]
    nbr_dist: jnp.ndarray,  # [C, R]
    tgt: jnp.ndarray,  # [E] edge targets (existing nodes)
    src: jnp.ndarray,  # [E] edge sources (new nodes)
    d: jnp.ndarray,  # [E] edge lengths
    e_live: jnp.ndarray,  # [E] bool
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Degree-clamped reverse-edge insertion, race-free by round."""
    C, R = neighbors.shape
    # Sort edges by (target, length): within a target run, shorter (better)
    # edges get lower ranks and therefore earlier rounds.
    sort_tgt = jnp.where(e_live, tgt, SENTINEL)
    tgt_s, d_s, src_s, live_s = jax.lax.sort(
        (sort_tgt, d, src, e_live.astype(jnp.int32)), num_keys=2
    )
    rank = rank_in_run(tgt_s)

    def round_body(r, carry):
        nbrs, ndist = carry
        act = (live_s == 1) & (rank == r) & (tgt_s != SENTINEL)
        t_safe = jnp.clip(tgt_s, 0, C - 1)
        rows_n = jnp.take(nbrs, t_safe, axis=0)  # [E, R]
        rows_d = jnp.take(ndist, t_safe, axis=0)
        worst = jnp.argmax(rows_d, axis=-1)  # [E]
        worst_d = jnp.take_along_axis(rows_d, worst[:, None], axis=-1)[:, 0]
        better = act & (d_s < worst_d)
        onehot = jax.nn.one_hot(worst, R, dtype=bool)  # [E, R]
        upd = onehot & better[:, None]
        new_n = jnp.where(upd, src_s[:, None], rows_n)
        new_d = jnp.where(upd, d_s[:, None], rows_d)
        t_scatter = jnp.where(act, tgt_s, C)  # OOB rows dropped
        nbrs = nbrs.at[t_scatter].set(new_n, mode="drop")
        ndist = ndist.at[t_scatter].set(new_d, mode="drop")
        return nbrs, ndist

    neighbors, nbr_dist = jax.lax.fori_loop(
        0, REVERSE_ROUNDS, round_body, (neighbors, nbr_dist)
    )
    return neighbors, nbr_dist


def insert_cfg(cfg: GraphConfig) -> GraphConfig:
    """Search configuration used for insert-time candidate generation.

    WIDE and SHALLOW (beam 16, pool ef_add/2, 4 rounds) where the
    serving beam is narrow and deep (4 × 32).  Two reasons, both found
    on another accelerator and not yet re-measured on the GPU:

    * the insert search was gather-count-bound, not byte-bound, so
      wall-clock tracks gathered-row count ≈ beam·degree·iters — fewer,
      wider rounds and a smaller pool are nearly free speed;
    * prune quality does NOT need a deep insert search: `insert_impl`
      prunes over min(ef_add, P+M) candidates drawn from the graph pool
      UNION the M×M batch block, so halving the search pool leaves the
      prune's candidate count unchanged (post-build recall was
      unchanged).

    The reference's expansion_add knob still scales the whole thing
    (usearch.rs: insert beam role): pool = ef_add/2, floor 32.
    """
    width = max(cfg.beam_width, 16)
    pool = max(32, cfg.ef_add // 2)
    return dataclasses.replace(
        cfg,
        ef_search=pool,
        beam_width=width,
        iters=max(4, pool // width),
    )


def insert_impl(
    state: GraphState,
    base_slot: jnp.ndarray,  # [] int32 — first of M contiguous fresh rows
    vecs: jnp.ndarray,  # [M, D] raw new vectors
    live: jnp.ndarray,  # [M] bool — padding lanes are False
    cfg: GraphConfig,
) -> GraphState:
    """Graft a batch of new nodes into the graph.  Returns the new state.

    The host allocates rows sequentially, so a batch always occupies the
    contiguous block [base_slot, base_slot + M); base_slot ≥ frontier.
    """
    M = vecs.shape[0]
    C = state.capacity
    slots = base_slot + jnp.arange(M, dtype=jnp.int32)
    vecs_f32 = dist_mod.preprocess(vecs.astype(jnp.float32), cfg.space)
    vecs = vecs_f32.astype(cfg.compute_dtype)

    # --- 1. candidates from the existing graph (pre-batch state).
    g_dist, g_ids = search_pool(state, vecs, insert_cfg(cfg))  # [M, P]

    # --- batch-internal candidates (bootstraps the empty graph too).
    b_dist = dist_mod.pairwise(vecs, vecs, cfg.space)  # [M, M]
    eye = jnp.eye(M, dtype=bool)
    b_mask = eye | ~live[None, :] | ~live[:, None]
    b_dist = jnp.where(b_mask, INF, b_dist)
    b_ids = jnp.where(b_mask, SENTINEL, jnp.broadcast_to(slots[None, :], (M, M)))

    # Graph ids (< frontier) and batch slots (≥ frontier) are disjoint, so a
    # plain concat needs no dedup.
    cand_dist = jnp.concatenate([g_dist, b_dist], axis=-1)
    cand_ids = jnp.concatenate([g_ids, b_ids], axis=-1)
    pool = min(cfg.ef_add, cand_dist.shape[1])
    cand_dist, pos = topk_ascending(cand_dist, pool)
    cand_ids = jnp.take_along_axis(cand_ids, pos, axis=-1)

    # --- 2. robust prune → forward edges.
    # Candidate vectors: graph rows from storage, batch rows from `vecs`.
    is_batch = cand_ids >= state.frontier
    from_store, is_sent = gather_vectors(state, cand_ids, cfg)
    batch_pos = jnp.clip(cand_ids - base_slot, 0, M - 1)
    from_batch = jnp.take(vecs, batch_pos, axis=0)  # [M, pool, D]
    cand_vecs = jnp.where((is_batch & ~is_sent)[..., None], from_batch, from_store)
    sel_d, sel_i = _robust_prune(cand_dist, cand_ids, cand_vecs, cfg)  # [M, R]

    # --- 3. write rows (padding lanes scatter out of bounds → dropped).
    w = jnp.where(live, slots, C)
    store_rows, store_scales = store_vectors(vecs_f32, cfg)
    vectors = state.vectors.at[w].set(store_rows, mode="drop")
    scales = state.scales.at[w].set(store_scales, mode="drop")
    neighbors = state.neighbors.at[w].set(sel_i, mode="drop")
    nbr_dist = state.nbr_dist.at[w].set(sel_d, mode="drop")
    valid = state.valid.at[w].set(True, mode="drop")

    # --- 4. reverse edges (only onto pre-existing graph rows; batch-internal
    # reciprocity already emerges from both directions being candidates).
    R = cfg.degree
    tgt = sel_i.reshape(-1)
    src = jnp.broadcast_to(slots[:, None], (M, R)).reshape(-1)
    d = sel_d.reshape(-1)
    e_live = (
        jnp.broadcast_to(live[:, None], (M, R)).reshape(-1)
        & (tgt != SENTINEL)
        & (d < INF)
        & (tgt < state.frontier)  # reverse edges into existing rows only
    )
    neighbors, nbr_dist = _apply_reverse_edges(
        neighbors, nbr_dist, tgt, src, d, e_live
    )

    # --- 5. router maintenance: assign new rows to their centroid rings
    # (incremental half of the hierarchical router, core/cluster.py).
    route_members, route_cnt = state.route_members, state.route_cnt
    if cfg.route_k > 0:
        from .cluster import ring_assign

        ad = dist_mod.pairwise(
            vecs, state.route_centroids.astype(vecs.dtype), cfg.space
        )  # [M, K]
        cid = jnp.argmin(ad, axis=-1).astype(jnp.int32)
        route_members, route_cnt = ring_assign(
            route_members, route_cnt, cid, slots, live
        )

    n_new = jnp.sum(live.astype(jnp.int32))
    new_frontier = jnp.maximum(
        state.frontier, jnp.max(jnp.where(live, slots + 1, 0))
    )
    return GraphState(
        vectors=vectors,
        scales=scales,
        neighbors=neighbors,
        nbr_dist=nbr_dist,
        valid=valid,
        size=state.size + n_new,
        frontier=new_frontier,
        route_centroids=state.route_centroids,
        route_members=route_members,
        route_cnt=route_cnt,
    )


def delete_impl(state: GraphState, slots: jnp.ndarray, live: jnp.ndarray) -> GraphState:
    """Tombstone a batch of rows (reference remove: usearch.rs:235-249).

    `slots` are rows to kill; padding lanes have live=False.  Rows stay
    traversable until a rebuild/compaction reclaims them.
    """
    C = state.capacity
    w = jnp.where(live, slots, C)
    was = jnp.take(state.valid, jnp.clip(slots, 0, C - 1)) & live
    valid = state.valid.at[w].set(False, mode="drop")
    return state._replace(
        valid=valid, size=state.size - jnp.sum(was.astype(jnp.int32))
    )


def upload_impl(
    state: GraphState,
    base_slot: jnp.ndarray,  # [] int32
    vecs: jnp.ndarray,  # [M, D]
    live: jnp.ndarray,  # [M] bool
    cfg: GraphConfig,
) -> GraphState:
    """Graph-free ingest for the exact-scan backend: write rows only.

    The scan searches the flat bank, so building adjacency would be
    wasted work — upload runs at copy speed (the reference has no such
    mode; usearch always pays graph construction)."""
    M = vecs.shape[0]
    C = state.capacity
    slots = base_slot + jnp.arange(M, dtype=jnp.int32)
    vecs_f32 = dist_mod.preprocess(vecs.astype(jnp.float32), cfg.space)
    w = jnp.where(live, slots, C)
    store_rows, store_scales = store_vectors(vecs_f32, cfg)
    return state._replace(
        vectors=state.vectors.at[w].set(store_rows, mode="drop"),
        scales=state.scales.at[w].set(store_scales, mode="drop"),
        valid=state.valid.at[w].set(True, mode="drop"),
        size=state.size + jnp.sum(live.astype(jnp.int32)),
        frontier=jnp.maximum(
            state.frontier, jnp.max(jnp.where(live, slots + 1, 0))
        ),
    )


insert = functools.partial(jax.jit, static_argnames=("cfg",), donate_argnums=(0,))(
    insert_impl
)
delete = functools.partial(jax.jit, donate_argnums=(0,))(delete_impl)
upload = functools.partial(jax.jit, static_argnames=("cfg",), donate_argnums=(0,))(
    upload_impl
)


# ---------------------------------------------------------------------------
# Graph refinement — batched NN-descent local join.
#
# Incremental insertion builds each node's edges against the graph *as it
# existed at insert time*, so early nodes never see later arrivals and
# edge quality is bounded by insert-order luck.  The refinement sweep is
# the batched fix (no counterpart in usearch, which mutates one
# node at a time): for a block of nodes, take the 2-hop neighbourhood
# (R + R² candidates via two adjacency gathers), score it with one
# batched matmul, α-prune to R, and rewrite the block's rows.  A pass
# over all nodes is a handful of large fused steps per block — exactly
# the shape XLA loves — and one or two passes recover CAGRA-grade edge
# quality from any half-decent initial graph.


def refine_block_impl(
    state: GraphState,
    base_slot: jnp.ndarray,  # [] int32 — block start (contiguous rows)
    block: int,  # static block size
    cfg: GraphConfig,
) -> GraphState:
    """Recompute forward edges of rows [base, base+block) from their
    2-hop neighbourhood; symmetrise via the same reverse-edge rounds."""
    C = state.capacity
    R = cfg.degree
    slots = base_slot + jnp.arange(block, dtype=jnp.int32)
    in_range = slots < state.frontier
    node_vecs, _ = gather_vectors(state, slots, cfg)  # [B, D]

    # 1-hop + 2-hop candidate ids.
    safe = jnp.clip(slots, 0, C - 1)
    hop1 = jnp.take(state.neighbors, safe, axis=0)  # [B, R]
    hop1_safe = jnp.clip(hop1, 0, C - 1)
    hop2 = jnp.take(state.neighbors, hop1_safe.reshape(-1), axis=0).reshape(
        block, R * R
    )
    hop2 = jnp.where(
        (hop1 == SENTINEL)[:, :, None].repeat(R, axis=2).reshape(block, R * R),
        SENTINEL,
        hop2,
    )
    cand_ids = jnp.concatenate([hop1, hop2], axis=1)  # [B, R + R²]

    # Dedup (2-hop sets overlap heavily), drop self, keep best pool.
    cand_vecs, is_sent = gather_vectors(state, cand_ids, cfg)
    cand_dist = dist_mod.gathered(node_vecs, cand_vecs, cfg.space)
    bad = is_sent | (cand_ids == slots[:, None])
    cand_dist = jnp.where(bad, INF, cand_dist)
    cand_ids = jnp.where(bad, SENTINEL, cand_ids)
    from .topk import dedup_by_id

    cand_dist, cand_ids = dedup_by_id(cand_dist, cand_ids)
    pool = min(cfg.ef_add, cand_dist.shape[1])
    cand_dist, pos = topk_ascending(cand_dist, pool)
    cand_ids = jnp.take_along_axis(cand_ids, pos, axis=-1)

    cand_vecs, _ = gather_vectors(state, cand_ids, cfg)  # re-gather pooled
    sel_d, sel_i = _robust_prune(cand_dist, cand_ids, cand_vecs, cfg)

    w = jnp.where(in_range, slots, C)
    neighbors = state.neighbors.at[w].set(sel_i, mode="drop")
    nbr_dist = state.nbr_dist.at[w].set(sel_d, mode="drop")

    # Symmetrise: offer each refined edge to its target too.
    tgt = sel_i.reshape(-1)
    src = jnp.broadcast_to(slots[:, None], (block, R)).reshape(-1)
    d = sel_d.reshape(-1)
    e_live = (
        jnp.broadcast_to(in_range[:, None], (block, R)).reshape(-1)
        & (tgt != SENTINEL)
        & (d < INF)
    )
    neighbors, nbr_dist = _apply_reverse_edges(
        neighbors, nbr_dist, tgt, src, d, e_live
    )
    return state._replace(neighbors=neighbors, nbr_dist=nbr_dist)


refine_block = functools.partial(
    jax.jit, static_argnames=("block", "cfg"), donate_argnums=(0,)
)(refine_block_impl)
