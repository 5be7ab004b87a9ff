"""Top-k selection and sorted-pool merge primitives.

The beam-search pool (the `ef` candidate list of HNSW, reference:
src/lib.rs:182-200 expansion params) is kept as fixed-shape, distance-sorted
arrays `(dist[Q,P], ids[Q,P], flags[Q,P])`.  Merging a batch of new
candidates into the pool is a sort-based kernel: concatenate, dedup by id,
and keep the best P — all static shapes, no data-dependent control flow.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

INF = jnp.float32(jnp.inf)
SENTINEL = jnp.int32(2**31 - 1)  # "no node" id; sorts after all real ids


def topk_ascending(dist: jnp.ndarray, k: int) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Smallest-k along the last axis → (dist[..., k], idx[..., k]) sorted."""
    neg, idx = jax.lax.top_k(-dist, k)
    return -neg, idx


def topk_ascending_approx(
    dist: jnp.ndarray, k: int, recall_target: float = 0.99
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Smallest-k via `lax.approx_min_k`, used on the big reductions
    (routing stage over the C/8 sample); exact top_k stays on the small
    final extractions.  On a GPU, JAX lowers approx_min_k as
    sort-and-slice: the result is exact there, at the cost of a sort.
    """
    val, idx = jax.lax.approx_min_k(dist, k, recall_target=recall_target)
    return val, idx


def merge_pool_fast(
    pool_dist: jnp.ndarray,  # [Q, P] ascending
    pool_ids: jnp.ndarray,  # [Q, P]
    pool_expanded: jnp.ndarray,  # [Q, P] bool
    new_dist: jnp.ndarray,  # [Q, C]
    new_ids: jnp.ndarray,  # [Q, C]
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Sort-free pool merge: membership-matrix dedup + one top-k.

    Replaces the 3-operand lexicographic sort of `merge_pool` with
    elementwise work: new candidates are masked out if already present in
    the pool (an O(P·C) equality matrix — P and C are both ≲256, so the
    matrix is tiny next to the vector gathers), and duplicates *within*
    the new block are masked by a single-key sort over just the ids.
    The survivors then meet the pool in one exact top-k over P+C lanes.
    """
    P = pool_dist.shape[-1]

    # within-new dedup: single-key sort of the ids (order of the new
    # block doesn't matter downstream — everything meets a top-k), mask
    # adjacent equals.
    ids_s, dist_s = jax.lax.sort((new_ids, new_dist), num_keys=1)
    dup = jnp.concatenate(
        [jnp.zeros_like(ids_s[..., :1], dtype=bool), ids_s[..., 1:] == ids_s[..., :-1]],
        axis=-1,
    )
    # new vs pool: kill any candidate already present (pool copy keeps
    # its expanded flag — membership in pool IS the visited set).
    in_pool = jnp.any(
        ids_s[:, :, None] == pool_ids[:, None, :], axis=-1
    )  # [Q, C]
    bad = in_pool | dup
    new_dist = jnp.where(bad, INF, dist_s)
    new_ids = jnp.where(bad, SENTINEL, ids_s)

    all_dist = jnp.concatenate([pool_dist, new_dist], axis=-1)
    all_ids = jnp.concatenate([pool_ids, new_ids], axis=-1)
    all_exp = jnp.concatenate(
        [pool_expanded, jnp.zeros_like(new_dist, dtype=bool)], axis=-1
    )
    top_d, pos = topk_ascending(all_dist, P)
    top_i = jnp.take_along_axis(all_ids, pos, axis=-1)
    top_e = jnp.take_along_axis(all_exp, pos, axis=-1)
    return top_d, top_i, top_e


def dedup_by_id(
    dist: jnp.ndarray,  # [..., C]
    ids: jnp.ndarray,  # [..., C] int32
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Mask duplicate ids (keep the first-best copy) by sorting on id.

    Returns (dist, ids) with duplicates replaced by (+inf, SENTINEL).
    Shapes are preserved; order is sorted by id on return.
    """
    # Sort by (id, dist) so the best copy of each id comes first.
    ids_s, dist_s = jax.lax.sort((ids, dist), num_keys=2)
    dup = jnp.concatenate(
        [jnp.zeros_like(ids_s[..., :1], dtype=bool), ids_s[..., 1:] == ids_s[..., :-1]],
        axis=-1,
    )
    dist_s = jnp.where(dup, INF, dist_s)
    ids_s = jnp.where(dup, SENTINEL, ids_s)
    return dist_s, ids_s


def merge_pool(
    pool_dist: jnp.ndarray,  # [Q, P] ascending
    pool_ids: jnp.ndarray,  # [Q, P]
    pool_expanded: jnp.ndarray,  # [Q, P] bool
    new_dist: jnp.ndarray,  # [Q, C]
    new_ids: jnp.ndarray,  # [Q, C]
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Merge new candidates into the beam pool, dedup'd by id, best-P kept.

    Expanded flags survive the merge: a pool entry that was already expanded
    keeps its flag; new entries arrive unexpanded.  When the same id appears
    both in the pool and among the new candidates, the pool copy (with its
    flag) wins — its distance is identical, and keeping it preserves the
    expanded bit, which is what makes the visited-set work without a hash
    table (reference's C++ usearch keeps an explicit visited bitset; here
    membership-in-pool *is* the visited set).
    """
    P = pool_dist.shape[-1]
    all_dist = jnp.concatenate([pool_dist, new_dist], axis=-1)
    all_ids = jnp.concatenate([pool_ids, new_ids], axis=-1)
    all_exp = jnp.concatenate(
        [pool_expanded, jnp.zeros_like(new_dist, dtype=bool)], axis=-1
    )

    # Sort by (id, expanded-first) so the pool copy of a duplicate id is kept:
    # expanded sorts before unexpanded via the negated flag as secondary key.
    ids_s, exp_neg, dist_s = jax.lax.sort(
        (all_ids, (~all_exp).astype(jnp.int32), all_dist), num_keys=2
    )
    exp_s = exp_neg == 0
    dup = jnp.concatenate(
        [jnp.zeros_like(ids_s[..., :1], dtype=bool), ids_s[..., 1:] == ids_s[..., :-1]],
        axis=-1,
    )
    dist_s = jnp.where(dup, INF, dist_s)
    ids_s = jnp.where(dup, SENTINEL, ids_s)
    exp_s = jnp.where(dup, False, exp_s)

    # Best P by distance.
    top_d, pos = topk_ascending(dist_s, P)
    top_i = jnp.take_along_axis(ids_s, pos, axis=-1)
    top_e = jnp.take_along_axis(exp_s, pos, axis=-1)
    return top_d, top_i, top_e


def rank_in_run(sorted_keys: jnp.ndarray) -> jnp.ndarray:
    """Rank of each element within its run of equal keys (keys sorted).

    Shared by the reverse-edge scatter (build.py) and the ring-assign
    scatter (cluster.py): both need a per-duplicate offset to turn a
    sorted key stream into conflict-free scatter positions."""
    n = sorted_keys.shape[0]
    idx = jnp.arange(n, dtype=jnp.int32)
    is_start = jnp.concatenate(
        [jnp.ones((1,), dtype=bool), sorted_keys[1:] != sorted_keys[:-1]]
    )
    run_start = jax.lax.cummax(jnp.where(is_start, idx, 0))
    return idx - run_start
