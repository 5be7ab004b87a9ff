"""Distance kernels — matmuls, not scalar loops.

The reference delegates all distance math to the C++ usearch library
(cosine default, f32: reference src/index/usearch.rs:89-96).  Here the
same work is expressed as batched matrix products for the device's
matrix units:

    scores[Q, N] = queries[Q, D] @ bank[N, D]^T           (dot / cosine)
    l2[Q, N]     = |q|^2 + |x|^2 - 2 * scores             (L2)

All functions return *ascending* distances (smaller = closer), matching the
reference's ANN response ordering (src/index/usearch.rs:284-303):

    cosine: 1 - cos(q, x)     (vectors pre-normalised at ingest)
    l2:     squared L2
    dot:    -<q, x>
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

Space = str  # "cosine" | "l2" | "dot"

# bf16 (or f32) operands accumulated in f32.
_ACC = jnp.float32


def normalize(x: jnp.ndarray, eps: float = 1e-12) -> jnp.ndarray:
    """L2-normalise rows (cosine space stores unit vectors)."""
    n = jnp.sqrt(jnp.sum(jnp.square(x.astype(_ACC)), axis=-1, keepdims=True))
    return (x.astype(_ACC) / jnp.maximum(n, eps)).astype(x.dtype)


def preprocess(x: jnp.ndarray, space: Space) -> jnp.ndarray:
    """Transform vectors at ingest time so query-time distance is a pure
    matmul: cosine-space vectors are stored unit-length."""
    if space == "cosine":
        return normalize(x)
    return x


def pairwise(
    queries: jnp.ndarray,  # [Q, D]
    bank: jnp.ndarray,  # [N, D]
    space: Space,
    bank_sqnorm: jnp.ndarray | None = None,  # [N] optional precomputed |x|^2
) -> jnp.ndarray:  # [Q, N] ascending distances, f32
    """Dense Q×N distance block via one matmul."""
    q = queries
    x = bank
    dots = jax.lax.dot_general(
        q,
        x,
        dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=_ACC,
    )  # [Q, N]
    if space == "dot":
        return -dots
    if space == "cosine":
        # vectors pre-normalised (see preprocess); 1 - cos
        return 1.0 - dots
    # l2 (squared)
    if bank_sqnorm is None:
        bank_sqnorm = jnp.sum(jnp.square(x.astype(_ACC)), axis=-1)
    q_sq = jnp.sum(jnp.square(q.astype(_ACC)), axis=-1, keepdims=True)  # [Q,1]
    return q_sq + bank_sqnorm[None, :] - 2.0 * dots


def gathered(
    queries: jnp.ndarray,  # [Q, D]
    cand_vecs: jnp.ndarray,  # [Q, C, D] per-query candidate vectors
    space: Space,
) -> jnp.ndarray:  # [Q, C] ascending distances, f32
    """Per-query candidate distances as a batched mat-vec (batch dim = Q).

    This is the beam-search inner product: each query scores its own C
    gathered neighbour vectors.  Expressed as dot_general with a batch
    dimension so XLA maps it onto a batched matmul.
    """
    dots = jax.lax.dot_general(
        cand_vecs,
        queries,
        dimension_numbers=(((2,), (1,)), ((0,), (0,))),
        preferred_element_type=_ACC,
    )  # [Q, C]
    if space == "dot":
        return -dots
    if space == "cosine":
        return 1.0 - dots
    c_sq = jnp.sum(jnp.square(cand_vecs.astype(_ACC)), axis=-1)  # [Q, C]
    q_sq = jnp.sum(jnp.square(queries.astype(_ACC)), axis=-1, keepdims=True)
    return q_sq + c_sq - 2.0 * dots


def pairwise_int8(
    queries: jnp.ndarray,  # [Q, D] f32/bf16 (full-precision queries)
    bank_q: jnp.ndarray,  # [N, D] int8 quantised bank
    bank_scale: jnp.ndarray,  # [N] per-row dequant scale
    space: Space,
    bank_sqnorm: jnp.ndarray | None = None,  # [N] |x|^2 in dequantised units
) -> jnp.ndarray:
    """Distances against an int8-quantised bank (asymmetric: f32 query).

    The matmul runs with the int8 bank cast to bf16; the
    per-row scale is applied to the f32 accumulator.  Memory traffic is the
    win: the 4x smaller bank is what streams from HBM.
    """
    dots = jax.lax.dot_general(
        queries.astype(jnp.bfloat16),
        bank_q.astype(jnp.bfloat16),
        dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=_ACC,
    )  # [Q, N]
    dots = dots * bank_scale[None, :]
    if space == "dot":
        return -dots
    if space == "cosine":
        return 1.0 - dots
    if bank_sqnorm is None:
        xf = bank_q.astype(_ACC) * bank_scale[:, None]
        bank_sqnorm = jnp.sum(jnp.square(xf), axis=-1)
    q_sq = jnp.sum(jnp.square(queries.astype(_ACC)), axis=-1, keepdims=True)
    return q_sq + bank_sqnorm[None, :] - 2.0 * dots

