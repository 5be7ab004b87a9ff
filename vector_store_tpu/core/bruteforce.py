"""Exact (brute-force) top-k search.

Role in the system (no counterpart in the reference, which always went
through the HNSW graph):
  * correctness oracle for every recall test (SURVEY §7 milestone 1);
  * the candidate generator that bootstraps graph construction while the
    graph is still tiny;
  * an exact backend for small collections where a graph is overhead.

One matmul per (query block × bank chunk), chunked with `lax.scan` over
the bank so the [Q, chunk] distance block stays bounded and the running
top-k is carried between chunks.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from . import distance as dist_mod
from .topk import INF, SENTINEL, topk_ascending


@functools.partial(jax.jit, static_argnames=("space", "k", "chunk", "approx"))
def search(
    queries: jnp.ndarray,  # [Q, D]
    bank: jnp.ndarray,  # [N, D]  (padded capacity; f32/bf16/int8)
    valid: jnp.ndarray,  # [N] bool — live rows (tombstones false)
    space: str,
    k: int,
    chunk: int = 1 << 17,
    scales: jnp.ndarray | None = None,  # [N] int8 dequant scales
    approx: bool = True,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Exact-scan top-k: (dist[Q,k] ascending, ids[Q,k]); masked rows get
    (+inf, SENTINEL).

    `approx=True` routes the huge per-chunk reduction through
    `lax.approx_min_k` (recall_target 0.99 per chunk).  On a GPU, JAX
    lowers it as sort-and-slice, so the selection is exact there; the
    scan is a full exact *scoring* pass either way.
    """

    def chunk_topk(d, kk):
        if approx and d.shape[-1] >= 4096:
            val, idx = jax.lax.approx_min_k(d, kk, recall_target=0.99)
            return val, idx
        neg, idx = jax.lax.top_k(-d, kk)
        return -neg, idx

    N = bank.shape[0]
    if scales is not None and bank.dtype == jnp.int8:
        pass  # dequantised chunk-wise below / in the small-N branch
    else:
        scales = None
    if N <= chunk:
        b = bank
        if scales is not None:
            b = (bank.astype(jnp.float32) * scales[:, None]).astype(jnp.bfloat16)
        d = dist_mod.pairwise(queries, b, space)
        d = jnp.where(valid[None, :], d, INF)
        top_d, top_i = chunk_topk(d, min(k, N))
        top_i = jnp.where(jnp.isinf(top_d), SENTINEL, top_i)
        if k > N:  # pad — degenerate, only for toy banks
            pad = k - N
            top_d = jnp.pad(top_d, ((0, 0), (0, pad)), constant_values=jnp.inf)
            top_i = jnp.pad(top_i, ((0, 0), (0, pad)), constant_values=2**31 - 1)
        return top_d, top_i

    # Chunked scan: keep a running [Q, k] heap, merge each chunk's top-k.
    n_chunks = -(-N // chunk)
    pad_n = n_chunks * chunk
    if pad_n != N:
        bank = jnp.pad(bank, ((0, pad_n - N), (0, 0)))
        valid = jnp.pad(valid, (0, pad_n - N))
    bank_c = bank.reshape(n_chunks, chunk, bank.shape[1])
    valid_c = valid.reshape(n_chunks, chunk)
    scales_c = (
        jnp.pad(scales, (0, pad_n - N)).reshape(n_chunks, chunk)
        if scales is not None
        else jnp.ones((n_chunks, chunk), dtype=jnp.float32)
    )
    dequant = scales is not None

    Q = queries.shape[0]
    init = (
        jnp.full((Q, k), INF),
        jnp.full((Q, k), SENTINEL, dtype=jnp.int32),
    )

    def body(carry, inp):
        best_d, best_i = carry
        chunk_vecs, chunk_valid, chunk_scale, chunk_idx = inp
        if dequant:
            chunk_vecs = (
                chunk_vecs.astype(jnp.float32) * chunk_scale[:, None]
            ).astype(jnp.bfloat16)
        d = dist_mod.pairwise(queries, chunk_vecs, space)
        d = jnp.where(chunk_valid[None, :], d, INF)
        cd, ci = chunk_topk(d, min(k, chunk))
        ci = ci + chunk_idx * chunk
        ci = jnp.where(jnp.isinf(cd), SENTINEL, ci)
        md = jnp.concatenate([best_d, cd], axis=-1)
        mi = jnp.concatenate([best_i, ci], axis=-1)
        nd, pos = topk_ascending(md, k)
        ni = jnp.take_along_axis(mi, pos, axis=-1)
        return (nd, ni), None

    (best_d, best_i), _ = jax.lax.scan(
        body,
        init,
        (bank_c, valid_c, scales_c, jnp.arange(n_chunks, dtype=jnp.int32)),
    )
    return best_d, best_i
