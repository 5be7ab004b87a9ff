"""IVF probe-scan as a Pallas kernel on the Triton route.

The XLA path (ivf.search_clustered) gathers every probed bucket into a
[Q, g, B, D] device-memory transient, widens it to the compute dtype and
reads it back for the dot: per query it moves about three times the
p·B·D bank bytes.  This kernel reads each probed bucket once, straight
from the bank, widens int8 in registers, and writes only the [Q, p·B]
distance pool; one `lax.top_k` in XLA finishes.

Grid (Q, p): program (i, r) scores query i against its r-th probed
cluster.  It loads the cluster id from `cids` and that bucket's live-row
bound (`live_rows`), walks the bucket in TB-row tiles and D in DC-wide
chunks — both powers of two, masked at the edges, so any D works — and
stores TB distances per tile.  Rows past the live bound are never read
(buckets carry 1.5x slack, so this halves the bytes at bulk-load
occupancy) and come out +inf, as do tombstoned rows (SENTINEL rowid).
Same contract as ivf.search_clustered.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

# Python scalars: a Pallas kernel may not capture device constants.
INF = float("inf")
SENTINEL = 2**31 - 1

# Rows per tile.  bucket_for keeps B a multiple of 128, so TB divides it.
TB = 64
# Widest D chunk; narrower banks use the next power of two ≥ D.
DC_MAX = 256
NUM_WARPS = 4
NUM_STAGES = 2


def live_rows(valid: jnp.ndarray) -> jnp.ndarray:
    """Per-cluster live-row bound: last live slot + 1 ([K] i32, 0 when
    the bucket is empty).  Slots past it are never valid."""
    K, B = valid.shape
    lane = jax.lax.broadcasted_iota(jnp.int32, (K, B), 1)
    return jnp.max(jnp.where(valid, lane + 1, 0), axis=1)


def _kernel(cids_ref, nlive_ref, q_ref, vec_ref, scl_ref, rid_ref, out_ref,
            *, space: str, quantized: bool, tb: int, dc: int):
    i = pl.program_id(0)
    r = pl.program_id(1)
    B, D = vec_ref.shape[1], vec_ref.shape[2]
    c = cids_ref[i, r]
    n = nlive_ref[c]
    # traced zero: chunk starts past D are masked, and only a dynamic
    # start may overrun the static shape
    zero = i * 0
    chunks = []
    for d0 in range(0, D, dc):
        cm = d0 + jnp.arange(dc) < D
        qv = plgpu.load(q_ref.at[i, pl.ds(zero + d0, dc)], mask=cm, other=0.0)
        chunks.append((d0, cm, qv))
    for t0 in range(0, B, tb):
        rows = t0 + jnp.arange(tb)
        live = rows < n
        dots = jnp.zeros((tb,), jnp.float32)
        x_sq = jnp.zeros((tb,), jnp.float32)
        for d0, cm, qv in chunks:
            x = plgpu.load(
                vec_ref.at[c, pl.ds(t0, tb), pl.ds(zero + d0, dc)],
                mask=live[:, None] & cm[None, :],
                other=0,
            ).astype(jnp.float32)
            dots += jnp.sum(x * qv[None, :], axis=1)
            if space == "l2":
                x_sq += jnp.sum(x * x, axis=1)
        if quantized:
            sc = plgpu.load(scl_ref.at[c, pl.ds(t0, tb)], mask=live, other=1.0)
            dots = dots * sc
            x_sq = x_sq * sc * sc
        if space == "l2":
            q_sq = sum(jnp.sum(qv * qv) for _, _, qv in chunks)
            d = q_sq + x_sq - 2.0 * dots
        elif space == "dot":
            d = -dots
        else:  # cosine: rows and queries are unit-norm
            d = 1.0 - dots
        rid = plgpu.load(rid_ref.at[c, pl.ds(t0, tb)], mask=live, other=SENTINEL)
        d = jnp.where(live & (rid != SENTINEL), d, INF)
        plgpu.store(out_ref.at[i, pl.ds(r * B + t0, tb)], d)


def probe_scan(
    vectors: jnp.ndarray,  # [K, B, D] storage dtype
    scales: jnp.ndarray,  # [K, B] f32 int8 dequant scales
    rid_masked: jnp.ndarray,  # [K, B] i32, SENTINEL where dead
    nlive: jnp.ndarray,  # [K] i32 live-row bound (live_rows)
    q: jnp.ndarray,  # [Q, D] f32 preprocessed queries
    cids: jnp.ndarray,  # [Q, p] i32 probed clusters
    space: str,
    interpret: bool = False,
) -> jnp.ndarray:
    """Distance pool [Q, p·B] f32: lane r·B + j scores row (cids[q, r], j).
    Unjitted — composes inside the caller's jit."""
    Q, p = cids.shape
    K, B, D = vectors.shape
    if B % TB:
        raise ValueError(f"bucket width {B} is not a multiple of {TB}")
    dc = min(DC_MAX, pl.next_power_of_2(D))
    kern = functools.partial(
        _kernel,
        space=space,
        quantized=vectors.dtype == jnp.int8,
        tb=TB,
        dc=dc,
    )
    return pl.pallas_call(
        kern,
        out_shape=jax.ShapeDtypeStruct((Q, p * B), jnp.float32),
        grid=(Q, p),
        backend="triton",
        compiler_params=plgpu.CompilerParams(
            num_warps=NUM_WARPS, num_stages=NUM_STAGES
        ),
        interpret=interpret,
        name="ivf_probe_scan",
    )(cids, nlive, q.astype(jnp.float32), vectors, scales, rid_masked)
