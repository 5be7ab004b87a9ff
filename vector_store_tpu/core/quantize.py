"""Int8 vector quantization — memory-parity storage mode.

The reference stores f32 in usearch (`ScalarKind::F32`,
src/index/usearch.rs:94); usearch's compressed modes (i8) are the
memory-parity target of BASELINE config 3.  Scheme: symmetric per-vector
scaling — `q = round(x / scale)`, `scale = max|x| / 127` — with the
scale kept beside the row.  Distances run asymmetric (full-precision
query against dequantised bank rows); the 4x smaller bank is what
streams from HBM, which is where the win is.
"""

from __future__ import annotations

import jax.numpy as jnp

_EPS = 1e-12


def quantize_rows(x: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """[N, D] f32 → (values [N, D] i8, scales [N] f32)."""
    absmax = jnp.max(jnp.abs(x), axis=-1)
    scale = jnp.maximum(absmax, _EPS) / 127.0
    q = jnp.clip(jnp.round(x / scale[:, None]), -127, 127).astype(jnp.int8)
    return q, scale.astype(jnp.float32)


def dequantize_rows(q: jnp.ndarray, scale: jnp.ndarray) -> jnp.ndarray:
    """(values i8, scales) → f32; scale broadcast over the last dim."""
    return q.astype(jnp.float32) * scale[..., None]


# -- int4 coarse tier ---------------------------------------------------
#
# A second, half-width representation of the bank used as the FIRST
# stage of the two-stage IVF scan (core/ivf.py::search_two_stage): the
# probe-scan streams 0.5 byte/dim from HBM, then the survivors are
# rescored against the int8 rows.  Packing uses a SPLIT layout — byte j
# holds dim j in its low nibble and dim j + D/2 in its high nibble — so
# unpacking is two shifts and one concat, no interleave shuffle.
#
# The int4 codes are derived FROM the int8 codes (not the f32 source):
# q4 = round(q8 * 7 / 127), scale4 = scale8 * 127 / 7.  Deriving keeps
# the int8 bank the single source of truth — the coarse bank is a cache
# that can be re-derived per touched cluster after any mutation.


def pack_int4_from_int8(q8: jnp.ndarray) -> jnp.ndarray:
    """int8 codes [..., D] (D even) → packed int4 [..., D/2] uint8.

    Split layout: out[..., j] = nibble(dim j) | nibble(dim j + D/2) << 4.
    """
    d = q8.shape[-1]
    q4 = jnp.clip(jnp.round(q8.astype(jnp.float32) * (7.0 / 127.0)), -7, 7)
    q4 = q4.astype(jnp.int8)
    lo = q4[..., : d // 2]
    hi = q4[..., d // 2 :]
    return ((lo & 0x0F) | (hi << 4)).astype(jnp.uint8)


def unpack_int4(packed: jnp.ndarray) -> jnp.ndarray:
    """Packed [..., D/2] uint8 → int4 codes [..., D] int8 (split layout).

    Arithmetic right-shift on int8 sign-extends, so `(x << 4) >> 4`
    recovers the signed low nibble and `x >> 4` the signed high nibble.
    """
    x = packed.astype(jnp.int8)
    lo = jnp.right_shift(jnp.left_shift(x, 4), 4)
    hi = jnp.right_shift(x, 4)
    return jnp.concatenate([lo, hi], axis=-1)


def int4_scale(scale8: jnp.ndarray) -> jnp.ndarray:
    """Dequant scale of the derived int4 codes."""
    return scale8 * (127.0 / 7.0)
