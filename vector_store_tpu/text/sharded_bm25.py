"""Document-sharded BM25 over a device mesh — the text backend's
multi-device story.

The single-device BM25Index (text/bm25.py) streams every document row
through one device; collections past one device's memory shard across
the mesh exactly like the ANN banks do (shard/sharded_index.py):
documents deal round-robin to shards, a query batch is replicated,
every shard scores its local block with the same chunked scan, and the
per-shard top-k meet in one `all_gather` + descending merge
(SURVEY §2 parallelism checklist; the reference's OpenSearch backend
got this from the remote cluster's own sharding —
/root/reference/src/index/opensearch.rs:41-47 fronts a cluster, so
multi-node text serving is part of the behavioral envelope).

Design: host bookkeeping (tokenisation, vocab, df/idf, phrase
sequences, slot allocation) is IDENTICAL to the single-chip index and
fully inherited — a flat slot space where slot s lives on shard
`s % S` at local row `s // S`.  Sequential slot allocation therefore
deals documents round-robin with zero coordination, and the gid a
shard emits (`row * S + shard`) IS the flat host slot, so every
host-side consumer (keymap, phrase verify, AST verify) works unchanged.

Only two things override the base class:
  * `_device_arrays` — stacks host rows into [S, R, U] blocks placed
    shard-per-device (NamedSharding over the "shard" axis), with the
    same power-of-two row bucketing and dirty-row scatter protocol;
  * `_score` — a shard_map'd twin of `_score_topk` ending in the
    all_gather + top-k merge (scores merge DESCENDING, unlike the
    distance merges in shard/sharded_index.py::_gid_merge).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

try:  # jax >= 0.6 exports shard_map at top level
    from jax import shard_map as _shard_map_fn
except ImportError:  # pragma: no cover
    from jax.experimental.shard_map import shard_map as _shard_map_fn

from ..core.topk import SENTINEL
from ..shard.mesh import SHARD_AXIS, make_mesh, sharded
from ..shard.sharded_index import _MeshHolder
from .bm25 import BM25Index, _score_topk_impl


@functools.partial(jax.jit, static_argnames=("k", "use_ops", "mesh_holder"))
def _sharded_score_topk(
    terms,  # [S, R, U] int32, sharded on axis 0
    tf,  # [S, R, U] int32
    length,  # [S, R] int32
    valid,  # [S, R] bool
    q_terms,  # [Q, T] int32, replicated
    q_idf,  # [Q, T] f32
    q_req,  # [Q, TR] int32
    q_neg,  # [Q, TN] int32
    avg_len,  # [] f32 (global average — df/len bookkeeping is host-global)
    *,
    k: int,
    use_ops: bool,
    mesh_holder: _MeshHolder,
):
    """Per-shard BM25 scan + all_gather descending top-k merge.

    Returned ids are flat host slots (`row * S + shard`), SENTINEL for
    empty lanes — the same contract as the single-chip `_score_topk`.
    """
    mesh = mesh_holder.mesh
    S = mesh.devices.size
    R = terms.shape[1]
    chunk = min(1 << 13, 1 << max(R - 1, 1).bit_length())

    def fn(t, f, ln, v, qt, qi, qr, qn, av):
        s, i = _score_topk_impl(
            t[0], f[0], ln[0], v[0], qt, qi, qr, qn, av,
            k=k, chunk=chunk, use_ops=use_ops,
        )
        shard = jax.lax.axis_index(SHARD_AXIS).astype(jnp.int32)
        gid = jnp.where(i == SENTINEL, SENTINEL, i * S + shard)
        ss = jax.lax.all_gather(s, SHARD_AXIS)  # [S, Q, k]
        ii = jax.lax.all_gather(gid, SHARD_AXIS)
        n_sh, Q, K = ss.shape
        flat_s = jnp.transpose(ss, (1, 0, 2)).reshape(Q, n_sh * K)
        flat_i = jnp.transpose(ii, (1, 0, 2)).reshape(Q, n_sh * K)
        ms, pos = jax.lax.top_k(flat_s, k)
        mi = jnp.take_along_axis(flat_i, pos, axis=-1)
        return ms, mi

    return _shard_map_fn(
        fn,
        mesh=mesh,
        in_specs=(P(SHARD_AXIS),) * 4 + (P(),) * 5,
        out_specs=(P(), P()),
        check_vma=False,
    )(terms, tf, length, valid, q_terms, q_idf, q_req, q_neg, avg_len)


class ShardedBM25Index(BM25Index):
    """BM25Index with its document bank sharded across a device mesh.

    Same host API as the base class (add → flat slot, remove(slot),
    search(texts, k) → [(slot, score)]); only the device residency and
    the scoring collective differ.
    """

    MIN_SHARD_ROWS = 128  # row-bucket floor (tests shrink it to force growth)

    def __init__(
        self,
        initial_capacity: int = 1 << 14,
        mesh: Mesh | None = None,
        n_devices: int | None = None,
    ) -> None:
        super().__init__(initial_capacity)
        self.mesh = mesh or make_mesh(n_devices)
        self.n_shards = int(self.mesh.devices.size)
        self._holder = _MeshHolder(self.mesh)

    # -- device residency --------------------------------------------------

    def _device_arrays(self):
        S = self.n_shards
        per = -(-max(self._frontier, 1) // S)  # live rows per shard
        R = 1 << max(per, self.MIN_SHARD_ROWS).bit_length()  # doubling buckets
        host_cap = self._terms.shape[0]
        R = min(R, -(-host_cap // S) or 1)
        if self._dev is None or self._dev_rows != R:
            # (re)size: full stacked upload, shard-per-device
            total = R * S
            sl = slice(0, min(total, host_cap))
            pad = total - (sl.stop - sl.start)

            def stack(a, extra_dims=()):
                block = a[sl]
                if pad:
                    block = np.pad(
                        block, ((0, pad),) + ((0, 0),) * len(extra_dims)
                    )
                # flat slot j*S + s  →  stacked [s, j, ...]
                return np.swapaxes(
                    block.reshape((R, S) + block.shape[1:]), 0, 1
                )

            sh = sharded(self.mesh)
            self._dev = (
                jax.device_put(jnp.asarray(stack(self._terms, (0,))), sh),
                jax.device_put(jnp.asarray(stack(self._tf, (0,))), sh),
                jax.device_put(jnp.asarray(stack(self._length)), sh),
                jax.device_put(jnp.asarray(stack(self._valid)), sh),
            )
            self._dev_rows = R
            self._dirty_slots.clear()
        elif self._dirty_slots:
            slots = np.fromiter(self._dirty_slots, dtype=np.int64)
            slots = slots[slots < R * S]
            si = jnp.asarray(slots % S, dtype=jnp.int32)
            ji = jnp.asarray(slots // S, dtype=jnp.int32)
            terms, tf, length, valid = self._dev
            sh = sharded(self.mesh)
            self._dev = (
                jax.device_put(
                    terms.at[si, ji].set(jnp.asarray(self._terms[slots])), sh
                ),
                jax.device_put(
                    tf.at[si, ji].set(jnp.asarray(self._tf[slots])), sh
                ),
                jax.device_put(
                    length.at[si, ji].set(jnp.asarray(self._length[slots])),
                    sh,
                ),
                jax.device_put(
                    valid.at[si, ji].set(jnp.asarray(self._valid[slots])), sh
                ),
            )
            self._dirty_slots.clear()
        return self._dev

    # -- scoring -----------------------------------------------------------

    def _score(self, arrays, q_terms, q_idf, q_req, q_neg, avg, k, use_ops):
        return _sharded_score_topk(
            *arrays,
            q_terms,
            q_idf,
            q_req,
            q_neg,
            avg,
            k=k,
            use_ops=use_ops,
            mesh_holder=self._holder,
        )
