"""Multi-device sharded ANN index — documents sharded, top-k merged.

The scaling story the reference never had (single-node CPU service): the
graph index shards by document across a `jax.sharding.Mesh`.  Each device
owns an independent GraphState shard; a query batch is replicated, every
shard runs the same batched beam search locally, and the per-shard top-k
results meet in an `all_gather` + merge — one collective on the critical
path (SURVEY §2 parallelism checklist; BASELINE config 5).

Layout: every state array gains a leading shard axis —
vectors[S, C, D], neighbors[S, C, R], ... — sharded on axis 0 with
`NamedSharding(mesh, P("shard"))`, so XLA places one [C, ...] block per
device and `shard_map` hands each device its local block.

Global ids: `gid = slot * S + shard` (S = shard count, fixed for the
index lifetime) — deliberately capacity-INDEPENDENT, so ids issued
before a capacity-doubling growth stay valid after it.  With balanced
round-robin routing this also makes gid equal the global insertion
order.
"""

from __future__ import annotations

import functools
import threading

import jax
import jax.numpy as jnp
import numpy as np
from ..utils.persistio import atomic_savez_compressed
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

try:  # jax >= 0.6 exports shard_map at top level
    from jax import shard_map as _shard_map_fn
except ImportError:  # pragma: no cover
    from jax.experimental.shard_map import shard_map as _shard_map_fn

from ..core import build, graph
from ..core import search as search_mod
from ..core.graph import GraphConfig, GraphState
from ..core.index import INSERT_BLOCK, _bucket, config_from_params
from ..core.topk import SENTINEL, topk_ascending
from ..types import IndexParams
from .mesh import SHARD_AXIS, make_mesh

INVALID = graph.INVALID


def _stack_init(cfg: GraphConfig, n_shards: int, capacity: int, mesh: Mesh) -> GraphState:
    """Fresh stacked state [S, ...] placed shard-per-device."""
    sh = NamedSharding(mesh, P(SHARD_AXIS))
    mk = lambda shape, dtype, fill: jax.device_put(
        jnp.full(shape, fill, dtype=dtype), sh
    )
    rk, rbm = graph.router_shapes(cfg)
    return GraphState(
        vectors=mk((n_shards, capacity, cfg.dims), cfg.jdtype, 0),
        scales=mk((n_shards, capacity), jnp.float32, 1.0),
        neighbors=mk((n_shards, capacity, cfg.degree), jnp.int32, INVALID),
        nbr_dist=mk((n_shards, capacity, cfg.degree), jnp.float32, jnp.inf),
        valid=mk((n_shards, capacity), bool, False),
        size=mk((n_shards,), jnp.int32, 0),
        frontier=mk((n_shards,), jnp.int32, 0),
        route_centroids=mk((n_shards, rk, cfg.dims), cfg.compute_dtype, 0),
        route_members=mk((n_shards, rk, rbm), jnp.int32, graph.SENTINEL),
        route_cnt=mk((n_shards, rk), jnp.int32, 0),
    )


def _local(state: GraphState) -> GraphState:
    """Strip the leading (local, size-1) shard axis inside shard_map."""
    return GraphState(*(a[0] for a in state))


def _relocal(state: GraphState) -> GraphState:
    return GraphState(*(a[None] for a in state))


def _gid_merge(local, d, i, S, k):
    """Encode local slots as global ids and merge per-shard top-k.

    gid = slot * S + shard: capacity-independent, so ids issued before a
    capacity-doubling growth stay valid after it."""
    shard = jax.lax.axis_index(SHARD_AXIS).astype(jnp.int32)
    gid = jnp.where(
        i == SENTINEL,
        SENTINEL,
        jnp.clip(i, 0, local.capacity - 1) * S + shard,
    )
    dd = jax.lax.all_gather(d, SHARD_AXIS)  # [S, Q, k]
    ii = jax.lax.all_gather(gid, SHARD_AXIS)
    n_sh, Q, K = dd.shape
    flat_d = jnp.transpose(dd, (1, 0, 2)).reshape(Q, n_sh * K)
    flat_i = jnp.transpose(ii, (1, 0, 2)).reshape(Q, n_sh * K)
    md, pos = topk_ascending(flat_d, k)
    mi = jnp.take_along_axis(flat_i, pos, axis=-1)
    return md, mi


@functools.partial(
    jax.jit, static_argnames=("cfg", "k", "mesh_holder", "exact")
)
def _sharded_search(state, queries, cfg, k, mesh_holder, exact=False):
    mesh = mesh_holder.mesh

    S = mesh.devices.size

    def fn(state_blk, queries_rep):
        local = _local(state_blk)
        if exact:
            from ..core import bruteforce
            from ..core import distance as dist_mod

            qp = dist_mod.preprocess(
                queries_rep.astype(jnp.float32), cfg.space
            ).astype(cfg.compute_dtype)
            d, i = bruteforce.search(
                qp,
                local.vectors,
                local.valid,
                cfg.space,
                k,
                scales=local.scales if cfg.quantized else None,
            )
        else:
            d, i = search_mod.search_impl(local, queries_rep, cfg, k)
        return _gid_merge(local, d, i, S, k)

    return _shard_map_fn(
        fn,
        mesh=mesh,
        in_specs=(GraphState(*([P(SHARD_AXIS)] * len(GraphState._fields))), P()),
        out_specs=(P(), P()),
        check_vma=False,
    )(state, queries)


@functools.partial(
    jax.jit, static_argnames=("cfg", "mesh_holder", "exact"), donate_argnums=(0,)
)
def _sharded_insert(state, bases, vecs, live, cfg, mesh_holder, exact=False):
    """bases [S], vecs [S, M, D], live [S, M] — every shard inserts its
    sub-batch simultaneously."""
    mesh = mesh_holder.mesh
    step = build.upload_impl if exact else build.insert_impl

    def fn(state_blk, base_blk, vecs_blk, live_blk):
        local = _local(state_blk)
        new = step(local, base_blk[0], vecs_blk[0], live_blk[0], cfg)
        return _relocal(new)

    return _shard_map_fn(
        fn,
        mesh=mesh,
        in_specs=(
            GraphState(*([P(SHARD_AXIS)] * len(GraphState._fields))),
            P(SHARD_AXIS),
            P(SHARD_AXIS),
            P(SHARD_AXIS),
        ),
        out_specs=GraphState(*([P(SHARD_AXIS)] * len(GraphState._fields))),
        check_vma=False,
    )(state, bases, vecs, live)


@functools.partial(jax.jit, static_argnames=("mesh_holder",), donate_argnums=(0,))
def _sharded_delete(state, slots, live, mesh_holder):
    """slots [S, m] local slot ids, live [S, m]."""
    mesh = mesh_holder.mesh

    def fn(state_blk, slots_blk, live_blk):
        local = _local(state_blk)
        new = build.delete_impl(local, slots_blk[0], live_blk[0])
        return _relocal(new)

    return _shard_map_fn(
        fn,
        mesh=mesh,
        in_specs=(
            GraphState(*([P(SHARD_AXIS)] * len(GraphState._fields))),
            P(SHARD_AXIS),
            P(SHARD_AXIS),
        ),
        out_specs=GraphState(*([P(SHARD_AXIS)] * len(GraphState._fields))),
        check_vma=False,
    )(state, slots, live)


# --- sharded router build — the per-chunk steps of core/cluster.py run
#     per shard under shard_map; the host driver (ShardedSlotIndex.
#     _rebuild_router_locked) mirrors the single-device build_router loop.

_STATE_SPEC = lambda: GraphState(  # noqa: E731
    *([P(SHARD_AXIS)] * len(GraphState._fields))
)


@functools.partial(jax.jit, static_argnames=("cfg", "route_k", "mesh_holder"))
def _sharded_seed(state, cfg, route_k, mesh_holder):
    from ..core import cluster

    def fn(state_blk):
        return cluster.seed_centroids(_local(state_blk), cfg, route_k)[None]

    return _shard_map_fn(
        fn,
        mesh=mesh_holder.mesh,
        in_specs=(_STATE_SPEC(),),
        out_specs=P(SHARD_AXIS),
        check_vma=False,
    )(state)


@functools.partial(
    jax.jit, static_argnames=("cfg", "sample_max", "mesh_holder")
)
def _sharded_lloyd_chunk(state, centroids, off, cfg, sample_max, mesh_holder):
    # `off` is traced (replicated scalar): a static offset would compile
    # one executable per chunk (see core/cluster.py jit wrappers).
    from ..core import cluster

    def fn(state_blk, cent_blk, off_):
        s, c = cluster.lloyd_chunk(
            _local(state_blk), cfg, cent_blk[0], off_, sample_max
        )
        return s[None], c[None]

    return _shard_map_fn(
        fn,
        mesh=mesh_holder.mesh,
        in_specs=(_STATE_SPEC(), P(SHARD_AXIS), P()),
        out_specs=(P(SHARD_AXIS), P(SHARD_AXIS)),
        check_vma=False,
    )(state, centroids, jnp.asarray(off, dtype=jnp.int32))


@functools.partial(jax.jit, static_argnames=("space", "mesh_holder"))
def _sharded_lloyd_finish(centroids, sums, cnts, space, mesh_holder):
    from ..core import cluster

    def fn(cent_blk, sums_blk, cnts_blk):
        return cluster.lloyd_finish(cent_blk[0], sums_blk[0], cnts_blk[0], space)[
            None
        ]

    return _shard_map_fn(
        fn,
        mesh=mesh_holder.mesh,
        in_specs=(P(SHARD_AXIS), P(SHARD_AXIS), P(SHARD_AXIS)),
        out_specs=P(SHARD_AXIS),
        check_vma=False,
    )(centroids, sums, cnts)


@functools.partial(jax.jit, static_argnames=("cfg", "mesh_holder"))
def _sharded_fill_chunk(state, centroids, members, m_cnt, off, cfg, mesh_holder):
    from ..core import cluster

    def fn(state_blk, cent_blk, mem_blk, cnt_blk, off_):
        m, c = cluster.fill_chunk(
            _local(state_blk), cfg, cent_blk[0], mem_blk[0], cnt_blk[0], off_
        )
        return m[None], c[None]

    return _shard_map_fn(
        fn,
        mesh=mesh_holder.mesh,
        in_specs=(
            _STATE_SPEC(),
            P(SHARD_AXIS),
            P(SHARD_AXIS),
            P(SHARD_AXIS),
            P(),
        ),
        out_specs=(P(SHARD_AXIS), P(SHARD_AXIS)),
        check_vma=False,
    )(state, centroids, members, m_cnt, jnp.asarray(off, dtype=jnp.int32))


class _MeshHolder:
    """Hashable wrapper so a Mesh can ride as a jit static argument."""

    def __init__(self, mesh: Mesh) -> None:
        self.mesh = mesh

    def __hash__(self) -> int:
        return hash(id(self.mesh))

    def __eq__(self, other) -> bool:
        return isinstance(other, _MeshHolder) and other.mesh is self.mesh


class ShardedSlotIndex:
    """Host wrapper mirroring SlotIndex over a device mesh.

    Ids returned by search/add are global (`slot * n_shards + shard`,
    stable across capacity growth); `decode()` splits one back into
    (shard, slot).  Vectors are routed to shards round-robin by the
    host, so shard sizes stay balanced without any device-side
    coordination.
    """

    def __init__(
        self,
        params: IndexParams,
        mesh: Mesh | None = None,
        n_devices: int | None = None,
        initial_capacity_per_shard: int | None = None,
        exact: bool = False,
    ) -> None:
        self.params = params
        self.mesh = mesh or make_mesh(n_devices)
        self._holder = _MeshHolder(self.mesh)
        self.n_shards = self.mesh.devices.size
        cap = initial_capacity_per_shard or max(
            min(params.capacity // self.n_shards, 1 << 16), 2 * INSERT_BLOCK
        )
        self.cfg = config_from_params(params, cap)
        if exact:
            # scan-only shards: 1-wide adjacency stub (core/index.py does
            # the same for the single-device exact backend)
            import dataclasses as _dc

            self.cfg = _dc.replace(self.cfg, degree=1)
        self._exact = exact
        self._state = _stack_init(self.cfg, self.n_shards, cap, self.mesh)
        self._frontiers = np.zeros((self.n_shards,), dtype=np.int64)
        self._sizes = np.zeros((self.n_shards,), dtype=np.int64)
        self._route_built_at = 0  # max per-shard frontier at last build
        self._rr = 0  # rotating round-robin start shard (persists across adds)
        self._lock = threading.Lock()

    # -- introspection ----------------------------------------------------

    @property
    def capacity(self) -> int:
        return self._state.vectors.shape[1]

    def count(self) -> int:
        return int(self._sizes.sum())

    def decode(self, gid: int) -> tuple[int, int]:
        """gid → (shard, slot).  Encoding never involves capacity, so
        ids survive growth (the round-1 `shard * C + slot` scheme went
        stale the moment C doubled)."""
        slot, shard = divmod(int(gid), self.n_shards)
        return shard, slot

    # -- mutation ---------------------------------------------------------

    def _ensure_capacity(self, per_shard_need: int) -> None:
        cap = self.capacity
        need = int(self._frontiers.max()) + per_shard_need
        if need + INSERT_BLOCK <= cap:
            return
        new_cap = cap
        while need + INSERT_BLOCK > new_cap:
            new_cap *= 2
        pad = new_cap - cap
        s = self._state
        sh = NamedSharding(self.mesh, P(SHARD_AXIS))
        put = lambda a: jax.device_put(a, sh)
        self._state = GraphState(
            vectors=put(jnp.pad(s.vectors, ((0, 0), (0, pad), (0, 0)))),
            scales=put(jnp.pad(s.scales, ((0, 0), (0, pad)), constant_values=1.0)),
            neighbors=put(
                jnp.pad(s.neighbors, ((0, 0), (0, pad), (0, 0)), constant_values=INVALID)
            ),
            nbr_dist=put(
                jnp.pad(s.nbr_dist, ((0, 0), (0, pad), (0, 0)), constant_values=jnp.inf)
            ),
            valid=put(jnp.pad(s.valid, ((0, 0), (0, pad)))),
            size=s.size,
            frontier=s.frontier,
            route_centroids=s.route_centroids,
            route_members=s.route_members,
            route_cnt=s.route_cnt,
        )
        import dataclasses as _dc

        from ..core.index import routing_sample_for

        self.cfg = _dc.replace(
            self.cfg, routing_sample=routing_sample_for(new_cap)
        )

    def add(self, vectors: np.ndarray) -> np.ndarray:
        """Insert vectors round-robin across shards → global ids [n]."""
        vectors = np.asarray(vectors, dtype=np.float32)
        if vectors.ndim == 1:
            vectors = vectors[None, :]
        n, d = vectors.shape
        if d != self.cfg.dims:
            raise ValueError(f"dimension mismatch: index {self.cfg.dims}, got {d}")
        S = self.n_shards
        gids = np.empty((n,), dtype=np.int64)
        with self._lock:
            done = 0
            while done < n:
                take = min(n - done, S * INSERT_BLOCK)
                chunk = vectors[done : done + take]
                # rotated round-robin deal: the start shard advances with
                # every row ever dealt, so a stream of single-document
                # upserts (take=1 per call) spreads across shards instead
                # of piling onto shard 0
                s0 = self._rr
                self._ensure_capacity(-(-take // S))
                tdt = np.float32
                if self.cfg.dtype != "float32":
                    import ml_dtypes

                    tdt = ml_dtypes.bfloat16  # halve per-shard transfer
                vecs = np.zeros((S, INSERT_BLOCK, d), dtype=tdt)
                live = np.zeros((S, INSERT_BLOCK), dtype=bool)
                bases = self._frontiers.astype(np.int32)
                counts = [0] * S
                for j in range(S):
                    s = (s0 + j) % S
                    p = chunk[j::S]
                    counts[s] = len(p)
                    vecs[s, : len(p)] = p
                    live[s, : len(p)] = True
                    gids[done + j : done + take : S] = (
                        bases[s] + np.arange(len(p))
                    ) * np.int64(S) + s
                self._state = _sharded_insert(
                    self._state,
                    jnp.asarray(bases),
                    jnp.asarray(vecs),
                    jnp.asarray(live),
                    self.cfg,
                    self._holder,
                    exact=self._exact,
                )
                for s in range(S):
                    self._frontiers[s] += counts[s]
                    self._sizes[s] += counts[s]
                self._rr = (s0 + take) % S
                done += take
                self._maybe_rebuild_router_locked()
            # end-of-call staleness bound, mirroring SlotIndex.add: a
            # bulk load must not finish with up to half of every shard
            # merely ring-assigned onto a stale centroid set
            from ..core.index import ROUTE_MIN_ROWS

            f = int(self._frontiers.max())
            if (
                not self._exact
                and f >= ROUTE_MIN_ROWS
                and f >= 1.25 * self._route_built_at
            ):
                self._rebuild_router_locked(f)
        return gids

    # -- hierarchical router ------------------------------------------------

    def _maybe_rebuild_router_locked(self) -> None:
        """Per-shard router rebuild when the biggest shard doubled
        (mirrors SlotIndex._maybe_rebuild_router_locked)."""
        from ..core.index import ROUTE_MIN_ROWS

        f = int(self._frontiers.max())
        if self._exact or f < ROUTE_MIN_ROWS:
            return
        if f < 2 * self._route_built_at:
            return
        self._rebuild_router_locked(f)

    def _rebuild_router_locked(self, frontier: int, k: int | None = None) -> None:
        """Sharded build_router: the same chunked Lloyd + fill driver as
        core/cluster.py, each step shard_map'd so every shard clusters its
        own rows locally (no cross-shard traffic)."""
        import dataclasses as _dc

        from ..core import cluster

        k = k or cluster.route_k_for(frontier)
        cfg = _dc.replace(self.cfg, route_k=k)
        centroids = _sharded_seed(self._state, cfg, k, self._holder)
        sample_n = min(frontier, cluster.LLOYD_SAMPLE)
        S = self.n_shards
        sh = NamedSharding(self.mesh, P(SHARD_AXIS))
        for _ in range(cluster.LLOYD_ITERS):
            sums = jax.device_put(
                jnp.zeros((S, k, cfg.dims), dtype=jnp.float32), sh
            )
            cnts = jax.device_put(jnp.zeros((S, k), dtype=jnp.float32), sh)
            for off in range(0, sample_n, cluster.ASSIGN_CHUNK):
                s_, c_ = _sharded_lloyd_chunk(
                    self._state, centroids, off, cfg, cluster.LLOYD_SAMPLE,
                    self._holder,
                )
                sums = sums + s_
                cnts = cnts + c_
            centroids = _sharded_lloyd_finish(
                centroids, sums, cnts, cfg.space, self._holder
            )
        members = jax.device_put(
            jnp.full((S, k, cfg.route_members_per), SENTINEL, dtype=jnp.int32),
            sh,
        )
        m_cnt = jax.device_put(jnp.zeros((S, k), dtype=jnp.int32), sh)
        for off in range(0, frontier, cluster.ASSIGN_CHUNK):
            members, m_cnt = _sharded_fill_chunk(
                self._state, centroids, members, m_cnt, off, cfg, self._holder
            )
        self.cfg = cfg
        self._state = self._state._replace(
            route_centroids=centroids, route_members=members, route_cnt=m_cnt
        )
        self._route_built_at = frontier

    def remove(self, gids: np.ndarray) -> None:
        # dedup: a slot repeated in one batch would double-decrement the
        # device size counter (every lane reads pre-update validity)
        gids = np.unique(np.asarray(gids, dtype=np.int64).reshape(-1))
        if gids.size == 0:
            return
        with self._lock:
            S = self.n_shards
            slot, shard = np.divmod(gids, S)
            m = max(int(np.bincount(shard, minlength=S).max()), 1)
            m = _bucket(m)
            slots = np.zeros((S, m), dtype=np.int32)
            live = np.zeros((S, m), dtype=bool)
            for s in range(S):
                mine = slot[shard == s]
                slots[s, : len(mine)] = mine
                live[s, : len(mine)] = True
            self._state = _sharded_delete(
                self._state, jnp.asarray(slots), jnp.asarray(live), self._holder
            )
            # host count mirrors device truth: delete_impl only decrements
            # for rows that were actually live, so read the result back
            # instead of guessing (unknown / already-removed gids would
            # otherwise desync count() permanently)
            self._sizes = np.asarray(
                jax.device_get(self._state.size), dtype=np.int64
            )

    # -- query ------------------------------------------------------------

    def search(self, queries: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
        queries = np.asarray(queries, dtype=np.float32)
        single = queries.ndim == 1
        if single:
            queries = queries[None, :]
        n, d = queries.shape
        if d != self.cfg.dims:
            raise ValueError(f"dimension mismatch: index {self.cfg.dims}, got {d}")
        b = _bucket(n)
        if b != n:
            queries = np.pad(queries, ((0, b - n), (0, 0)))
        with self._lock:
            qp = jnp.asarray(queries)
            # match single-device path: preprocess handled inside search_impl
            dist, ids = _sharded_search(
                self._state, qp, self.cfg, k, self._holder, exact=self._exact
            )
            # one pipelined fetch for both arrays (async host copies
            # issued up front) — a high-latency link is paid once
            dist, ids = jax.device_get((dist[:n], ids[:n]))
            ids = ids.astype(np.int64)
        ids[~np.isfinite(dist)] = -1
        if single:
            return dist[0], ids[0]
        return dist, ids

    # -- maintenance --------------------------------------------------------

    def compact(self) -> dict[int, int]:
        """Reclaim tombstoned rows across all shards: rebuild from live
        rows, returning {old_gid: new_gid} for the owner's keymap (same
        contract as SlotIndex.compact)."""
        scratch, remap = self.compact_prepare()
        self.compact_install(scratch)
        return remap

    def compact_prepare(self) -> tuple["ShardedSlotIndex", dict[int, int]]:
        """Rebuild live rows into a SCRATCH sharded index offline; the
        serving state stays untouched so concurrent queries see the
        consistent (old state, old gid numbering) pair throughout.  Same
        prepare/install contract as SlotIndex.compact_prepare."""
        import dataclasses as _dc

        from ..core.index import routing_sample_for

        with self._lock:
            state = self._state
            S = self.n_shards
            valid = np.asarray(jax.device_get(state.valid))  # [S, C]
            vec_parts, gid_parts = [], []
            for s in range(S):
                slots = np.nonzero(valid[s])[0]
                if len(slots) == 0:
                    continue
                rows = jnp.take(
                    state.vectors[s], jnp.asarray(slots, dtype=jnp.int32), axis=0
                ).astype(jnp.float32)
                if self.cfg.quantized:
                    scl = jnp.take(
                        state.scales[s], jnp.asarray(slots, dtype=jnp.int32)
                    )
                    rows = rows * scl[:, None]
                vec_parts.append(np.asarray(rows))
                gid_parts.append(slots.astype(np.int64) * S + s)
            vectors = (
                np.concatenate(vec_parts)
                if vec_parts
                else np.zeros((0, self.cfg.dims), dtype=np.float32)
            )
            old_gids = (
                np.concatenate(gid_parts) if gid_parts else np.zeros((0,), np.int64)
            )
            cap = max(
                1 << max(len(vectors) // S, 1).bit_length(), 2 * INSERT_BLOCK
            )
            new_cfg = _dc.replace(
                self.cfg,
                routing_sample=routing_sample_for(cap),
                route_k=0,  # router rebuilt from scratch by the re-add
            )
        scratch = ShardedSlotIndex.__new__(ShardedSlotIndex)
        scratch.params = self.params
        scratch.mesh = self.mesh
        scratch._holder = self._holder
        scratch.n_shards = S
        scratch.cfg = new_cfg
        scratch._exact = self._exact
        scratch._state = _stack_init(new_cfg, S, cap, self.mesh)
        scratch._frontiers = np.zeros((S,), dtype=np.int64)
        scratch._sizes = np.zeros((S,), dtype=np.int64)
        scratch._route_built_at = 0
        scratch._rr = 0
        scratch._lock = threading.Lock()
        # vectors are stored preprocessed; re-preprocessing is idempotent
        new_gids = scratch.add(vectors)
        return scratch, {int(o): int(n) for o, n in zip(old_gids, new_gids)}

    def compact_install(self, scratch: "ShardedSlotIndex") -> None:
        """Swap in the state prepared by compact_prepare."""
        with self._lock:
            self.cfg = scratch.cfg
            self._state = scratch._state
            self._frontiers = scratch._frontiers
            self._sizes = scratch._sizes
            self._route_built_at = scratch._route_built_at
            self._rr = scratch._rr

    # -- persistence ---------------------------------------------------------

    def save(self, path: str) -> None:
        """Snapshot the stacked sharded state to one npz (the sharded
        sibling of core/persist.py; reference has no persistence at all —
        SURVEY §5 checkpoint/resume)."""
        import json
        from dataclasses import asdict

        # under the index lock: _sharded_insert donates the previous
        # state buffers, so an unlocked snapshot during live ingest reads
        # deleted arrays (or frontiers that disagree with the bank)
        with self._lock:
            self._save_locked(path, json, asdict)

    def _save_locked(self, path: str, json, asdict) -> None:
        s = self._state
        meta = {
            "format": 1,
            "sharded": True,
            "n_shards": self.n_shards,
            "params": asdict(self.params),
            "cfg": asdict(self.cfg),
            "exact": self._exact,
            "frontiers": self._frontiers.tolist(),
            "sizes": self._sizes.tolist(),
            "route_built_at": self._route_built_at,
        }
        vectors = (
            np.asarray(s.vectors)
            if self.cfg.quantized
            else np.asarray(s.vectors.astype(jnp.float32))
        )
        atomic_savez_compressed(
            path,
            vectors=vectors,
            scales=np.asarray(s.scales),
            neighbors=np.asarray(s.neighbors),
            nbr_dist=np.asarray(s.nbr_dist),
            valid=np.asarray(s.valid),
            size=np.asarray(s.size),
            frontier=np.asarray(s.frontier),
            route_centroids=np.asarray(s.route_centroids.astype(jnp.float32)),
            route_members=np.asarray(s.route_members),
            route_cnt=np.asarray(s.route_cnt),
            meta=np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8),
        )

    @classmethod
    def load(
        cls, path: str, mesh: Mesh | None = None, n_devices: int | None = None
    ) -> "ShardedSlotIndex":
        import json

        from ..types import IndexParams as _IP

        with np.load(path) as z:
            meta = json.loads(bytes(z["meta"]).decode())
            if not meta.get("sharded"):
                raise ValueError("not a sharded snapshot (use core.persist.load)")
            cfg = GraphConfig.from_meta(meta["cfg"])
            idx = cls.__new__(cls)
            idx.params = _IP(**meta["params"])
            idx.mesh = mesh or make_mesh(n_devices or meta["n_shards"])
            if idx.mesh.devices.size != meta["n_shards"]:
                raise ValueError(
                    f"snapshot has {meta['n_shards']} shards, mesh has "
                    f"{idx.mesh.devices.size} devices"
                )
            idx._holder = _MeshHolder(idx.mesh)
            idx.n_shards = meta["n_shards"]
            idx.cfg = cfg
            idx._exact = meta.get("exact", False)
            idx._frontiers = np.asarray(meta["frontiers"], dtype=np.int64)
            idx._sizes = np.asarray(meta["sizes"], dtype=np.int64)
            idx._route_built_at = meta.get("route_built_at", 0)
            idx._rr = int(idx._frontiers.sum() % idx.n_shards)
            idx._lock = threading.Lock()
            sh = NamedSharding(idx.mesh, P(SHARD_AXIS))
            put = lambda a: jax.device_put(jnp.asarray(a), sh)  # noqa: E731
            idx._state = GraphState(
                vectors=put(jnp.asarray(z["vectors"]).astype(cfg.jdtype)),
                scales=put(z["scales"]),
                neighbors=put(z["neighbors"]),
                nbr_dist=put(z["nbr_dist"]),
                valid=put(z["valid"]),
                size=put(z["size"]),
                frontier=put(z["frontier"]),
                route_centroids=put(
                    jnp.asarray(z["route_centroids"]).astype(cfg.compute_dtype)
                ),
                route_members=put(z["route_members"]),
                route_cnt=put(z["route_cnt"]),
            )
        return idx
