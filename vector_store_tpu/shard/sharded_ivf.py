"""Multi-device sharded IVF — documents sharded, probe-scan per shard,
top-k merged across devices.

The IVF bucketed backend (core/ivf.py) is the serving tier at the
1M–100M scale; this wraps it over a `jax.sharding.Mesh` so a collection
larger than one device's memory shards by document (BASELINE config 5:
100M × 768-d across four cards; SURVEY §2 parallelism checklist).

Layout: every `IvfState` array gains a leading shard axis —
centroids[S, K, D], vectors[S, K, B, D], ... — sharded on axis 0 with
`NamedSharding(mesh, P("shard"))`.  Each device owns an independent IVF
bank; a query batch is replicated, every shard runs the same probe-scan
locally (the Pallas probe-scan kernel on a GPU, the XLA lax.scan path
elsewhere — core/ivf.py `scan_kernel_for`), and per-shard top-k results
meet in ONE `all_gather` + merge on the critical path.

Global ids: `gid = local_rowid * S + shard` — capacity-independent
(rowids are already stable across bucket growth and reclustering inside
each shard, so no remap event ever reaches the engine keymap; int32
bounds rowids to 2^31/S per shard).  Round-robin routing keeps shard
fill balanced within ±1 row without device-side coordination.

Recluster runs per shard under shard_map — each shard k-means its own
rows locally (zero cross-shard traffic); all shards share one (K, B)
bank geometry so the stacked state keeps a fixed shape.

Reference role: the usearch index actor at multi-device scale
(src/index/usearch.rs) — a tier the single-node reference never had.
"""

from __future__ import annotations

import functools
import threading

import jax
import jax.numpy as jnp
import numpy as np
from ..utils.persistio import atomic_savez
from jax.sharding import NamedSharding, PartitionSpec as P

try:  # jax >= 0.6 exports shard_map at top level
    from jax import shard_map as _shard_map_fn
except ImportError:  # pragma: no cover
    from jax.experimental.shard_map import shard_map as _shard_map_fn

from ..core import distance as dist_mod
from ..core.ivf import (
    CLUSTER_MIN_ROWS,
    PROBE_DEFAULT,
    QCHUNK,
    SPILL,
    IvfState,
    _assign_pass,
    _chunked,
    _compute_dtype,
    _gather_dequant,
    _lloyd_iter,
    _storage_dtype,
    ROWS_PER_BUCKET,
    bucket_for,
    init,
    k_for,
    derive_coarse,
    permute_build_impl,
    place_impl,
    plan_placement,
    scan_kernel_for,
    search_clustered,
    search_clustered_kernel,
    search_flat,
    search_two_stage,
    unvalidate_impl,
)
from ..core.topk import SENTINEL, topk_ascending
from ..types import IndexParams
from .mesh import SHARD_AXIS, make_mesh
from .sharded_index import _MeshHolder

_IVF_SPEC = lambda: IvfState(  # noqa: E731
    *([P(SHARD_AXIS)] * len(IvfState._fields))
)


def _local(state: IvfState) -> IvfState:
    """Strip the leading (local, size-1) shard axis inside shard_map."""
    return IvfState(*(a[0] for a in state))


def _relocal(state: IvfState) -> IvfState:
    return IvfState(*(a[None] for a in state))


def _stack_init(dims, k, bucket, dtype, n_shards, mesh) -> IvfState:
    sh = NamedSharding(mesh, P(SHARD_AXIS))
    mk = lambda shape, dt, fill: jax.device_put(  # noqa: E731
        jnp.full(shape, fill, dtype=dt), sh
    )
    return IvfState(
        centroids=mk((n_shards, k, dims), _compute_dtype(dtype), 0),
        vectors=mk((n_shards, k, bucket, dims), _storage_dtype(dtype), 0),
        scales=mk((n_shards, k, bucket), jnp.float32, 1.0),
        valid=mk((n_shards, k, bucket), bool, False),
        rowid=mk((n_shards, k, bucket), jnp.int32, int(SENTINEL)),
    )


# --- jitted sharded steps ---------------------------------------------------


@functools.partial(jax.jit, static_argnames=("space", "a", "mesh_holder"))
def _sh_assign(state, vecs, space, a, mesh_holder):
    """Per-shard top-`a` cluster assignment of each shard's sub-batch."""

    def fn(state_blk, vecs_blk):
        local = _local(state_blk)
        prep = dist_mod.preprocess(
            vecs_blk[0].astype(jnp.float32), space
        ).astype(local.centroids.dtype)
        d = dist_mod.pairwise(prep, local.centroids, space)
        _, cids = jax.lax.top_k(-d, a)
        return cids.astype(jnp.int32)[None]

    return _shard_map_fn(
        fn,
        mesh=mesh_holder.mesh,
        in_specs=(_IVF_SPEC(), P(SHARD_AXIS)),
        out_specs=P(SHARD_AXIS),
        check_vma=False,
    )(state, vecs)


@functools.partial(
    jax.jit, static_argnames=("space", "dtype", "mesh_holder"), donate_argnums=(0,)
)
def _sh_place(state, vecs, ks, poss, rowids, space, dtype, mesh_holder):
    """Every shard scatters its prepared sub-batch simultaneously
    (padding lanes carry ks == n_clusters → dropped by the scatter)."""

    def fn(state_blk, v, k_, p_, r_):
        return _relocal(
            place_impl(_local(state_blk), v[0], k_[0], p_[0], r_[0], space, dtype)
        )

    return _shard_map_fn(
        fn,
        mesh=mesh_holder.mesh,
        in_specs=(
            _IVF_SPEC(),
            P(SHARD_AXIS),
            P(SHARD_AXIS),
            P(SHARD_AXIS),
            P(SHARD_AXIS),
        ),
        out_specs=_IVF_SPEC(),
        check_vma=False,
    )(state, vecs, ks, poss, rowids)


@functools.partial(jax.jit, static_argnames=("mesh_holder",), donate_argnums=(0,))
def _sh_unvalidate(state, ks, poss, mesh_holder):
    def fn(state_blk, k_, p_):
        return _relocal(unvalidate_impl(_local(state_blk), k_[0], p_[0]))

    return _shard_map_fn(
        fn,
        mesh=mesh_holder.mesh,
        in_specs=(_IVF_SPEC(), P(SHARD_AXIS), P(SHARD_AXIS)),
        out_specs=_IVF_SPEC(),
        check_vma=False,
    )(state, ks, poss)


@functools.partial(
    jax.jit,
    static_argnames=("space", "k", "probes", "mode", "mesh_holder", "interpret"),
)
def _sh_search(state, queries, space, k, probes, mode, mesh_holder,
               interpret=False):
    """Replicated queries → per-shard probe-scan → all_gather top-k merge.

    mode: 'kernel' (Pallas probe-scan kernel per shard), 'probe' (XLA
    clustered scan), 'flat' (staging-phase full scan), 'flat_exact' (the
    recall oracle).  `interpret` runs the kernel under the Pallas
    interpreter so the sharded plumbing is testable on the CPU mesh."""
    mesh = mesh_holder.mesh
    S = mesh.devices.size

    def fn(state_blk, q_rep):
        local = _local(state_blk)
        if mode == "kernel":
            d, rid = search_clustered_kernel(
                local, q_rep, space, k, probes, interpret=interpret
            )
        elif mode == "probe":
            d, rid = search_clustered(local, q_rep, space, k, probes)
        else:
            d, rid = search_flat(
                local, q_rep, space, k, approx=(mode == "flat")
            )
        shard = jax.lax.axis_index(SHARD_AXIS).astype(jnp.int32)
        gid = jnp.where(rid == SENTINEL, SENTINEL, rid * S + shard)
        dd = jax.lax.all_gather(d, SHARD_AXIS)  # [S, Q, k]
        ii = jax.lax.all_gather(gid, SHARD_AXIS)
        n_sh, Q, kk = dd.shape
        flat_d = jnp.transpose(dd, (1, 0, 2)).reshape(Q, n_sh * kk)
        flat_i = jnp.transpose(ii, (1, 0, 2)).reshape(Q, n_sh * kk)
        md, pos = topk_ascending(flat_d, k)
        mi = jnp.take_along_axis(flat_i, pos, axis=-1)
        return md, mi

    return _shard_map_fn(
        fn,
        mesh=mesh,
        in_specs=(_IVF_SPEC(), P()),
        out_specs=(P(), P()),
        check_vma=False,
    )(state, queries)


@functools.partial(jax.jit, static_argnames=("mesh_holder",))
def _sh_derive_coarse(state, mesh_holder):
    """Per-shard derived int4 bank [S, K, B, D/2] (core/ivf.py coarse)."""

    def fn(state_blk):
        return derive_coarse(_local(state_blk).vectors)[None]

    return _shard_map_fn(
        fn,
        mesh=mesh_holder.mesh,
        in_specs=(_IVF_SPEC(),),
        out_specs=P(SHARD_AXIS),
        check_vma=False,
    )(state)


@functools.partial(
    jax.jit, static_argnames=("space", "k", "probes", "cand", "mesh_holder")
)
def _sh_search_two_stage(
    state, coarse, queries, space, k, probes, cand, mesh_holder
):
    """Two-stage (int4 coarse + int8 rescore) per shard, gid-merged
    across devices — the sharded twin of core/ivf.py::search_two_stage."""
    mesh = mesh_holder.mesh
    S = mesh.devices.size

    def fn(state_blk, coarse_blk, q_rep):
        local = _local(state_blk)
        d, rid = search_two_stage(
            local, coarse_blk[0], q_rep, space, k, probes, cand
        )
        shard = jax.lax.axis_index(SHARD_AXIS).astype(jnp.int32)
        gid = jnp.where(rid == SENTINEL, SENTINEL, rid * S + shard)
        dd = jax.lax.all_gather(d, SHARD_AXIS)  # [S, Q, k]
        ii = jax.lax.all_gather(gid, SHARD_AXIS)
        n_sh, Q, kk = dd.shape
        flat_d = jnp.transpose(dd, (1, 0, 2)).reshape(Q, n_sh * kk)
        flat_i = jnp.transpose(ii, (1, 0, 2)).reshape(Q, n_sh * kk)
        md, pos = topk_ascending(flat_d, k)
        mi = jnp.take_along_axis(flat_i, pos, axis=-1)
        return md, mi

    return _shard_map_fn(
        fn,
        mesh=mesh,
        in_specs=(_IVF_SPEC(), P(SHARD_AXIS), P()),
        out_specs=(P(), P()),
        check_vma=False,
    )(state, coarse, queries)


@functools.partial(jax.jit, static_argnames=("mesh_holder",))
def _sh_gather_rows(state, ids, mesh_holder):
    """Per-shard flat-bank row gather (centroid seeding) → [S, n, D] f32."""

    def fn(state_blk, ids_blk):
        local = _local(state_blk)
        return _gather_dequant(local.vectors, local.scales, ids_blk[0])[None]

    return _shard_map_fn(
        fn,
        mesh=mesh_holder.mesh,
        in_specs=(_IVF_SPEC(), P(SHARD_AXIS)),
        out_specs=P(SHARD_AXIS),
        check_vma=False,
    )(state, ids)


@functools.partial(jax.jit, static_argnames=("space", "mesh_holder"))
def _sh_lloyd_iter(state, centroids, chunks, space, mesh_holder):
    """One Lloyd iteration per shard over its own chunked sample."""

    def fn(state_blk, cent_blk, chunks_blk):
        local = _local(state_blk)
        return _lloyd_iter(
            local.vectors, local.scales, cent_blk[0], chunks_blk[0], space
        )[None]

    return _shard_map_fn(
        fn,
        mesh=mesh_holder.mesh,
        in_specs=(_IVF_SPEC(), P(SHARD_AXIS), P(SHARD_AXIS)),
        out_specs=P(SHARD_AXIS),
        check_vma=False,
    )(state, centroids, chunks)


@functools.partial(jax.jit, static_argnames=("space", "a", "mesh_holder"))
def _sh_assign_pass(state, centroids, chunks, space, a, mesh_holder):
    def fn(state_blk, cent_blk, chunks_blk):
        local = _local(state_blk)
        return _assign_pass(
            local.vectors, local.scales, cent_blk[0], chunks_blk[0], space, a
        )[None]

    return _shard_map_fn(
        fn,
        mesh=mesh_holder.mesh,
        in_specs=(_IVF_SPEC(), P(SHARD_AXIS), P(SHARD_AXIS)),
        out_specs=P(SHARD_AXIS),
        check_vma=False,
    )(state, centroids, chunks)


@functools.partial(
    jax.jit, static_argnames=("mesh_holder",), donate_argnums=(0, 1)
)
def _sh_permute_build(old, new, perm, mesh_holder):
    def fn(old_blk, new_blk, perm_blk):
        return _relocal(
            permute_build_impl(_local(old_blk), _local(new_blk), perm_blk[0])
        )

    return _shard_map_fn(
        fn,
        mesh=mesh_holder.mesh,
        in_specs=(_IVF_SPEC(), _IVF_SPEC(), P(SHARD_AXIS)),
        out_specs=_IVF_SPEC(),
        check_vma=False,
    )(old, new, perm)


# ---------------------------------------------------------------------------


class _ShardBook:
    """Host-side placement bookkeeping for one shard (the same mirrors
    IvfIndex keeps, minus the device state)."""

    def __init__(self, k: int, b: int) -> None:
        self.n_used = np.zeros((k,), dtype=np.int64)
        self.valid_h = np.zeros((k, b), dtype=bool)
        self.rowid_h = np.full((k, b), -1, dtype=np.int64)
        self.loc = np.full((0, 2), -1, dtype=np.int64)  # rowid → (k, pos)
        self.free: dict[int, list[int]] = {}
        self.next_rowid = 0
        self.n_live = 0

    def grow_loc(self, n: int) -> None:
        if self.next_rowid + n > len(self.loc):
            new_len = max(2 * len(self.loc), self.next_rowid + n, 1024)
            pad = np.full((new_len - len(self.loc), 2), -1, dtype=np.int64)
            self.loc = np.concatenate([self.loc, pad])

    def grow_bucket(self, b_old: int) -> None:
        self.valid_h = np.pad(self.valid_h, ((0, 0), (0, b_old)))
        self.rowid_h = np.pad(
            self.rowid_h, ((0, 0), (0, b_old)), constant_values=-1
        )


class ShardedIvfIndex:
    """Host wrapper mirroring IvfIndex over a device mesh.

    Ids returned by search/add are global (`rowid * n_shards + shard`,
    stable across growth AND reclustering); `decode()` splits one back
    into (shard, local rowid).  Same numpy-in/numpy-out surface as
    IvfIndex/SlotIndex/ShardedSlotIndex.
    """

    # per-shard per-dispatch ingest block (matches IvfIndex.add chunking)
    INGEST_CHUNK = 16384

    def __init__(
        self,
        params: IndexParams,
        mesh=None,
        n_devices: int | None = None,
        probes: int = PROBE_DEFAULT,
        cluster_min: int = CLUSTER_MIN_ROWS,
        initial_capacity: int | None = None,
        rows_per_bucket: int | None = None,
        coarse: bool | None = None,
        rescore: int = 8,
    ) -> None:
        self.params = params
        self.space = params.space
        self.dtype = (
            params.dtype if params.dtype in ("float32", "int8") else "bfloat16"
        )
        self.dims = params.dimensions
        self.probes = probes
        self.cluster_min = cluster_min
        # two-stage scan knobs (same semantics as IvfIndex): the coarse
        # bank is a per-shard derived cache, invalidated wholesale on any
        # code-writing mutation (sharded mutations are batchy; a full
        # per-shard re-derive is one shard_map dispatch)
        import os as _os

        env4 = _os.environ.get("VST_IVF_COARSE")
        if coarse is None:
            coarse = env4 == "1"
        elif env4 == "0":
            coarse = False
        self.coarse = bool(coarse) and self.dtype == "int8" and self.dims % 2 == 0
        self.rescore = rescore
        self._coarse_bank: jnp.ndarray | None = None
        self._coarse_stale = True
        self.rows_per_bucket = rows_per_bucket or ROWS_PER_BUCKET
        self.mesh = mesh or make_mesh(n_devices)
        self._holder = _MeshHolder(self.mesh)
        self.n_shards = self.mesh.devices.size
        rows0 = max(
            -(-(initial_capacity or 0) // self.n_shards), cluster_min
        )
        k = k_for(rows0, self.rows_per_bucket)
        b = bucket_for(rows0, k)
        self._state = _stack_init(
            self.dims, k, b, self.dtype, self.n_shards, self.mesh
        )
        self._books = [_ShardBook(k, b) for _ in range(self.n_shards)]
        self._clustered = False
        self._clustered_at = 0
        self._rr = 0  # rotating round-robin start shard (persists across adds)
        self._lock = threading.Lock()

    # -- introspection ------------------------------------------------------

    def count(self) -> int:
        return sum(b.n_live for b in self._books)

    @property
    def state(self) -> IvfState:
        return self._state

    @property
    def n_clusters(self) -> int:
        return self._state.vectors.shape[1]

    @property
    def bucket(self) -> int:
        return self._state.vectors.shape[2]

    def decode(self, gid: int) -> tuple[int, int]:
        """gid → (shard, local rowid)."""
        rowid, shard = divmod(int(gid), self.n_shards)
        return shard, rowid

    # -- helpers ------------------------------------------------------------

    def _grow_bucket(self) -> None:
        """Double B on every shard (axis 2 pad) — realloc event, ids
        unaffected; all shards keep one bank geometry."""
        s = self._state
        S, K, B, D = s.vectors.shape
        sh = NamedSharding(self.mesh, P(SHARD_AXIS))
        put = lambda a: jax.device_put(a, sh)  # noqa: E731
        self._state = IvfState(
            centroids=s.centroids,
            vectors=put(jnp.pad(s.vectors, ((0, 0), (0, 0), (0, B), (0, 0)))),
            scales=put(
                jnp.pad(s.scales, ((0, 0), (0, 0), (0, B)), constant_values=1.0)
            ),
            valid=put(jnp.pad(s.valid, ((0, 0), (0, 0), (0, B)))),
            rowid=put(
                jnp.pad(
                    s.rowid,
                    ((0, 0), (0, 0), (0, B)),
                    constant_values=int(SENTINEL),
                )
            ),
        )
        for book in self._books:
            book.grow_bucket(B)
        self._coarse_stale = True
        self._coarse_bank = None

    def _to_dev_stack(self, arr: np.ndarray) -> jnp.ndarray:
        """Ship a stacked [S, ...] host array shard-per-device."""
        return jax.device_put(arr, NamedSharding(self.mesh, P(SHARD_AXIS)))

    # -- mutation -----------------------------------------------------------

    def add(self, vectors: np.ndarray) -> np.ndarray:
        vectors = np.asarray(vectors, dtype=np.float32)
        if vectors.ndim == 1:
            vectors = vectors[None, :]
        n, d = vectors.shape
        if d != self.dims:
            raise ValueError(f"dimension mismatch: index {self.dims}, got {d}")
        S = self.n_shards
        gids = np.empty((n,), dtype=np.int64)
        tdt = np.float32
        if self.dtype != "float32":
            import ml_dtypes

            tdt = ml_dtypes.bfloat16  # halve the host→device transfer
        with self._lock:
            done = 0
            while done < n:
                take = min(n - done, S * self.INGEST_CHUNK)
                chunk = vectors[done : done + take]
                # rotated round-robin deal (same fix as ShardedSlotIndex):
                # the start shard advances with every row ever dealt, so a
                # stream of single-document upserts (take=1 per call)
                # spreads across shards instead of piling onto shard 0
                s0 = self._rr
                m = -(-take // S)
                vecs = np.zeros((S, m, d), dtype=tdt)
                rids = np.full((S, m), int(SENTINEL), dtype=np.int32)
                lens = np.zeros((S,), dtype=np.int64)
                for j in range(S):
                    s = (s0 + j) % S
                    p = chunk[j::S]
                    vecs[s, : len(p)] = p
                    lens[s] = len(p)
                    book = self._books[s]
                    book.grow_loc(len(p))
                    local = book.next_rowid + np.arange(len(p))
                    book.next_rowid += len(p)
                    rids[s, : len(p)] = local
                    gids[done + j : done + take : S] = local * np.int64(S) + s
                if self._clustered:
                    self._add_clustered(vecs, rids, lens)
                else:
                    self._add_staging(vecs, rids, lens)
                for s in range(S):
                    self._books[s].n_live += int(lens[s])
                self._rr = (s0 + take) % S
                done += take
            self._coarse_stale = True  # new codes landed on every shard
            self._maybe_recluster()
        return gids

    def _plan_staging(
        self, lens: np.ndarray
    ) -> tuple[np.ndarray, np.ndarray]:
        """Sequential per-shard fill (from per-cluster fill counts — see
        IvfIndex._add_staging for why a flat cursor is wrong)."""
        S = self.n_shards
        K, B = self.n_clusters, self.bucket
        m = int(lens.max())
        while max(
            int(self._books[s].n_used.sum()) + int(lens[s]) for s in range(S)
        ) > K * B:
            self._grow_bucket()
            B = self.bucket
        ks = np.full((S, m), K, dtype=np.int32)  # K = dropped lane
        poss = np.zeros((S, m), dtype=np.int32)
        for s in range(S):
            book = self._books[s]
            mm = int(lens[s])
            if mm == 0:
                continue
            rem = B - book.n_used
            cum = np.cumsum(rem)
            j = np.arange(mm)
            kk = np.searchsorted(cum, j, side="right")
            prev = np.where(kk > 0, cum[np.maximum(kk - 1, 0)], 0)
            pp = book.n_used[kk] + (j - prev)
            np.add.at(book.n_used, kk, 1)
            ks[s, :mm] = kk
            poss[s, :mm] = pp
        return ks, poss

    def _add_staging(self, vecs, rids, lens) -> None:
        ks, poss = self._plan_staging(lens)
        self._scatter(vecs, ks, poss, rids, lens)

    def _add_clustered(self, vecs, rids, lens) -> None:
        S = self.n_shards
        vdev = self._to_dev_stack(vecs)
        cids = np.asarray(
            _sh_assign(self._state, vdev, self.space, SPILL, self._holder)
        )  # [S, m, SPILL]
        m = vecs.shape[1]
        while True:
            trial = []
            ok = True
            for s in range(S):
                book = self._books[s]
                used = book.n_used.copy()
                free_try = {k: v[:] for k, v in book.free.items()}
                kk, pp, unplaced = plan_placement(
                    cids[s, : int(lens[s])], used, self.bucket, free=free_try
                )
                if unplaced.any():
                    ok = False
                    break
                trial.append((used, free_try, kk, pp))
            if ok:
                break
            self._grow_bucket()
        ks = np.full((S, m), self.n_clusters, dtype=np.int32)
        poss = np.zeros((S, m), dtype=np.int32)
        for s, (used, free_new, kk, pp) in enumerate(trial):
            book = self._books[s]
            book.n_used = used
            book.free = free_new
            ks[s, : int(lens[s])] = kk
            poss[s, : int(lens[s])] = pp
        self._scatter(vdev, ks, poss, rids, lens)

    def _scatter(self, vecs, ks, poss, rids, lens) -> None:
        self._state = _sh_place(
            self._state,
            vecs if isinstance(vecs, jnp.ndarray) else self._to_dev_stack(vecs),
            self._to_dev_stack(ks),
            self._to_dev_stack(poss),
            self._to_dev_stack(rids),
            self.space,
            self.dtype,
            self._holder,
        )
        for s in range(self.n_shards):
            mm = int(lens[s])
            if mm == 0:
                continue
            book = self._books[s]
            kk, pp = ks[s, :mm], poss[s, :mm]
            rr = rids[s, :mm].astype(np.int64)
            book.valid_h[kk, pp] = True
            book.rowid_h[kk, pp] = rr
            book.loc[rr, 0] = kk
            book.loc[rr, 1] = pp

    def remove(self, gids: np.ndarray) -> None:
        gids = np.unique(np.asarray(gids, dtype=np.int64).reshape(-1))
        gids = gids[gids >= 0]
        if gids.size == 0:
            return
        with self._lock:
            S = self.n_shards
            rowid, shard = np.divmod(gids, S)
            per_k, per_p, lens = [], [], np.zeros((S,), dtype=np.int64)
            for s in range(S):
                book = self._books[s]
                mine = rowid[shard == s]
                mine = mine[mine < book.next_rowid]
                if mine.size:
                    ks = book.loc[mine, 0]
                    mine = mine[ks >= 0]
                if mine.size == 0:
                    per_k.append(np.empty((0,), np.int32))
                    per_p.append(np.empty((0,), np.int32))
                    continue
                ks, pp = book.loc[mine, 0], book.loc[mine, 1]
                if self._clustered:
                    for k_, p_ in zip(ks.tolist(), pp.tolist()):
                        book.free.setdefault(k_, []).append(p_)
                book.valid_h[ks, pp] = False
                book.loc[mine] = -1
                book.n_live -= len(mine)
                lens[s] = len(mine)
                per_k.append(ks.astype(np.int32))
                per_p.append(pp.astype(np.int32))
            m = max(int(lens.max()), 1)
            ks = np.full((S, m), self.n_clusters, dtype=np.int32)
            poss = np.zeros((S, m), dtype=np.int32)
            for s in range(S):
                ks[s, : len(per_k[s])] = per_k[s]
                poss[s, : len(per_p[s])] = per_p[s]
            self._state = _sh_unvalidate(
                self._state,
                self._to_dev_stack(ks),
                self._to_dev_stack(poss),
                self._holder,
            )

    # -- clustering ---------------------------------------------------------

    def _maybe_recluster(self) -> None:
        n_live = self.count()
        if n_live < self.cluster_min:
            return
        if self._clustered and n_live < 2 * self._clustered_at:
            return
        self._recluster_locked()

    def compact(self) -> dict:
        """Per-shard recluster (drops tombstones); ids stable → {}."""
        with self._lock:
            if self.count() > 0:
                self._recluster_locked()
        return {}

    def _recluster_locked(self) -> None:
        from ..core.cluster import ASSIGN_CHUNK, LLOYD_ITERS, LLOYD_SAMPLE

        s = self._state
        S, K, B, D = s.vectors.shape
        flat_live = [
            np.flatnonzero(book.valid_h.reshape(-1)) for book in self._books
        ]
        ns = [len(f) for f in flat_live]
        n_max = max(ns)
        if n_max == 0:
            return
        k_new = k_for(n_max, self.rows_per_bucket)
        cdt = s.centroids.dtype
        a_chunk = ASSIGN_CHUNK if k_new <= (1 << 15) else 1024

        # --- per-shard k-means seeds: strided live sample (empty shards
        # get zeros — nothing will be placed in them)
        seed_ids = np.zeros((S, k_new), dtype=np.int32)
        for sdx, fl in enumerate(flat_live):
            if ns[sdx] == 0:
                continue
            stride = max(ns[sdx] // k_new, 1)
            sample = fl[::stride][:k_new]
            reps = -(-k_new // len(sample))
            seed_ids[sdx] = np.tile(sample, reps)[:k_new]
        centroids = _sh_gather_rows(
            s, self._to_dev_stack(seed_ids), self._holder
        ).astype(cdt)

        # --- per-shard Lloyd sample, padded to one chunk count
        def chunks_of(fl, nn, cap):
            if nn == 0:
                return np.full((1, a_chunk), -1, dtype=np.int32)
            stride = max(nn // min(nn, cap), 1)
            return _chunked(fl[::stride][: min(nn, cap)], a_chunk)

        sample_parts = [
            chunks_of(fl, nn, LLOYD_SAMPLE) for fl, nn in zip(flat_live, ns)
        ]
        c_max = max(p.shape[0] for p in sample_parts)
        sample_chunks = np.full((S, c_max, a_chunk), -1, dtype=np.int32)
        for sdx, p in enumerate(sample_parts):
            sample_chunks[sdx, : p.shape[0]] = p
        sample_chunks = self._to_dev_stack(sample_chunks)
        for _ in range(LLOYD_ITERS):
            centroids = _sh_lloyd_iter(
                s, centroids, sample_chunks, self.space, self._holder
            )

        # --- assign every live row per shard (top-SPILL for the cascade)
        full_parts = [
            _chunked(fl, a_chunk)
            if nn
            else np.full((1, a_chunk), -1, dtype=np.int32)
            for fl, nn in zip(flat_live, ns)
        ]
        c_max = max(p.shape[0] for p in full_parts)
        full_chunks = np.full((S, c_max, a_chunk), -1, dtype=np.int32)
        for sdx, p in enumerate(full_parts):
            full_chunks[sdx, : p.shape[0]] = p
        all_cids = np.asarray(
            _sh_assign_pass(
                s,
                centroids,
                self._to_dev_stack(full_chunks),
                self.space,
                SPILL,
                self._holder,
            )
        ).reshape(S, -1, SPILL)

        # --- host placement per shard into one shared (k_new, b_new)
        b_new = bucket_for(n_max, k_new)
        while True:
            plans = []
            ok = True
            for sdx in range(S):
                used = np.zeros((k_new,), dtype=np.int64)
                kk, pp, unplaced = plan_placement(
                    all_cids[sdx, : ns[sdx]], used, b_new
                )
                if unplaced.any():
                    ok = False
                    break
                plans.append((used, kk, pp))
            if ok:
                break
            b_new = -(-int(b_new * 1.5) // 128) * 128  # stay 128-aligned

        perm = np.full((S, k_new, b_new), int(SENTINEL), dtype=np.int32)
        for sdx, (used, kk, pp) in enumerate(plans):
            perm[sdx, kk, pp] = flat_live[sdx]

        old_rowids = [book.rowid_h.reshape(-1).copy() for book in self._books]
        new = _stack_init(
            D, k_new, b_new, self.dtype, S, self.mesh
        )._replace(centroids=centroids)
        self._state = _sh_permute_build(
            s, new, self._to_dev_stack(perm), self._holder
        )

        # host mirrors follow the same permutation
        for sdx, (used, kk, pp) in enumerate(plans):
            book = self._books[sdx]
            placed = old_rowids[sdx][flat_live[sdx]]
            book.rowid_h = np.full((k_new, b_new), -1, dtype=np.int64)
            book.rowid_h[kk, pp] = placed
            book.valid_h = np.zeros((k_new, b_new), dtype=bool)
            book.valid_h[kk, pp] = True
            book.n_used = used
            book.loc[placed, 0] = kk
            book.loc[placed, 1] = pp
            book.free = {}
        for sdx in range(len(plans), S):  # empty shards reset too
            book = self._books[sdx]
            book.rowid_h = np.full((k_new, b_new), -1, dtype=np.int64)
            book.valid_h = np.zeros((k_new, b_new), dtype=bool)
            book.n_used = np.zeros((k_new,), dtype=np.int64)
            book.free = {}
        self._clustered = True
        self._clustered_at = self.count()
        self._coarse_stale = True  # whole bank permuted on every shard
        self._coarse_bank = None

    # -- query --------------------------------------------------------------

    def search(
        self, queries: np.ndarray, k: int, probes: int | None = None
    ) -> tuple[np.ndarray, np.ndarray]:
        """(dist[n, k] ascending, gids[n, k]); absent results (-inf, -1)."""
        return self._search(queries, k, probes, oracle=False)

    def exact_search(
        self, queries: np.ndarray, k: int
    ) -> tuple[np.ndarray, np.ndarray]:
        """Brute-force oracle over all shards (recall measurement)."""
        return self._search(queries, k, None, oracle=True)

    def _search(self, queries, k, probes, oracle):
        probes = probes or self.probes
        queries = np.asarray(queries, dtype=np.float32)
        single = queries.ndim == 1
        if single:
            queries = queries[None, :]
        n, d = queries.shape
        if d != self.dims:
            raise ValueError(f"dimension mismatch: index {self.dims}, got {d}")
        outs_d, outs_i = [], []
        with self._lock:
            state = self._state
            two_stage = False
            if oracle:
                mode = "flat_exact"
            elif not self._clustered:
                mode = "flat"
            elif self.coarse:
                two_stage = True
                if self._coarse_bank is None or self._coarse_stale:
                    self._coarse_bank = _sh_derive_coarse(state, self._holder)
                    self._coarse_stale = False
                coarse = self._coarse_bank
                cand = min(
                    max(self.rescore * k, 64),
                    min(probes, self.n_clusters) * self.bucket,
                )
            elif scan_kernel_for(self.mesh.devices.flat[0].platform):
                mode = "kernel"
            else:
                mode = "probe"
            for off in range(0, n, QCHUNK):
                blk = queries[off : off + QCHUNK]
                m = len(blk)
                b = next(s for s in (8, 32, 128, QCHUNK) if m <= s)
                if b != m:
                    blk = np.pad(blk, ((0, b - m), (0, 0)))
                if two_stage:
                    dd, ii = _sh_search_two_stage(
                        state,
                        coarse,
                        jnp.asarray(blk),
                        self.space,
                        k,
                        probes,
                        cand,
                        self._holder,
                    )
                else:
                    dd, ii = _sh_search(
                        state,
                        jnp.asarray(blk),
                        self.space,
                        k,
                        probes,
                        mode,
                        self._holder,
                    )
                outs_d.append(dd[:m])
                outs_i.append(ii[:m])
            # all chunk dispatches in flight — one pipelined fetch for
            # everything, under the lock (a later insert donates buffers)
            outs_d, outs_i = jax.device_get((outs_d, outs_i))
        dist = np.concatenate(outs_d)
        ids = np.concatenate(outs_i).astype(np.int64)
        ids[~np.isfinite(dist)] = -1
        if single:
            return dist[0], ids[0]
        return dist, ids

    # -- persistence --------------------------------------------------------

    def save(self, path: str) -> None:
        """Snapshot the stacked sharded bank to one npz (sharded sibling
        of IvfIndex.save; the reference rebuilds from the source DB on
        every restart — SURVEY §5 checkpoint/resume)."""
        import json
        from dataclasses import asdict

        with self._lock:
            s = self._state
            meta = {
                "format": 1,
                "kind": "ivf-sharded",
                "n_shards": self.n_shards,
                "params": asdict(self.params),
                "dtype": self.dtype,
                "probes": self.probes,
                "cluster_min": self.cluster_min,
                "rows_per_bucket": self.rows_per_bucket,
                "coarse": self.coarse,
                "rescore": self.rescore,
                "clustered": self._clustered,
                "clustered_at": self._clustered_at,
                "next_rowid": [b.next_rowid for b in self._books],
                "n_live": [b.n_live for b in self._books],
                "free": [
                    {str(c): v for c, v in b.free.items()} for b in self._books
                ],
            }
            vectors = (
                np.asarray(s.vectors)
                if self.dtype != "bfloat16"
                else np.asarray(s.vectors.astype(jnp.float32))
            )
            atomic_savez(
                path,
                vectors=vectors,
                scales=np.asarray(s.scales),
                valid=np.asarray(s.valid),
                rowid=np.asarray(s.rowid),
                centroids=np.asarray(s.centroids.astype(jnp.float32)),
                n_used=np.stack([b.n_used for b in self._books]),
                meta=np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8),
            )

    @classmethod
    def load(cls, path: str, mesh=None, n_devices: int | None = None):
        import json

        with np.load(path) as z:
            meta = json.loads(bytes(z["meta"]).decode())
            if meta.get("kind") != "ivf-sharded":
                raise ValueError("not a sharded ivf snapshot")
            idx = cls.__new__(cls)
            idx.params = IndexParams(**meta["params"])
            idx.space = idx.params.space
            idx.dtype = meta["dtype"]
            idx.dims = idx.params.dimensions
            idx.probes = meta["probes"]
            idx.cluster_min = meta["cluster_min"]
            idx.rows_per_bucket = meta.get("rows_per_bucket", ROWS_PER_BUCKET)
            import os as _os

            idx.coarse = (
                meta.get("coarse", _os.environ.get("VST_IVF_COARSE") == "1")
                and idx.dtype == "int8"
                and idx.dims % 2 == 0
            )
            idx.rescore = meta.get("rescore", 8)
            idx._coarse_bank = None
            idx._coarse_stale = True
            idx.mesh = mesh or make_mesh(n_devices or meta["n_shards"])
            if idx.mesh.devices.size != meta["n_shards"]:
                raise ValueError(
                    f"snapshot has {meta['n_shards']} shards, mesh has "
                    f"{idx.mesh.devices.size} devices"
                )
            idx._holder = _MeshHolder(idx.mesh)
            idx.n_shards = meta["n_shards"]
            idx._clustered = meta["clustered"]
            idx._clustered_at = meta["clustered_at"]
            idx._lock = threading.Lock()
            # rotating-deal cursor: resume from the total rows ever dealt
            idx._rr = 0  # books rebuilt below; set after next_rowid is known
            valid = np.asarray(z["valid"])  # [S, K, B]
            rowid = np.asarray(z["rowid"])
            n_used = np.asarray(z["n_used"])
            idx._books = []
            for s in range(idx.n_shards):
                book = _ShardBook(valid.shape[1], valid.shape[2])
                book.n_used = n_used[s].astype(np.int64)
                book.valid_h = valid[s]
                book.rowid_h = np.where(
                    valid[s], rowid[s].astype(np.int64), -1
                )
                book.next_rowid = meta["next_rowid"][s]
                book.n_live = meta["n_live"][s]
                book.free = {
                    int(c): list(v) for c, v in meta["free"][s].items()
                }
                book.loc = np.full(
                    (max(book.next_rowid, 1), 2), -1, dtype=np.int64
                )
                ks, poss = np.nonzero(valid[s])
                live_ids = rowid[s][ks, poss].astype(np.int64)
                book.loc[live_ids, 0] = ks
                book.loc[live_ids, 1] = poss
                idx._books.append(book)
            idx._rr = int(
                sum(b.next_rowid for b in idx._books) % idx.n_shards
            )
            sh = NamedSharding(idx.mesh, P(SHARD_AXIS))
            put = lambda a: jax.device_put(jnp.asarray(a), sh)  # noqa: E731
            idx._state = IvfState(
                centroids=put(
                    jnp.asarray(z["centroids"]).astype(_compute_dtype(idx.dtype))
                ),
                vectors=put(
                    jnp.asarray(z["vectors"]).astype(_storage_dtype(idx.dtype))
                ),
                scales=put(z["scales"]),
                valid=put(valid),
                rowid=put(rowid),
            )
        return idx
