"""Host-side index wrapper: slot allocation, batch bucketing, growth.

`SlotIndex` is the synchronous, numpy-in/numpy-out face of the device
index.  It owns everything XLA must not see — the allocation cursor, the
capacity-doubling policy (reference grow-when-low: src/index/usearch.rs:
60-66,201-212) and the padding of variable-size requests into a small set
of static shapes so the jit cache stays small (one compilation per
(batch-bucket, capacity) pair).

Key↔slot mapping is *not* here: the engine layer owns the bimap
(reference: src/index/usearch.rs:109-113), keeping the core purely
numeric.
"""

from __future__ import annotations

import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np

from ..types import IndexParams
from ..utils.memory import device_memory_bytes
from . import build, bruteforce, graph, search
from .graph import GraphConfig, GraphState

# Insert batch block: adds are chunked into blocks of this size (one jit
# cache entry).  The last partial block is padded with dead lanes.
INSERT_BLOCK = 256

# Hierarchical-router activation threshold: below this many rows the flat
# strided sample (≤ rows/8 gathered once per query batch) is cheap and
# entry quality is excellent; above it the centroid router takes over and
# is rebuilt every time the row count doubles (core/cluster.py).
ROUTE_MIN_ROWS = 1 << 18

# Query batches are padded up to the nearest bucket.
QUERY_BUCKETS = (1, 8, 32, 128, 512, 2048)

INVALID = graph.INVALID


def routing_sample_for(capacity: int) -> int:
    """Routing-stage sample size: the coarse-quantizer role of HNSW's
    upper layers.  Scales with capacity — empirically sample ≈ C/8
    keeps entry-point misses negligible (recall 0.98 at 100K where C/16
    plateaued at 0.93; capping at 64K cost 1M-scale recall the same
    way).  The sample matmul is ≈ 1/8 of a full scan — still a minority
    of the search step, whose cost is gather-bound.

    Capped so that a 2048-query batch's [Q, sample] f32 distance block
    stays within 1/8 of device memory (device_memory_bytes // 65536
    rows), which a multi-GB bank shares.  Past the cap, entry quality
    degrades; the centroid router (core/cluster.py) takes over above
    ROUTE_MIN_ROWS."""
    return int(min(max(4096, capacity // 8), device_memory_bytes() // 65536))


def config_from_params(params: IndexParams, capacity: int = 1 << 16) -> GraphConfig:
    """Translate the reference's usearch knobs into kernel config."""
    return GraphConfig(
        dims=params.dimensions,
        degree=max(params.connectivity, 4),
        ef_search=max(params.expansion_search, 64),
        ef_add=max(params.expansion_add, 64),
        space=params.space,
        dtype=params.dtype if params.dtype in ("float32", "int8") else "bfloat16",
        routing_sample=routing_sample_for(capacity),
        entry_points=16,
    )


def _bucket(n: int) -> int:
    for b in QUERY_BUCKETS:
        if n <= b:
            return b
    return -(-n // QUERY_BUCKETS[-1]) * QUERY_BUCKETS[-1]


class SlotIndex:
    """Single-device ANN index over integer slots.

    Thread-safe: every device op (mutation or query) runs under one lock.
    Insert donates its input buffers to XLA (zero-copy update), which
    invalidates the pre-update arrays — so a query must never overlap a
    mutation on the same index.  The lock is the RwLock role of the
    reference (src/index/usearch.rs:98), made exclusive because queries
    are batched into few coarse device calls anyway; cross-index
    parallelism is unaffected.
    """

    def __init__(
        self,
        params: IndexParams,
        initial_capacity: int | None = None,
        exact: bool = False,
        insert_block: int = INSERT_BLOCK,
    ) -> None:
        self.params = params
        if exact:
            # graph-free upload ingests in big blocks at copy speed
            insert_block = max(insert_block, 4096)
        self.insert_block = insert_block
        cap = initial_capacity or min(params.capacity, 1 << 16)
        cap = max(cap, 2 * insert_block)
        self.cfg = config_from_params(params, cap)
        if exact:
            # the scan never touches adjacency — keep it a 1-wide stub so
            # HBM holds the flat bank only (a 10M x 768 int8 bank fits
            # where a degree-32 graph would not)
            self.cfg = dataclasses.replace(self.cfg, degree=1)
        self._state: GraphState = graph.init(self.cfg, cap)
        self._exact = exact
        self._route_built_at = 0  # frontier at last router (re)build
        self._lock = threading.Lock()

    @classmethod
    def restore(
        cls,
        params: IndexParams,
        cfg: GraphConfig,
        state: GraphState,
        exact: bool,
        insert_block: int,
    ) -> "SlotIndex":
        """Rebuild an index around an existing device state (persist.load).

        Lives next to __init__ so the field inventory has one home — a
        new constructor invariant must be reflected here.
        """
        idx = cls.__new__(cls)
        idx.params = params
        idx.cfg = cfg
        idx.insert_block = insert_block
        idx._exact = exact
        idx._state = state
        idx._route_built_at = int(state.frontier) if cfg.route_k > 0 else 0
        idx._lock = threading.Lock()
        return idx

    # -- introspection ----------------------------------------------------

    @property
    def state(self) -> GraphState:
        return self._state

    def count(self) -> int:
        return int(self._state.size)

    @property
    def capacity(self) -> int:
        return self._state.capacity

    @property
    def frontier(self) -> int:
        return int(self._state.frontier)

    # -- mutation ----------------------------------------------------------

    def _ensure_capacity(self, needed_rows: int) -> None:
        state = self._state
        need = int(state.frontier) + needed_rows
        cap = state.capacity
        # Grow when free rows drop below a block of headroom —
        # the reference's grow-when-low policy, reshaped around blocks.
        if need + self.insert_block <= cap:
            return
        new_cap = cap
        while need + self.insert_block > new_cap:
            new_cap *= 2
        self._state = graph.grow(state, new_cap)
        # routing sample scales with capacity (recompiles happen anyway)
        self.cfg = dataclasses.replace(
            self.cfg, routing_sample=routing_sample_for(new_cap)
        )

    def add(self, vectors: np.ndarray) -> np.ndarray:
        """Insert vectors; returns their assigned slots [n]."""
        vectors = np.asarray(vectors, dtype=np.float32)
        if vectors.ndim == 1:
            vectors = vectors[None, :]
        n, d = vectors.shape
        if d != self.cfg.dims:
            raise ValueError(
                f"dimension mismatch: index {self.cfg.dims}, got {d}"
            )
        with self._lock:
            self._ensure_capacity(n)
            base = int(self._state.frontier)
            slots = np.arange(base, base + n, dtype=np.int32)
            # exact mode never walks a graph — ingest at copy speed
            step = build.upload if self._exact else build.insert
            block = self.insert_block
            if self.cfg.dtype != "float32":
                # halve host->device bytes: the bank stores bf16 (or
                # int8 quantized from it), so shipping f32 wastes the
                # host link
                import ml_dtypes

                vectors = vectors.astype(ml_dtypes.bfloat16)
            # Bound the async dispatch queue: ~100MB of host->device
            # blocks per sync keeps transfer/compute overlap without
            # queueing the whole ingest.
            blk_bytes = block * d * vectors.dtype.itemsize
            sync_every = max(1, (100 << 20) // max(blk_bytes, 1))
            for i, off in enumerate(range(0, n, block)):
                blk = vectors[off : off + block]
                m = blk.shape[0]
                live = np.zeros((block,), dtype=bool)
                live[:m] = True
                if m < block:
                    blk = np.pad(blk, ((0, block - m), (0, 0)))
                self._state = step(
                    self._state,
                    jnp.int32(base + off),
                    jnp.asarray(blk),
                    jnp.asarray(live),
                    self.cfg,
                )
                if (i + 1) % sync_every == 0:
                    jax.block_until_ready(self._state.size)
                self._maybe_rebuild_router_locked(base + off + m)
            # End-of-call staleness bound: the in-loop policy rebuilds at
            # doubling, so a bulk load can finish with up to half the
            # bank ring-assigned onto a stale centroid set (rings evict
            # under 2x design load — measured 1M recall 0.954 vs 0.986
            # flat).  A 1.25x threshold here caps staleness at 25% and,
            # being per-CALL, costs streaming ingest at most ~3 extra
            # rebuilds per doubling.
            f = base + n
            if (
                not self._exact
                and f >= ROUTE_MIN_ROWS
                and f >= 1.25 * self._route_built_at
            ):
                self._rebuild_router_locked(f)
            return slots

    # -- hierarchical router ------------------------------------------------

    def _maybe_rebuild_router_locked(self, frontier: int) -> None:
        """(Re)cluster when the bank doubled since the last build.

        Called under self._lock.  Exact-scan indexes never route; small
        banks stay on the flat sample (ROUTE_MIN_ROWS)."""
        if self._exact or frontier < ROUTE_MIN_ROWS:
            return
        if frontier < 2 * self._route_built_at:
            return
        self._rebuild_router_locked(frontier)

    def _rebuild_router_locked(self, frontier: int, k: int | None = None) -> None:
        from . import cluster

        k = k or cluster.route_k_for(frontier)
        cfg = dataclasses.replace(self.cfg, route_k=k)
        centroids, members, m_cnt = cluster.build_router(
            self._state, cfg, k, cfg.route_members_per
        )
        self.cfg = cfg
        self._state = self._state._replace(
            route_centroids=centroids,
            route_members=members,
            route_cnt=m_cnt,
        )
        self._route_built_at = frontier

    def rebuild_router(self) -> None:
        """Force a router rebuild at the current frontier (bulk-load tail
        call; add() triggers the same thing automatically on doubling)."""
        with self._lock:
            f = int(self._state.frontier)
            if not self._exact and f >= ROUTE_MIN_ROWS:
                self._rebuild_router_locked(f)

    def refine(self, passes: int = 1, block: int = 256) -> None:
        """Run NN-descent refinement sweeps over the whole graph
        (build.refine_block): re-derives every node's edges from its
        2-hop neighbourhood.  Lifts recall after bulk loads and repairs
        insert-order asymmetry; one pass is usually enough."""
        with self._lock:
            for _ in range(passes):
                frontier = int(self._state.frontier)
                for base in range(0, frontier, block):
                    self._state = build.refine_block(
                        self._state, jnp.int32(base), block, self.cfg
                    )

    def compact(self) -> dict[int, int]:
        """Reclaim tombstoned rows: rebuild the index from its live rows.

        Deletes are lazy tombstones (usearch semantics); long churn leaves
        dead rows that cost memory and traversal.  Compaction gathers the
        live (preprocessed) vectors, rebuilds into a fresh graph, and
        returns {old_slot: new_slot} so the owner (engine keymap) can
        remap.  The reference's only answer to fragmentation was a full
        rebuild from the source DB (SURVEY §5 checkpoint/resume: none);
        this rebuilds from the index itself.
        """
        scratch, remap = self.compact_prepare()
        self.compact_install(scratch)
        return remap

    def compact_prepare(self) -> tuple["SlotIndex", dict[int, int]]:
        """Rebuild the live rows into a SCRATCH index offline, without
        touching the serving state — queries keep seeing the consistent
        (old state, old slot numbering) pair for the whole rebuild.
        Returns (scratch, {old_slot: new_slot}); the owner rebinds its
        keymap and calls compact_install atomically with respect to its
        query path.  Mutations must not interleave between prepare and
        install (the actor mailbox serializes them against Compact)."""
        with self._lock:
            state = self._state
            valid = np.asarray(state.valid)
            live_slots = np.nonzero(valid)[0]
            vectors = np.asarray(
                jnp.take(
                    state.vectors, jnp.asarray(live_slots, dtype=jnp.int32), axis=0
                ).astype(jnp.float32)
            )
            if self.cfg.quantized:
                scales = np.asarray(
                    jnp.take(state.scales, jnp.asarray(live_slots, dtype=jnp.int32))
                )
                vectors = vectors * scales[:, None]
            cfg = self.cfg
        cap = max(
            1 << int(max(len(live_slots), 1) - 1).bit_length(),
            2 * self.insert_block,
        )
        new_cfg = dataclasses.replace(
            cfg,
            routing_sample=routing_sample_for(cap),
            route_k=0,  # router rebuilt from scratch by the re-add
        )
        scratch = SlotIndex.restore(
            self.params,
            new_cfg,
            graph.init(new_cfg, cap),
            self._exact,
            self.insert_block,
        )
        scratch._route_built_at = 0
        # note: vectors are already preprocessed (unit-norm for cosine);
        # re-preprocessing is idempotent for all supported spaces
        new_slots = scratch.add(vectors)
        return scratch, {int(o): int(n) for o, n in zip(live_slots, new_slots)}

    def compact_install(self, scratch: "SlotIndex") -> None:
        """Swap in the state prepared by compact_prepare."""
        with self._lock:
            self.cfg = scratch.cfg
            self._state = scratch._state
            self._route_built_at = scratch._route_built_at

    def remove(self, slots: np.ndarray) -> None:
        # dedup: a slot repeated in one batch would double-decrement the
        # device size counter (delete_impl lanes all read pre-update validity)
        slots = np.unique(np.asarray(slots, dtype=np.int32).reshape(-1))
        if slots.size == 0:
            return
        with self._lock:
            n = slots.size
            b = _bucket(n)
            live = np.zeros((b,), dtype=bool)
            live[:n] = True
            padded = np.full((b,), 0, dtype=np.int32)
            padded[:n] = slots
            self._state = build.delete(
                self._state, jnp.asarray(padded), jnp.asarray(live)
            )

    # -- query -------------------------------------------------------------

    def search_dispatch(
        self, queries: np.ndarray, k: int, exact: bool | None = None
    ):
        """Dispatch a batched ANN query; returns fetch() -> (dist, slots).

        The device step is issued under the index lock; the returned
        closure blocks on the host readback and may run OUTSIDE the lock.
        Safe because a single device executes computations in dispatch
        order: a later insert's donated-buffer step runs strictly after
        this search's kernels finish, and the fetched arrays are fresh
        search outputs, never aliased to the bank.  Releasing the lock
        before the readback lets the serving path keep multiple device
        batches in flight (MicroBatcher depth).
        """
        exact = self._exact if exact is None else exact
        queries = np.asarray(queries, dtype=np.float32)
        single = queries.ndim == 1
        if single:
            queries = queries[None, :]
        n, d = queries.shape
        if d != self.cfg.dims:
            raise ValueError(
                f"dimension mismatch: index {self.cfg.dims}, got {d}"
            )
        b = _bucket(n)
        if b != n:
            queries = np.pad(queries, ((0, b - n), (0, 0)))
        with self._lock:
            state = self._state
            if exact:
                # The bank is stored preprocessed; match the queries to it.
                from . import distance as dist_mod

                qp = dist_mod.preprocess(jnp.asarray(queries), self.cfg.space)
                dist, ids = bruteforce.search(
                    qp.astype(self.cfg.compute_dtype),
                    state.vectors,
                    state.valid,
                    self.cfg.space,
                    k,
                    scales=state.scales if self.cfg.quantized else None,
                )
            else:
                dist, ids = search.search(state, jnp.asarray(queries), self.cfg, k)
            dist, ids = dist[:n], ids[:n]

        def fetch() -> tuple[np.ndarray, np.ndarray]:
            # One pipelined fetch for both arrays — device_get issues the
            # host copies async before blocking.
            dist_h, ids_h = jax.device_get((dist, ids))
            ids_h = ids_h.astype(np.int64)
            ids_h[~np.isfinite(dist_h)] = -1
            if single:
                return dist_h[0], ids_h[0]
            return dist_h, ids_h

        return fetch

    def search(
        self, queries: np.ndarray, k: int, exact: bool | None = None
    ) -> tuple[np.ndarray, np.ndarray]:
        """Batched ANN query → (dist[n, k], slots[n, k]); missing results
        are (+inf, -1).  `exact` overrides the index's default backend."""
        return self.search_dispatch(queries, k, exact)()

    def exact_search(
        self, queries: np.ndarray, k: int
    ) -> tuple[np.ndarray, np.ndarray]:
        """Brute-force oracle over the same state (recall measurement)."""
        return self.search(queries, k, exact=True)

    def get_vectors(self, slots: np.ndarray) -> np.ndarray:
        """Fetch (preprocessed) stored vectors for slots — persist/debug."""
        return np.asarray(
            jnp.take(self._state.vectors, jnp.asarray(slots, dtype=jnp.int32), axis=0)
        )
