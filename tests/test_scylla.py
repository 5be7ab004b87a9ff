"""ScyllaSource adapter tests over a wire-level fake session.

The reference tested its DB layer through an in-memory protocol fake
(tests/integration/db_basic.rs); this fake sits one level LOWER — at the
CQL/cluster-state surface (the ScyllaSession protocol) — so every logic
path in ingest/scylla.py (range math, row parsing, CDC mapping, validity
checks, discovery) runs for real, awaiting only a driver adapter.
"""

import asyncio
import uuid

import numpy as np
import pytest

from vector_store_tpu.ingest import scylla
from vector_store_tpu.ingest.scylla import (
    TOKEN_MAX,
    TOKEN_MIN,
    ScyllaSource,
    fullscan_ranges,
    timeuuid_to_timestamp,
)
from vector_store_tpu.types import IndexMetadata, IndexId


def _timeuuid_from_ticks(ticks: int) -> uuid.UUID:
    time_low = ticks & 0xFFFFFFFF
    time_mid = (ticks >> 32) & 0xFFFF
    time_hi = ((ticks >> 48) & 0x0FFF) | 0x1000  # version 1
    return uuid.UUID(
        fields=(time_low, time_mid, time_hi, 0x80, 0x00, 0x123456789ABC)
    )


def _timeuuid(micros_since_unix: int) -> uuid.UUID:
    """Build a v1 uuid whose timestamp equals the given unix-µs instant."""
    return _timeuuid_from_ticks(
        (micros_since_unix - scylla.GREGORIAN_TO_UNIX_MICROS) * 10
    )


class FakeSession:
    """Wire-level ScyllaDB stand-in: CQL strings in, canned rows out."""

    def __init__(self, dims=4):
        self.dims = dims
        self.schema_version = "v1"
        self.agreement_ok = True
        self.ring = [-(2**62), 0, 2**62]
        self.shards = 2
        # base table rows: {pk: (embedding, writetime_us)}
        self.rows = {}
        self.cdc_rows = []  # (timeuuid, op, pk, embedding-or-None)
        self.scanned_ranges = []
        self.concurrent = 0
        self.max_concurrent = 0
        self.tables = {
            "items": {"partition_key": ["id"], "clustering_key": ["sub"]},
            "items_scylla_cdc_log": {"partition_key": ["id"], "clustering_key": []},
        }

    # --- ScyllaSession protocol
    def ring_tokens(self):
        return self.ring

    def nr_shards(self):
        return self.shards

    async def await_schema_agreement(self):
        return self.schema_version if self.agreement_ok else None

    async def check_schema_agreement(self):
        return self.schema_version if self.agreement_ok else None

    def keyspace_tables(self, keyspace):
        return self.tables if keyspace == "ks" else None

    def _token(self, pk):
        # deterministic fake token in [TOKEN_MIN, TOKEN_MAX]
        return (hash(pk) % (2 * TOKEN_MAX + 1)) - TOKEN_MAX

    async def execute(self, query, params=()):
        if query == scylla.ST_LATEST_SCHEMA_VERSION:
            return [(self.schema_version,)]
        if query == scylla.ST_GET_INDEXES:
            return [("ks", "vecidx", "items", {"target": "emb"})]
        if query == scylla.ST_GET_INDEX_VERSION:
            assert params == ("ks", "vecidx_index")
            return [("11111111-2222-3333-4444-555555555555",)]
        if query == scylla.ST_GET_INDEX_TARGET_TYPE:
            assert params == ("ks", "items", "emb")
            return [(f"vector<float, {self.dims}>",)]
        if query.startswith("SELECT id, sub, emb, writetime(emb)"):
            begin, end = params
            self.scanned_ranges.append((begin, end))
            self.concurrent += 1
            self.max_concurrent = max(self.max_concurrent, self.concurrent)
            await asyncio.sleep(0.01)  # let scans overlap
            self.concurrent -= 1
            out = []
            for pk, (emb, wt) in self.rows.items():
                if begin <= self._token(pk) <= end:
                    out.append((*pk, emb, wt))
            return out
        if "items_scylla_cdc_log" in query:
            # the server's `"cdc$time" > ?` compares TIMEUUIDs by their
            # 60-bit timestamp first (bytes as tiebreak), NOT by UUID.int
            (cursor,) = params
            key = lambda u: (u.time, u.bytes)  # noqa: E731
            return [
                (tu, op, *pk, emb)
                for tu, op, pk, emb in self.cdc_rows
                if key(tu) > key(cursor)
            ]
        raise AssertionError(f"unexpected query: {query}")


def test_fullscan_ranges_cover_the_ring_exactly():
    """Circular windows with the ±MAX sentinels (db_index.rs:268-295):
    ranges are disjoint and cover every token exactly once."""
    ring = [-(2**62), 0, 2**61]
    ranges = fullscan_ranges(ring)
    assert (TOKEN_MIN, -(2**62) - 1) in ranges
    assert ranges[-1][1] == TOKEN_MAX or any(e == TOKEN_MAX for _, e in ranges)
    # coverage + disjointness over probe tokens
    probes = [TOKEN_MIN, -(2**62), -1, 0, 5, 2**61, TOKEN_MAX]
    for t in probes:
        hits = [r for r in ranges if r[0] <= t <= r[1]]
        assert len(hits) == 1, (t, hits)
    # empty ring → one full-range scan
    assert fullscan_ranges([]) == [(TOKEN_MIN, TOKEN_MAX)]


def test_timeuuid_epoch_conversion():
    """Gregorian 1582-10-15 epoch handling (db_index.rs:436-446)."""
    micros = 1_700_000_000_000_000  # some unix instant
    tu = _timeuuid(micros)
    assert timeuuid_to_timestamp(tu).micros == micros


@pytest.mark.asyncio
async def test_control_plane_discovery():
    sess = FakeSession(dims=6)
    src = ScyllaSource(sess)
    assert await src.latest_schema_version() == "v1"
    metas = await src.get_indexes()
    assert len(metas) == 1
    m = metas[0]
    assert m.index_id.value == "ks.vecidx"
    assert m.params.dimensions == 6
    assert m.key_columns == ("id", "sub")
    assert m.version == "11111111-2222-3333-4444-555555555555"


@pytest.mark.asyncio
async def test_validity_checks():
    sess = FakeSession()
    src = ScyllaSource(sess)
    assert await src.is_valid_index("ks", "items")
    # missing keyspace
    assert not await src.is_valid_index("nope", "items")
    # missing CDC log
    del sess.tables["items_scylla_cdc_log"]
    assert not await src.is_valid_index("ks", "items")
    sess.tables["items_scylla_cdc_log"] = {}
    # schema disagreement → invalid, discovery skips the index
    sess.agreement_ok = False
    assert not await src.is_valid_index("ks", "items")
    assert await src.get_indexes() == []


@pytest.mark.asyncio
async def test_initial_scan_parallel_and_parsed():
    """Scan covers all rows across ranges, runs ranges concurrently
    (shards×3), parses rows, and skips malformed ones."""
    sess = FakeSession(dims=4)
    rng = np.random.default_rng(0)
    for i in range(40):
        sess.rows[(i, f"s{i}")] = (
            rng.normal(size=4).astype(np.float32).tolist(),
            1_000_000 + i,
        )
    sess.rows[(99, None)] = ([0.0] * 4, 2_000_000)  # missing pk column
    sess.rows[(98, "s98")] = (None, 2_000_000)  # missing embedding
    src = ScyllaSource(sess)
    meta = IndexMetadata(index_id=IndexId("ks.vecidx"))
    stream = await src.get_db_index(meta)
    assert await stream.primary_key_columns() == ("id", "sub")

    got = {}
    async with asyncio.timeout(30):
        for _ in range(40):
            e = await stream.get()
            assert e is not None
            got[e.primary_key] = e
    assert len(got) == 40
    assert got[(3, "s3")].timestamp.micros == 1_000_003
    np.testing.assert_allclose(
        got[(3, "s3")].embedding, sess.rows[(3, "s3")][0], rtol=1e-6
    )
    # every ring range was scanned; concurrency really overlapped
    assert len(sess.scanned_ranges) == len(fullscan_ranges(sess.ring))
    assert sess.max_concurrent > 1
    stream.stop()


@pytest.mark.asyncio
async def test_cdc_upsert_and_tombstone():
    sess = FakeSession(dims=4)
    src = ScyllaSource(sess)
    meta = IndexMetadata(index_id=IndexId("ks.vecidx"))
    stream = await src.get_db_index(meta)

    t1 = 1_700_000_000_000_000
    sess.cdc_rows.append((_timeuuid(t1), 1, (7, "a"), [1.0, 2.0, 3.0, 4.0]))
    async with asyncio.timeout(30):
        e = await stream.get()
    assert e.primary_key == (7, "a")
    assert e.timestamp.micros == t1
    np.testing.assert_allclose(e.embedding, [1.0, 2.0, 3.0, 4.0])

    # deleted column → tombstone event (db_index.rs:400-416)
    sess.cdc_rows.append((_timeuuid(t1 + 5), 2, (7, "a"), None))
    async with asyncio.timeout(30):
        e = await stream.get()
    assert e.embedding is None and e.timestamp.micros == t1 + 5

    # cursor advanced: no replays
    stream.stop()
    async with asyncio.timeout(30):
        assert await stream.get() is None  # stream closes after stop


@pytest.mark.asyncio
async def test_cdc_cursor_advances_by_timeuuid_order():
    """The poll cursor advanced by UUID.int — which leads
    with time_low — so a later-in-time row with a smaller int never
    became the cursor and everything above it was re-fetched every poll.
    The cursor must follow timeuuid (timestamp-first) ordering."""
    sess = FakeSession(dims=4)
    src = ScyllaSource(sess)
    meta = IndexMetadata(index_id=IndexId("ks.vecidx"))
    stream = await src.get_db_index(meta)

    base = 5 << 32
    ta = _timeuuid_from_ticks(base + 0xFFFFFFF0)  # small time, HUGE int
    tb = _timeuuid_from_ticks(base + (1 << 32) + 0x10)  # later time, small int
    assert ta.int > tb.int and ta.time < tb.time  # orders disagree

    sess.cdc_rows.append((ta, 1, (1, "a"), [1.0, 1.0, 1.0, 1.0]))
    async with asyncio.timeout(30):
        e = await stream.get()
    assert e.primary_key == (1, "a")

    sess.cdc_rows.append((tb, 1, (2, "b"), [2.0, 2.0, 2.0, 2.0]))
    async with asyncio.timeout(30):
        e = await stream.get()
    assert e.primary_key == (2, "b")

    # cursor is now tb by timeuuid order: NOTHING is re-delivered
    with pytest.raises(TimeoutError):
        async with asyncio.timeout(scylla.CDC_POLL_S * 5):
            await stream.get()
    stream.stop()


@pytest.mark.asyncio
async def test_full_pipeline_on_fake_session():
    """monitor_indexes + monitor_items drive the engine from a
    ScyllaSource, end to end (the db_basic.rs usage pattern, one level
    lower)."""
    from vector_store_tpu.engine.ann_index import AnnIndexFactory
    from vector_store_tpu.engine.engine import new_engine
    from vector_store_tpu.ingest.monitor_indexes import MonitorIndexes

    sess = FakeSession(dims=4)
    rng = np.random.default_rng(1)
    vecs = rng.normal(size=(10, 4)).astype(np.float32)
    for i in range(10):
        sess.rows[(i, f"s{i}")] = (vecs[i].tolist(), 1_000 + i)

    engine = await new_engine(AnnIndexFactory())
    src = ScyllaSource(sess)
    monitor = MonitorIndexes(src, engine, tick_s=0.05)
    mon = monitor.spawn()
    try:
        async with asyncio.timeout(60):
            while True:
                handle = await engine.get_index(IndexId("ks.vecidx"))
                if handle is not None and await handle.count() == 10:
                    break
                await asyncio.sleep(0.05)
        from vector_store_tpu.types import Limit

        keys, _ = await handle.ann(vecs[4], Limit(1))
        assert keys[0] == (4, "s4")
    finally:
        mon.cancel()
        try:
            await mon
        except asyncio.CancelledError:
            pass
        await engine.close()


# --- DriverSession: the live-driver adapter, tested against a fake
# driver session (duck-typed — the cassandra package is not required;
# the live handshake test below is gated on its availability) ----------


class _FakeResponseFuture:
    """Driver-shaped future: the ok callback fires once per page, and
    `start_fetching_next_page` re-fires it with the next page's rows."""

    def __init__(self, rows=None, exc=None, pages=None):
        self._pages = list(pages) if pages is not None else [rows]
        self._exc = exc
        self._ok = None

    @property
    def has_more_pages(self):
        return len(self._pages) > 1

    def start_fetching_next_page(self):
        self._pages.pop(0)
        self._ok(self._pages[0])

    def add_callbacks(self, ok, err):
        if self._exc is not None:
            err(self._exc)
        else:
            self._ok = ok
            ok(self._pages[0])


class _FakeDriverSession:
    """Mimics cassandra.cluster.Session + .cluster metadata surface."""

    def __init__(self):
        self.prepared = []
        self.executed = []

        class _Col:
            def __init__(self, name):
                self.name = name

        class _Table:
            def __init__(self, pk, ck):
                self.partition_key = [_Col(c) for c in pk]
                self.clustering_key = [_Col(c) for c in ck]

        class _Ks:
            tables = {
                "items": _Table(("id",), ("ts",)),
                "items_scylla_cdc_log": _Table(("id",), ()),
            }

        class _Token:
            def __init__(self, v):
                self.value = v

        class _TokenMap:
            ring = [_Token(-100), _Token(0), _Token(100)]

        class _ShardInfo:
            shards_count = 4

        class _Host:
            sharding_info = _ShardInfo()

        class _ControlConnection:
            @staticmethod
            def wait_for_schema_agreement(wait_time=None):
                return True

        class _Metadata:
            keyspaces = {"ks": _Ks()}
            token_map = _TokenMap()

            @staticmethod
            def all_hosts():
                return [_Host(), _Host()]

        class _Cluster:
            metadata = _Metadata()
            control_connection = _ControlConnection()

        self.cluster = _Cluster()

    def prepare(self, query):
        self.prepared.append(query)
        return ("prepared", query)

    def execute_async(self, stmt, params=None):
        self.executed.append((stmt, params))
        if "system.local" in str(stmt):
            return _FakeResponseFuture(rows=[("v42",)])
        if "boom" in str(stmt):
            return _FakeResponseFuture(exc=RuntimeError("boom"))
        if "paged" in str(stmt):
            return _FakeResponseFuture(
                pages=[[(1, "a")], [(2, "b")], [(3, "c")]]
            )
        return _FakeResponseFuture(rows=[(1, "a"), (2, "b")])


@pytest.mark.asyncio
async def test_driver_session_adapter():
    from vector_store_tpu.ingest.scylla import DriverSession

    fake = _FakeDriverSession()
    s = DriverSession(fake)

    # unparameterized query: no prepare, rows as tuples
    rows = await s.execute("SELECT x FROM t")
    assert rows == [(1, "a"), (2, "b")]
    assert fake.prepared == []

    # parameterized query: prepared once, cached across calls
    await s.execute("SELECT x FROM t WHERE id = ?", (1,))
    await s.execute("SELECT x FROM t WHERE id = ?", (2,))
    assert fake.prepared == ["SELECT x FROM t WHERE id = ?"]
    assert fake.executed[-1] == (
        ("prepared", "SELECT x FROM t WHERE id = ?"),
        (2,),
    )

    # multi-page results are drained to completion, not truncated to the
    # first driver page (fetch_size default is 5000 rows)
    rows = await s.execute("SELECT paged FROM t")
    assert rows == [(1, "a"), (2, "b"), (3, "c")]

    # driver errors propagate as exceptions
    with pytest.raises(RuntimeError, match="boom"):
        await s.execute("boom")

    # cluster-state surface
    assert s.ring_tokens() == [-100, 0, 100]
    assert s.nr_shards() == 8  # 2 hosts x 4 shards
    assert await s.await_schema_agreement() == "v42"
    assert await s.check_schema_agreement() == "v42"
    tables = s.keyspace_tables("ks")
    assert tables["items"] == {
        "partition_key": ["id"],
        "clustering_key": ["ts"],
    }
    assert "items_scylla_cdc_log" in tables
    assert s.keyspace_tables("nope") is None


@pytest.mark.asyncio
async def test_driver_session_through_source():
    """The full control-plane path (is_valid_index) over the adapter."""
    from vector_store_tpu.ingest.scylla import DriverSession, ScyllaSource

    src = ScyllaSource(DriverSession(_FakeDriverSession()))
    assert await src.is_valid_index("ks", "items")
    assert not await src.is_valid_index("nope", "items")


def test_connect_requires_driver():
    """connect() raises a helpful error when the driver is absent, and a
    live socket handshake runs when it is installed (driver-gated)."""
    from vector_store_tpu.ingest.scylla import ScyllaSource

    try:
        import cassandra  # noqa: F401
    except ImportError:
        with pytest.raises(RuntimeError, match="cassandra/scylla driver"):
            ScyllaSource.connect("127.0.0.1:9042")
        return
    import socket

    with socket.socket() as probe:  # pragma: no cover — needs a cluster
        probe.settimeout(0.5)
        if probe.connect_ex(("127.0.0.1", 9042)) != 0:
            pytest.skip("no scylla at 127.0.0.1:9042")
    src = ScyllaSource.connect("127.0.0.1:9042")
    assert asyncio.run(src.latest_schema_version()) is not None
