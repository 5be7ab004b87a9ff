#!/usr/bin/env python
"""Smoke run of the served path on the card.

    python chip_smoke.py              # one GPU: every phase below
    python chip_smoke.py --cards 4    # four GPUs: the sharded phase only

It starts the engine and HTTP app through `run(addr,
new_index_factory(...))`, the entry `python -m vector_store_tpu` uses,
feeds rows through the CDC path (MemDb initial scan → monitor_items →
index actor, the `--demo` wiring), and queries over HTTP from a
standard-library client running off the server's event loop.  Data is
the bench's clustered synthetic corpus, made from --seed; queries are
perturbed corpus points.  Every answer is checked against a float64
numpy reference:

  ivf     1M x 768 int8 cosine, kind "ivf": recall@10 >= 0.90, each
          returned distance within 2e-2 of numpy's for that id (int8
          quantisation)
  exact   the same corpus, kind "exact", float32: recall@10 >= 0.99 (a
          float32 product may run in TF32 on this card), distances
          within 1e-2
  graph   131,072 x 768 bfloat16, kind "ann": recall@10 >= 0.90,
          distances within 2e-2 (bf16 storage)
  text    20,000 docs via /add, 16 queries: each returned doc's numpy
          BM25 score equals the reference's score at that rank within
          1e-4 relative
  sharded (--cards 4 only) kind "ivf" at 4M x 768 int8 over four cards:
          recall@10 >= 0.90, distances within 2e-2, and every card's
          bytes_in_use grown by at least its shard's rows x 768 bytes

Before JAX starts, the `gpu`-marked tests run in a subprocess (one
process holds the card at a time).  Any failed check raises, and the run
exits non-zero.  The last line of standard output is one JSON object
naming the device.
"""

from __future__ import annotations

import argparse
import asyncio
import concurrent.futures
import json
import math
import os
import subprocess
import sys
import time
import urllib.error
import urllib.request

import numpy as np

from vector_store_tpu.types import IndexParams, primary_key

ROOT = os.path.dirname(os.path.abspath(__file__))

K = 10
D = 768
N_VEC = 1_000_000
N_GRAPH = 131_072
N_PER_CARD = 1_000_000
N_QUERIES = 256
N_DOCS = 20_000
N_TEXT_QUERIES = 16
VOCAB = 5_000
RECALL_BAR = {"ivf": 0.90, "exact": 0.99, "graph": 0.90, "sharded": 0.90}
DIST_TOL = {"ivf": 2e-2, "exact": 1e-2, "graph": 2e-2, "sharded": 2e-2}
BM25_RTOL = 1e-4
INGEST_TIMEOUT_S = 900


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        check=True,
    ).stdout.strip()


def run_gpu_tests() -> None:
    """The `gpu`-marked tests, in a child that exits before this process
    touches the card."""
    t0 = time.time()
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "tests", "-m", "gpu", "-q",
         "-p", "no:cacheprovider"],
        cwd=ROOT,
        env={**os.environ, "VST_TEST_DEVICE": "gpu"},
        capture_output=True,
        text=True,
    )
    tail = proc.stdout.strip().splitlines()[-1:] or ["(no output)"]
    print(f"# gpu tests: rc={proc.returncode} {tail[0]} ({time.time() - t0:.1f}s)")
    if proc.returncode != 0:
        print(proc.stdout[-8000:], proc.stderr[-4000:], file=sys.stderr)
        raise SystemExit(f"gpu-marked tests failed (rc={proc.returncode})")


# -- numpy references ---------------------------------------------------------


def exact_topk(x: np.ndarray, queries: np.ndarray, k: int) -> np.ndarray:
    """float64 cosine top-k ids of each query over the corpus."""
    qn = queries.astype(np.float64)
    qn /= np.linalg.norm(qn, axis=1, keepdims=True)
    best_d = np.full((len(qn), k), np.inf)
    best_i = np.zeros((len(qn), k), dtype=np.int64)
    step = 1 << 17
    for off in range(0, len(x), step):
        blk = x[off : off + step].astype(np.float64)
        blk /= np.maximum(np.linalg.norm(blk, axis=1, keepdims=True), 1e-30)
        d = 1.0 - qn @ blk.T
        part = np.argpartition(d, k - 1, axis=1)[:, :k]
        cand_d = np.concatenate([best_d, np.take_along_axis(d, part, 1)], 1)
        cand_i = np.concatenate([best_i, part + off], 1)
        order = np.argsort(cand_d, axis=1, kind="stable")[:, :k]
        best_d = np.take_along_axis(cand_d, order, 1)
        best_i = np.take_along_axis(cand_i, order, 1)
    return best_i


def cosine_distance(x: np.ndarray, queries: np.ndarray, ids: list) -> list:
    """float64 1 - cos(q, x[id]) for each query's id list."""
    out = []
    for q, row in zip(queries.astype(np.float64), ids):
        v = x[np.asarray(row, dtype=np.int64)].astype(np.float64)
        v /= np.maximum(np.linalg.norm(v, axis=1, keepdims=True), 1e-30)
        out.append(1.0 - v @ (q / np.linalg.norm(q)))
    return out


def bm25_reference(docs: list, k1: float = 1.2, b: float = 0.75):
    """Plain BM25 over tokenised docs; returns score(words) -> [n_docs]
    float64 scores (idf from live document frequencies)."""
    n = len(docs)
    lengths = np.asarray([len(d) for d in docs], dtype=np.float64)
    norm = k1 * (1.0 - b + b * lengths / lengths.mean())
    postings: dict = {}
    for j, words in enumerate(docs):
        uniq, counts = np.unique(np.asarray(words), return_counts=True)
        for w, c in zip(uniq.tolist(), counts.tolist()):
            postings.setdefault(w, ([], []))
            postings[w][0].append(j)
            postings[w][1].append(c)

    def score(words: list) -> np.ndarray:
        s = np.zeros(n)
        for w in dict.fromkeys(words):
            if w not in postings:
                continue
            rows = np.asarray(postings[w][0])
            tf = np.asarray(postings[w][1], dtype=np.float64)
            idf = math.log(1.0 + (n - len(rows) + 0.5) / (len(rows) + 0.5))
            s[rows] += idf * tf * (k1 + 1.0) / (tf + norm[rows])
        return s

    return score


def text_corpus(n_docs: int, n_queries: int, seed: int):
    """Zipf-distributed docs over a vocabulary of distinct term ids (no
    two words share a hashed term id), and plain word queries."""
    from vector_store_tpu.text.tokenizer import term_id

    rng = np.random.default_rng([seed, 7])
    vocab, seen = [], set()
    i = 0
    while len(vocab) < VOCAB:
        w = f"w{i}"
        if term_id(w) not in seen:
            seen.add(term_id(w))
            vocab.append(w)
        i += 1
    p = 1.0 / np.arange(1, VOCAB + 1) ** 1.1
    p /= p.sum()
    docs = [
        [vocab[t] for t in rng.choice(VOCAB, rng.integers(20, 120), p=p)]
        for _ in range(n_docs)
    ]
    queries = [
        [vocab[t] for t in rng.integers(10, 2000, rng.integers(1, 4))]
        for _ in range(n_queries)
    ]
    return docs, queries


# -- HTTP client (standard library, run in worker threads) --------------------


def http(method: str, url: str, body=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(
        url, data=data, method=method, headers={"Content-Type": "application/json"}
    )
    with urllib.request.urlopen(req, timeout=120) as resp:
        raw = resp.read()
    return json.loads(raw) if raw else None


class Client:
    def __init__(self, base: str, workers: int = 32) -> None:
        self.base = base
        self.pool = concurrent.futures.ThreadPoolExecutor(workers)

    async def call(self, method: str, path: str, body=None):
        loop = asyncio.get_running_loop()
        return await loop.run_in_executor(
            self.pool, http, method, self.base + path, body
        )

    async def many(self, method: str, path: str, bodies: list) -> list:
        return await asyncio.gather(*(self.call(method, path, b) for b in bodies))

    def close(self) -> None:
        self.pool.shutdown(wait=True)


async def wait_count(client: Client, path: str, n: int) -> float:
    t0 = time.time()
    while True:
        try:
            got = await client.call("GET", path + "/count")
        except urllib.error.HTTPError as exc:
            if exc.code != 404:  # 404: the monitor has not created it yet
                raise
            got = None
        if got == n:
            return time.time() - t0
        if time.time() - t0 > INGEST_TIMEOUT_S:
            raise AssertionError(f"{path}: count {got} != {n} after ingest timeout")
        await asyncio.sleep(0.5)


# -- phases ----------------------------------------------------------------------


async def ann_phase(
    name, client, db, table, x, queries, kind, params, on_ingested=None
) -> None:
    """Create index `ks.<name>` on `table` (rows already in the DB),
    wait for the CDC scan to land every row, query /ann, check."""
    path = f"/api/v1/indexes/ks/{name}"
    t0 = time.time()
    db.add_index(f"ks.{name}", table, params, kind=kind)
    ingest_s = await wait_count(client, path, len(x))
    if on_ingested is not None:
        on_ingested()
    t1 = time.time()
    res = await client.many(
        "POST",
        path + "/ann",
        [{"embedding": q.tolist(), "limit": K} for q in queries],
    )
    query_s = time.time() - t1
    ids = [r["primary_keys"]["id"] for r in res]
    dists = [np.asarray(r["distances"]) for r in res]
    if any(len(i) != K for i in ids):
        raise AssertionError(f"{name}: a query returned fewer than {K} ids")
    truth = exact_topk(x, queries, K)
    recall = float(
        np.mean([len(set(i) & set(t.tolist())) / K for i, t in zip(ids, truth)])
    )
    ref = cosine_distance(x, queries, ids)
    err = float(max(np.max(np.abs(d - r)) for d, r in zip(dists, ref)))
    ok = recall >= RECALL_BAR[name] and err <= DIST_TOL[name]
    print(
        f"# phase {name}: rows={len(x)} dims={x.shape[1]} kind={kind} "
        f"dtype={params.dtype} ingest_s={ingest_s:.1f} "
        f"queries={len(queries)} query_s={query_s:.2f} "
        f"recall@{K}={recall:.4f} (bar {RECALL_BAR[name]}) "
        f"max_dist_err={err:.2e} (tol {DIST_TOL[name]}) "
        f"wall_s={time.time() - t0:.1f} {'ok' if ok else 'FAIL'}",
        flush=True,
    )
    if not ok:
        raise AssertionError(f"phase {name} out of bounds")
    db.del_index(f"ks.{name}")


async def text_phase(client, seed: int) -> None:
    t0 = time.time()
    docs, queries = text_corpus(N_DOCS, N_TEXT_QUERIES, seed)
    await client.call("PUT", "/api/v1/text-search/docs")
    await client.many(
        "POST",
        "/api/v1/text-search/docs/add",
        [{"id": f"d{j}", "text": " ".join(w)} for j, w in enumerate(docs)],
    )
    ingest_s = time.time() - t0
    t1 = time.time()
    res = await client.many(
        "POST",
        "/api/v1/text-search/docs/search",
        [{"text": " ".join(q), "limit": K} for q in queries],
    )
    query_s = time.time() - t1
    score = bm25_reference(docs)
    worst = 0.0
    for q, got in zip(queries, res):
        s = score(q)
        want = np.sort(s[s > 0])[::-1][:K]
        if len(got) != len(want):
            raise AssertionError(
                f"text: {len(got)} hits for {q}, numpy has {len(want)}"
            )
        have = s[[int(key[1:]) for key in got]]
        worst = max(worst, float(np.max(np.abs(have - want) / want, initial=0.0)))
    ok = worst <= BM25_RTOL
    print(
        f"# phase text: docs={N_DOCS} queries={len(queries)} "
        f"ingest_s={ingest_s:.1f} query_s={query_s:.2f} "
        f"max_rel_score_err={worst:.2e} (tol {BM25_RTOL}) "
        f"wall_s={time.time() - t0:.1f} {'ok' if ok else 'FAIL'}",
        flush=True,
    )
    if not ok:
        raise AssertionError("phase text out of bounds")


def graph_expand_round(x: np.ndarray, queries: np.ndarray, seed: int) -> None:
    """The graph's XLA expand round alone: median device time of one
    round at batch 256, on the same corpus built through SlotIndex."""
    import jax
    import jax.numpy as jnp

    from vector_store_tpu.core import SlotIndex
    from vector_store_tpu.core import distance as dist_mod
    from vector_store_tpu.core import search as search_mod

    idx = SlotIndex(
        IndexParams(dimensions=x.shape[1], dtype="bfloat16"),
        initial_capacity=len(x),
    )
    t0 = time.time()
    idx.add(x)
    build_s = time.time() - t0
    cfg, st = idx.cfg, idx.state
    q = dist_mod.preprocess(jnp.asarray(queries[:256]), cfg.space).astype(
        cfg.compute_dtype
    )
    init = jax.jit(search_mod._init_pool, static_argnums=(2,))
    step = jax.jit(search_mod._expand_round, static_argnums=(2,))
    pool = jax.block_until_ready(init(st, q, cfg))
    jax.block_until_ready(step(st, q, cfg, pool))  # compile
    times = []
    for _ in range(9):
        t = time.perf_counter()
        pool = jax.block_until_ready(step(st, q, cfg, pool))
        times.append(time.perf_counter() - t)
    print(
        f"# graph expand round (XLA, direct SlotIndex build {build_s:.1f}s): "
        f"median {np.median(times) * 1e3:.3f} ms per round at batch 256, "
        f"beam_width={cfg.beam_width} degree={cfg.degree} "
        f"({cfg.search_iters} rounds per search)",
        flush=True,
    )


async def one_card(args) -> None:
    from bench import clustered_corpus, perturbed_queries
    from vector_store_tpu import new_index_factory, run
    from vector_store_tpu.config import Config
    from vector_store_tpu.ingest import MemDb, MonitorIndexes

    cfg = Config()
    server, engine = await run(
        "127.0.0.1:0",
        new_index_factory(
            max_batch=cfg.max_batch, window_s=cfg.batch_window_ms / 1000.0
        ),
    )
    client = Client(f"http://{server.addr}")
    db = MemDb()
    monitor = MonitorIndexes(db, engine)
    monitor.spawn()
    try:
        x = clustered_corpus(N_VEC, D, args.seed)
        queries = perturbed_queries(x, N_QUERIES, args.seed + 1)
        db.add_table("vectors", ("id",), D)
        db.preload("vectors", [primary_key(i) for i in range(len(x))], x)
        await ann_phase(
            "ivf", client, db, "vectors", x, queries, "ivf",
            IndexParams(dimensions=D, space="cosine", dtype="int8"),
        )
        await ann_phase(
            "exact", client, db, "vectors", x, queries, "exact",
            IndexParams(dimensions=D, space="cosine", dtype="float32"),
        )

        g = clustered_corpus(N_GRAPH, D, args.seed + 2)
        gq = perturbed_queries(g, N_QUERIES, args.seed + 3)
        db.add_table("graphvecs", ("id",), D)
        db.preload("graphvecs", [primary_key(i) for i in range(len(g))], g)
        await ann_phase(
            "graph", client, db, "graphvecs", g, gq, "ann",
            IndexParams(dimensions=D, space="cosine", dtype="bfloat16"),
        )
        await text_phase(client, args.seed)
        graph_expand_round(g, gq, args.seed)
    finally:
        await monitor.stop()
        client.close()
        await server.close()
        await engine.close()


def bytes_in_use(dev) -> int:
    return dev.memory_stats()["bytes_in_use"]


async def four_cards(args) -> None:
    import jax

    from bench import clustered_corpus, perturbed_queries
    from vector_store_tpu import new_index_factory, run
    from vector_store_tpu.config import Config
    from vector_store_tpu.ingest import MemDb, MonitorIndexes

    devs = jax.devices()[:4]
    before = [bytes_in_use(d) for d in devs]
    cfg = Config()
    server, engine = await run(
        "127.0.0.1:0",
        new_index_factory(
            max_batch=cfg.max_batch,
            window_s=cfg.batch_window_ms / 1000.0,
            n_devices=4,
        ),
    )
    client = Client(f"http://{server.addr}")
    db = MemDb()
    monitor = MonitorIndexes(db, engine)
    monitor.spawn()
    try:
        n = 4 * N_PER_CARD
        x = clustered_corpus(n, D, args.seed)
        queries = perturbed_queries(x, N_QUERIES, args.seed + 1)
        db.add_table("vectors", ("id",), D)
        db.preload("vectors", [primary_key(i) for i in range(n)], x)

        def check_memory() -> None:
            grown = [bytes_in_use(d) - b for d, b in zip(devs, before)]
            need = N_PER_CARD * D  # int8 rows of one shard
            print(
                "# per-card bytes_in_use growth (GB): "
                + " ".join(f"{g / 1e9:.3f}" for g in grown)
                + f" (each must be >= {need / 1e9:.3f}, one shard's int8 rows)",
                flush=True,
            )
            if min(grown) < need:
                raise AssertionError("a card does not hold its shard")

        await ann_phase(
            "sharded", client, db, "vectors", x, queries, "ivf",
            IndexParams(dimensions=D, space="cosine", dtype="int8"),
            on_ingested=check_memory,
        )
    finally:
        await monitor.stop()
        client.close()
        await server.close()
        await engine.close()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cards", type=int, choices=(1, 4), default=1)
    args = ap.parse_args()

    print(card_line(), flush=True)
    if args.cards == 1:
        run_gpu_tests()

    import jax

    from vector_store_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    devs = jax.devices()
    if devs[0].platform != "gpu" or len(devs) < args.cards:
        raise SystemExit(f"needs {args.cards} GPU(s); JAX found {devs}")
    t0 = time.time()
    asyncio.run(one_card(args) if args.cards == 1 else four_cards(args))
    print(f"# all phases ok in {time.time() - t0:.1f}s", flush=True)
    print(
        json.dumps(
            {
                "ok": True,
                "device": {
                    "platform": devs[0].platform,
                    "kind": devs[0].device_kind,
                    "count": len(devs),
                },
            }
        )
    )


if __name__ == "__main__":
    main()
