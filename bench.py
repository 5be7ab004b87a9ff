#!/usr/bin/env python
"""Headline benchmark — prints ONE JSON line to stdout:
    {"metric": ..., "value": N, "unit": ..., "vs_baseline": N}

Metric: QPS per device at recall@10 >= 0.95 on an N x 768-d cosine
corpus (BASELINE.md north star).  The corpus is a deterministic
clustered synthetic standing in for real embedding distributions
(Cohere/GloVe-like; the benchmark datasets themselves are not fetchable
offline — point VST_BENCH_FVECS at an .fvecs file to bench real data
instead).

Structure:

  1. exact f32 scan: ground truth + the always-eligible scan candidate
  2. IVF int8 probe sweep (+ two-stage int4): headline candidates
  -> the headline JSON is printed HERE, as soon as a recall>=0.95
     number exists (watchdog safety)
  3. best-effort extras under the wall-clock budget: graph rung,
     large-N 8M ivf, serving latency+QPS, config-3 pipeline, text
     search, churn, scan-int8, real-data
  4. EVERY exit path ends with a recap of the key measured lines and
     re-prints the headline JSON as the FINAL line of output
     (emit_final)

Device timings are the median over repeated dispatches, each timed to
`jax.block_until_ready`.

vs_baseline: ratio against the local CPU-HNSW anchor (the usearch-CPU
role; BASELINE.md requires the anchor measured locally on the same
data).  The CPU anchor is cached in bench_baseline.json because the
single-core build takes hours at 1M — delete the file to re-measure.

Env knobs: VST_BENCH_N (corpus size, default 1M), VST_BENCH_Q (queries,
default 2048), VST_BENCH_BUDGET_S (wall budget, default 1050),
VST_BENCH_SKIP_BASELINE=1, VST_BENCH_LITE=1 (headline path only).
"""

from __future__ import annotations

import dataclasses
import gc
import json
import os
import signal
import statistics
import sys
import threading
import time

import numpy as np

N = int(os.environ.get("VST_BENCH_N", "1000000"))  # BASELINE.md north star scale
D = int(os.environ.get("VST_BENCH_D", "768"))
Q = int(os.environ.get("VST_BENCH_Q", "2048"))
K = 10
TARGET_RECALL = 0.95
SEED = 42
LITE = os.environ.get("VST_BENCH_LITE") == "1"
# Default budget chosen so the worst-case self-exit (budget + 60s
# post-headline grace, see _watchdog) stays inside a 1200s driver
# timeout: round 2's bench died at the driver's rc=124 with no headline
# on record, which is the one failure mode this file must never repeat.
BUDGET_S = float(os.environ.get("VST_BENCH_BUDGET_S", "1050"))
T_START = time.time()
BASELINE_CACHE = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "bench_baseline.json"
)

# search configs swept cheapest-first (config 2: the whole curve is timed)
EF_LADDER = (
    dict(ef_search=48, iters=10, beam_width=6),
    dict(ef_search=64, iters=12, beam_width=6),
    dict(ef_search=96, iters=16, beam_width=8),
    dict(ef_search=128, iters=20, beam_width=8),
    dict(ef_search=192, iters=24, beam_width=8),
    dict(ef_search=256, iters=32, beam_width=8),
)
# IVF serving geometry: bucket width ~2x the 170 default (fewer, larger
# contiguous blocks per probe; the k-means build runs on half the
# clusters).  Not yet measured against the default on the GPU.
IVF_RPB = int(os.environ.get("VST_BENCH_IVF_RPB", "340"))
PROBE_LADDER = (2, 4, 8, 16)


RECAP: list[str] = []


def log(msg: str, recap: bool = False) -> None:
    print(f"[{time.time() - T_START:5.0f}s] {msg}", file=sys.stderr, flush=True)
    if recap:
        RECAP.append(msg)


# -- headline safety net ----------------------------------------------------
# Every measured (name, qps, recall) lands in CANDIDATES the moment it
# exists.  A signal handler cannot run while the main thread is blocked
# inside a C call (a wedged device call) — so a WATCHDOG THREAD force-prints the best recall-clearing
# candidate once the budget expires and hard-exits 0.  SIGTERM (what
# `timeout` sends) gets the same treatment for the case where the main
# thread is still responsive.

CANDIDATES: list[tuple[str, float, float]] = []
_HEADLINE_DONE = threading.Event()
_HEADLINE_JSON: str | None = None


def emit_final(headline_only: bool = False) -> None:
    """Re-emit the recap block + the headline JSON as the LAST lines of
    output.  The driver parses the END of combined stdout+stderr (rounds
    2 and 3 recorded parsed=null because a stderr log line landed last),
    so every exit path — normal return, watchdog budget exit, SIGTERM —
    funnels through here, and the very last write is the JSON line."""
    if not headline_only and RECAP:
        print("# ---- recap (key numbers, re-printed for the tail) ----",
              file=sys.stderr)
        for line in RECAP:
            print(line, file=sys.stderr)
    sys.stderr.flush()
    if _HEADLINE_JSON is not None:
        print(_HEADLINE_JSON, flush=True)


def print_headline(vs_baseline: float | None = None) -> None:
    """Print the ONE headline JSON line from the best eligible candidate
    (idempotent; thread-safe via the event)."""
    global _HEADLINE_JSON
    if _HEADLINE_DONE.is_set():
        return
    eligible = [c for c in CANDIDATES if c[2] >= TARGET_RECALL]
    if not eligible:
        if not CANDIDATES:
            return
        # Recall regression: nothing cleared the bar.  The driver still
        # needs its ONE JSON line — emit the best-recall candidate and
        # flag the miss in the metric string rather than exiting silent.
        eligible = [max(CANDIDATES, key=lambda c: (c[2], c[1]))]
        log(
            f"# headline WARNING: no candidate reached recall "
            f"{TARGET_RECALL}; reporting best-recall fallback"
        )
    _HEADLINE_DONE.set()
    name, qps, rec = max(eligible, key=lambda c: c[1])
    vs = vs_baseline if vs_baseline is not None else 0.0
    log(f"# headline[{name}]: qps={qps:.0f} recall={rec:.3f} vs_cpu={vs:.1f}x",
        recap=True)
    bar = f">={TARGET_RECALL}" if rec >= TARGET_RECALL else f"={rec:.3f} BELOW BAR"
    _HEADLINE_JSON = json.dumps(
        {
            "metric": f"QPS/device at recall@10{bar} ({N}x{D}-d cosine)",
            "value": round(qps, 1),
            "unit": "queries/s",
            "vs_baseline": round(vs, 2),
        }
    )
    print(_HEADLINE_JSON, flush=True)


def _watchdog() -> None:
    """Budget enforcement: the driver records rc=124 whenever ITS timeout
    fires (regardless of our SIGTERM handler), so the bench must always
    exit on its own inside the budget.  Pre-headline: if the budget is
    gone and the main thread is wedged in a device call, emit the best
    number we have and exit.  Post-headline: give best-effort extras a
    60s grace past the budget, then exit 0 — the headline is out."""
    while True:
        time.sleep(15)
        over = -remaining()
        if _HEADLINE_DONE.is_set():
            if over > 60:
                log(f"# bench exiting at budget+{over:.0f}s (extras cut short)")
                emit_final()
                sys.stdout.flush()
                os._exit(0)
        elif over > 30 and CANDIDATES:
            print_headline()
            emit_final()
            sys.stdout.flush()
            os._exit(0)
        elif over > 30:
            # budget gone with NOTHING measured: the device never
            # answered.  Exit with a
            # diagnosis instead of hanging into the driver's rc=124.
            log(
                f"# bench ABORT at budget+{over:.0f}s: no measurement "
                "completed — device backend unresponsive"
            )
            sys.stdout.flush()
            sys.stderr.flush()
            os._exit(1)


def _on_term(signum, frame):  # noqa: ANN001 — signal signature
    if not _HEADLINE_DONE.is_set() and CANDIDATES:
        print_headline()
    emit_final(headline_only=True)
    sys.stdout.flush()
    os._exit(0 if _HEADLINE_DONE.is_set() else 124)


def remaining() -> float:
    return BUDGET_S - (time.time() - T_START)


def fits(est_s: float, phase: str, frac: float = 1.0) -> bool:
    """frac < 1 lets a post-headline phase START when most of its
    estimate fits: phases log incrementally, the watchdog's budget+60
    exit re-emits the headline, so an overrun only truncates the phase
    (whole-estimate gating would skip everything near the end)."""
    if remaining() >= est_s * frac:
        return True
    log(f"# skip {phase}: est {est_s:.0f}s > {remaining():.0f}s budget left")
    return False


def clustered_corpus(n: int, d: int, seed: int = SEED) -> np.ndarray:
    """Deterministic clustered corpus [n, d] f32: n/50 gaussian centres,
    each row a centre plus 0.35-sigma noise, generated on the host in
    row chunks.  It stands in for real embedding distributions
    (Cohere/GloVe-like), which cannot be fetched offline."""
    crng = np.random.default_rng([seed, 1])
    n_clusters = max(n // 50, 16)
    centers = crng.standard_normal((n_clusters, d), dtype=np.float32)
    CH = min(n, 1 << 17)
    x = np.empty((n, d), dtype=np.float32)
    for off in range(0, n, CH):
        m = min(CH, n - off)
        blk = x[off : off + m]
        blk[:] = crng.standard_normal((m, d), dtype=np.float32)
        blk *= 0.35
        blk += centers[crng.integers(0, n_clusters, m)]
    return x


def perturbed_queries(
    x: np.ndarray, q: int, seed: int = SEED, noise: float = 0.25
) -> np.ndarray:
    """q in-distribution queries: corpus rows plus gaussian noise.  The
    query rng is separate from the corpus rng, so the selection does not
    depend on how the corpus was made."""
    rng = np.random.default_rng(seed)
    qi = rng.choice(len(x), q, replace=False)
    return x[qi] + noise * rng.standard_normal((q, x.shape[1]), dtype=np.float32)


def make_dataset(n: int, d: int, q: int, seed: int = SEED):
    """Corpus + in-distribution queries (VST_BENCH_FVECS: a real .fvecs
    file instead of the synthetic corpus)."""
    fvecs = os.environ.get("VST_BENCH_FVECS")
    if fvecs:
        from vector_store_tpu.utils.native import read_fvecs

        x = read_fvecs(fvecs, n, d)
        rng = np.random.default_rng(seed)
        qi = rng.choice(len(x), q, replace=False)
        queries = x[qi] + 0.05 * x[qi].std() * rng.standard_normal(
            (q, x.shape[1]), dtype=np.float32
        )
        return x, queries.astype(np.float32)
    t0 = time.time()
    x = clustered_corpus(n, d, seed)
    log(f"# dataset generated in {time.time() - t0:.0f}s ({n}x{d})")
    return x, perturbed_queries(x, q, seed)


def add_with_progress(idx, x: np.ndarray, label: str) -> float:
    """idx.add(x) in slices with a rate line per slice — an ingest that
    degrades (e.g. device-memory pressure) shows up in the log tail
    instead of looking like a silent wedge.  Returns vec/s."""
    n = len(x)
    t0 = time.time()
    step = 1 << 17
    for off in range(0, n, step):
        idx.add(x[off : off + step])
        done = min(off + step, n)
        if done < n:
            log(
                f"#   {label} ingest {done}/{n}: "
                f"{done / (time.time() - t0):.0f} vec/s"
            )
    dt = time.time() - t0
    return n / dt


def recall_of(ids: np.ndarray, exact: np.ndarray) -> float:
    q, k = exact.shape
    return float(
        np.mean(
            [
                len(set(ids[i][:k].tolist()) & set(exact[i].tolist())) / k
                for i in range(q)
            ]
        )
    )


class DeviceTimer:
    """Device QPS of a jitted step: one warm-up dispatch, then the median
    over `reps` dispatches, each timed to `jax.block_until_ready`
    (inputs rotate with r, so consecutive runs differ)."""

    def qps(self, fn, n_queries: int, reps: int = 10) -> float:
        import jax

        jax.block_until_ready(fn(0))
        times = []
        for r in range(reps):
            t0 = time.perf_counter()
            jax.block_until_ready(fn(r))
            times.append(time.perf_counter() - t0)
        return n_queries / statistics.median(times)


def bench_exact_scan(x, queries, timer):
    """Exact scan (f32): ground truth for every later phase, the
    always-eligible headline fallback, and the serving-latency floor."""
    import jax.numpy as jnp

    from vector_store_tpu.core import SlotIndex, bruteforce
    from vector_store_tpu.core import distance as dist_mod
    from vector_store_tpu.types import IndexParams

    n, d = x.shape
    cap = max(1 << 16, 1 << (n - 1).bit_length())
    exact_idx = SlotIndex(
        IndexParams(dimensions=d, space="cosine", capacity=n),
        initial_capacity=cap,
        exact=True,
    )
    rate = add_with_progress(exact_idx, x, "scan")
    log(f"# scan ingest: {rate:.0f} vec/s", recap=True)

    state = exact_idx.state
    qp_f32 = dist_mod.preprocess(jnp.asarray(queries), "cosine").astype(
        exact_idx.cfg.compute_dtype
    )
    _, exact_ids = bruteforce.search(
        qp_f32, state.vectors, state.valid, "cosine", K, approx=False
    )
    exact = np.asarray(exact_ids)

    qp_vars = [jnp.roll(qp_f32, r, axis=0) for r in range(12)]
    scan_qps = timer.qps(
        lambda r: bruteforce.search(
            qp_vars[r % 12], state.vectors, state.valid, "cosine", K
        ),
        len(queries),
    )
    out = bruteforce.search(qp_vars[0], state.vectors, state.valid, "cosine", K)
    scan_rec = recall_of(np.asarray(out[1]), exact)
    log(f"# scan: recall@10={scan_rec:.3f} qps={scan_qps:.0f}", recap=True)
    if scan_rec >= TARGET_RECALL:
        # the watchdog can now emit a headline even if a later phase wedges
        CANDIDATES.append(("exact-scan", scan_qps, scan_rec))

    # device-latency floor: single batch-8 dispatch, host roundtrip incl
    try:
        q8 = [jnp.roll(qp_f32[:8], r, axis=0) for r in range(30)]
        lat = []
        float(
            np.asarray(
                bruteforce.search(
                    q8[0], state.vectors, state.valid, "cosine", K
                )[0][0, 0]
            )
        )
        for r in range(30):
            t0 = time.time()
            o = bruteforce.search(q8[r], state.vectors, state.valid, "cosine", K)
            float(np.asarray(o[0][0, 0]))
            lat.append(time.time() - t0)
        lat.sort()
        log(
            f"# scan latency (batch=8, host-roundtrip incl): "
            f"p50={lat[14] * 1000:.1f}ms p99={lat[-1] * 1000:.1f}ms"
        , recap=True)
    except Exception as exc:  # noqa: BLE001 — latency probe is best-effort
        log(f"# latency probe failed: {exc}")

    cand = ("exact-scan", scan_qps, scan_rec) if scan_rec >= TARGET_RECALL else None
    del out
    return exact, exact_idx, cand


def bench_ivf(x, queries, exact, timer):
    """IVF int8 bucketed backend — the headline candidate (config 2/3
    curve).  Returns (best_candidate | None, ivf) with the index left
    alive for the churn phase."""
    import jax.numpy as jnp

    from vector_store_tpu.core.ivf import (
        IvfIndex,
        search_clustered,
        search_clustered_kernel,
    )
    from vector_store_tpu.types import IndexParams

    n, d = x.shape
    ivf = IvfIndex(
        IndexParams(dimensions=d, space="cosine", dtype="int8"),
        initial_capacity=n,
        rows_per_bucket=IVF_RPB,
    )
    # single add(): slicing would change the recluster cadence (one
    # recluster at the end vs one per slice + growth doublings); the
    # staging path ships bf16 and syncs its own queue every ~100MB
    t0 = time.time()
    ivf.add(x)
    log(
        f"# ivf ingest: {n / (time.time() - t0):.0f} vec/s "
        f"(clusters={ivf.n_clusters}, bucket={ivf.state.bucket})"
    , recap=True)
    best_ivf = None
    qdev = [jnp.asarray(np.roll(queries, r, axis=0)) for r in range(12)]
    if not ivf._clustered:
        # Below cluster_min the bank never reclusters: centroids are
        # meaningless and IvfIndex.search serves the staging flat scan —
        # time THAT path (probe sweep / two-stage need clusters;
        # small-N smoke runs land here, never the 1M driver run).
        from vector_store_tpu.core.ivf import search_flat

        st = ivf.state
        d_, i_ = ivf.search(queries, K)
        rec = recall_of(i_, exact)
        qps = timer.qps(
            lambda r: search_flat(st, qdev[r % 12], "cosine", K),
            len(queries),
            reps=6,
        )
        log(
            f"#   ivf staging flat scan (bank < cluster_min): "
            f"recall@10={rec:.3f} qps={qps:.0f}"
        , recap=True)
        best_ivf = ("ivf-flat", qps, rec)
        if rec >= TARGET_RECALL:
            CANDIDATES.append(best_ivf)
        return (best_ivf if rec >= TARGET_RECALL else None), ivf, ()
    log("# config-2 curve (ivf probe sweep, cheapest-first):")
    for probes in PROBE_LADDER:
        # Reaching any rung past the first means the bar is still
        # uncleared (the loop breaks on the first clearing rung).
        if probes != PROBE_LADDER[0] and remaining() < 150:
            log("# ivf sweep truncated (budget) — headline falls back to scan")
            break
        d_, i_ = ivf.search(queries, K, probes=probes)
        rec = recall_of(i_, exact)
        st = ivf.state
        scan = search_clustered_kernel if ivf._kernel else search_clustered
        qps = timer.qps(
            lambda r: scan(st, qdev[r % 12], "cosine", K, probes),
            len(queries),
            reps=6,
        )
        line = f"#   ivf probes={probes}: recall@10={rec:.3f} qps={qps:.0f}"
        name = f"ivf-p{probes}"
        log(line, recap=True)
        if rec >= TARGET_RECALL:
            CANDIDATES.append((name, qps, rec))
        if best_ivf is None or (
            rec >= TARGET_RECALL
            and (best_ivf[2] < TARGET_RECALL or qps > best_ivf[1])
        ):
            best_ivf = (name, qps, rec)
        if rec >= TARGET_RECALL:
            # A clearing candidate is now in CANDIDATES (watchdog-safe),
            # so spend budget on the two-stage int4 attempt at the SAME
            # rung: half the scanned bytes, recall restored by the int8
            # rescore (core/ivf.py::search_two_stage).
            cand2 = bench_ivf_two_stage(ivf, queries, exact, timer, qdev, probes)
            if cand2 is not None and cand2[1] > best_ivf[1]:
                best_ivf = cand2
            # recall rises with probes while qps falls, so the FIRST rung
            # clearing the bar is also the fastest clearing rung.  The
            # remaining rungs run post-headline if the budget allows.
            break
    log(f"# ivf best: {best_ivf[0]} recall@10={best_ivf[2]:.3f} qps={best_ivf[1]:.0f}", recap=True)
    rest = tuple(p for p in PROBE_LADDER if p > probes)
    return (best_ivf if best_ivf[2] >= TARGET_RECALL else None), ivf, rest


def bench_ivf_two_stage(ivf, queries, exact, timer, qdev, probes: int):
    """Two-stage (int4 coarse + int8 rescore) attempt at the clearing
    rung.  Budget-guarded; returns a (name, qps, recall) candidate or
    None.  Leaves ivf.coarse enabled iff the two-stage cleared the bar
    (so the churn phase exercises the coarse-cache mutation protocol)."""
    from vector_store_tpu.core.ivf import search_two_stage

    if ivf.dims % 2 or remaining() < 120:
        if ivf.dims % 2 == 0:
            log("# skip ivf two-stage: budget")
        return None
    if not ivf._clustered:
        # two-stage routes by centroids; an unclustered (staging) bank
        # has none — scanning it through search_two_stage returns
        # near-random survivors (smoke-run footgun, 2026-08-18)
        log("# skip ivf two-stage: bank below cluster_min")
        return None
    try:
        ivf.coarse = True
        st = ivf.state
        coarse = ivf._refresh_coarse_locked()
        cand_n = min(
            max(ivf.rescore * K, 64), min(probes, ivf.n_clusters) * st.bucket
        )
        half = qdev[0].shape[0] // 2

        def run(r):
            a = search_two_stage(
                st, coarse, qdev[r % 12][:half], "cosine", K, probes, cand_n
            )
            b = search_two_stage(
                st, coarse, qdev[r % 12][half:], "cosine", K, probes, cand_n
            )
            return a[0], b[0], a[1], b[1]

        out_a = run(0)
        ids = np.concatenate([np.asarray(out_a[2]), np.asarray(out_a[3])])
        rec2 = recall_of(ids, exact)
        qps2 = timer.qps(
            lambda r: run(r)[:2], qdev[0].shape[0], reps=6
        )
        name = f"ivf-4bit-p{probes}"
        log(
            f"#   ivf two-stage probes={probes} cand={cand_n}: "
            f"recall@10={rec2:.3f} qps={qps2:.0f}"
        , recap=True)
        if rec2 >= TARGET_RECALL:
            CANDIDATES.append((name, qps2, rec2))
            return (name, qps2, rec2)
        ivf.coarse = False
        return None
    except Exception as exc:  # noqa: BLE001 — headline candidate exists
        log(f"# ivf two-stage failed: {exc!r}")
        ivf.coarse = False
        return None


def bench_churn(ivf, x: np.ndarray, exact_probes: int) -> None:
    """Config 4 — recall under churn: delete 30%, reinsert fresh rows,
    measure recall against an exact scan of the MUTATED bank, compact
    (incremental by default — full Lloyd only on doubling), measure
    again.  The compact is timed and reported."""
    rng = np.random.default_rng(7)
    n = len(x)
    n_kill = int(0.3 * n)
    kill = rng.choice(n, n_kill, replace=False).astype(np.int64)
    t0 = time.time()
    ivf.remove(kill)
    fresh = x[kill] + 0.1 * rng.standard_normal(
        (n_kill, x.shape[1]), dtype=np.float32
    )
    new_ids = ivf.add(fresh)
    churn_s = time.time() - t0
    qi = rng.choice(n_kill, 512, replace=False)
    probes_q = fresh[qi] + 0.05 * rng.standard_normal(
        (512, x.shape[1]), dtype=np.float32
    )

    _, gt = ivf.exact_search(probes_q, K)
    _, got = ivf.search(probes_q, K, probes=exact_probes)
    rec = recall_of(got, gt)
    t0 = time.time()
    ivf.compact()  # incremental: spill-dirty clusters only
    compact_s = time.time() - t0
    _, gt2 = ivf.exact_search(probes_q, K)
    post = {}
    for p in (exact_probes, 2 * exact_probes):
        _, got2 = ivf.search(probes_q, K, probes=p)
        post[p] = recall_of(got2, gt2)
    hit = float(np.mean(got2[:, 0] == new_ids[qi]))
    post_s = " ".join(f"p{p}={r:.3f}" for p, r in post.items())
    log(
        f"# config-4 churn (30% delete+reinsert @ {n}): recall@10={rec:.3f} "
        f"post-compact[{post_s}] top1-self={hit:.3f} "
        f"churn={churn_s:.0f}s compact={compact_s:.1f}s"
    , recap=True)


def bench_serving_latency() -> None:
    """p50/p99 through the REAL serving path:
    HTTP → engine → index actor → MicroBatcher → device, for both the
    graph and IVF backends, at concurrency 1/8/64.  Reference seam:
    httproutes.rs:132-150."""
    import asyncio

    n_serve = int(os.environ.get("VST_BENCH_SERVE_N", "50000"))
    # ivf is the headline serving tier; the graph ('ann') backend doubles
    # the phase cost —
    # opt back in with VST_BENCH_SERVE_KINDS=ann,ivf
    kinds = tuple(
        os.environ.get("VST_BENCH_SERVE_KINDS", "ivf").split(",")
    )

    async def run() -> None:
        from aiohttp.test_utils import TestClient, TestServer

        from vector_store_tpu import new_index_factory
        from vector_store_tpu.api.routes import build_app
        from vector_store_tpu.engine.engine import new_engine

        rng = np.random.default_rng(3)
        x = rng.standard_normal((n_serve, D), dtype=np.float32)
        centers = x[:64]
        x = centers[rng.integers(0, 64, n_serve)] + 0.35 * x

        engine = await new_engine(new_index_factory())
        app = build_app(engine)
        c = TestClient(TestServer(app))
        await c.start_server()
        try:
            for kind in kinds:
                r = await c.put(
                    f"/api/v1/indexes/bench/{kind}",
                    json={
                        "dimensions": D,
                        "space": "cosine",
                        "key_columns": ["id"],
                        "kind": kind,
                    },
                )
                assert r.status == 200, await r.text()
                # a bare next() here raised "coroutine raised
                # StopIteration" when a prior
                # phase's OOM made the engine log-and-drop the index
                # creation — fail with the actual registry contents
                ids = [
                    i
                    for i in await engine.get_index_ids()
                    if str(i).endswith(kind)
                ]
                if not ids:
                    raise RuntimeError(
                        f"serve[{kind}]: index creation was dropped "
                        f"(registry={await engine.get_index_ids()!r})"
                    )
                handle = await engine.get_index(ids[0])
                t0 = time.time()
                for off in range(0, n_serve, 4096):
                    await handle.add_or_replace_batch(
                        [
                            ((i,), x[i])
                            for i in range(off, min(off + 4096, n_serve))
                        ]
                    )
                while await handle.count() < n_serve:
                    await asyncio.sleep(0.05)
                log(
                    f"# serve[{kind}] ingest via actor: "
                    f"{n_serve / (time.time() - t0):.0f} vec/s"
                , recap=True)

                qs = (
                    x[rng.integers(0, n_serve, 512)]
                    + 0.1 * rng.standard_normal((512, D), dtype=np.float32)
                ).tolist()

                async def one(i: int) -> float:
                    t0 = time.time()
                    r = await c.post(
                        f"/api/v1/indexes/bench/{kind}/ann",
                        json={"embedding": qs[i % 512], "limit": K},
                    )
                    assert r.status == 200, await r.text()
                    await r.json()
                    return time.time() - t0

                for conc in (1, 8, 64):
                    # warm the batcher's shape buckets first (twice —
                    # coalescing makes the first round's bucket set
                    # nondeterministic, and a compile inside the timed
                    # region would dominate the p99)
                    await asyncio.gather(*(one(i) for i in range(conc)))
                    await asyncio.gather(*(one(i) for i in range(conc)))
                    lats: list[float] = []
                    for rep in range(max(30 // max(conc // 8, 1), 8)):
                        lats.extend(
                            await asyncio.gather(
                                *(one(rep * conc + i) for i in range(conc))
                            )
                        )
                    lats.sort()
                    p50 = lats[len(lats) // 2] * 1000
                    p99 = lats[min(len(lats) - 1, int(len(lats) * 0.99))] * 1000
                    log(
                        f"# serve[{kind}] http p50/p99 @conc={conc}: "
                        f"{p50:.1f}/{p99:.1f} ms"
                    , recap=True)

                # -- sustained throughput: free-
                # running closed-loop workers, pre-encoded bodies (a
                # load generator would pre-encode too).  The wave-
                # synchronized latency loop above under-forms batches;
                # free-running workers let the MicroBatcher's pipeline
                # depth keep several device batches in flight.
                import json as _json

                bodies = [
                    _json.dumps({"embedding": q, "limit": K}).encode()
                    for q in qs[:256]
                ]
                hdr = {"Content-Type": "application/json"}
                for conc in (64, 256):
                    if remaining() < 60:
                        log("# serve qps phase truncated (budget)", recap=True)
                        break
                    stop_at = time.time() + 8.0
                    done = 0

                    async def worker(w: int) -> None:
                        nonlocal done
                        j = w * 131
                        while time.time() < stop_at:
                            r = await c.post(
                                f"/api/v1/indexes/bench/{kind}/ann",
                                data=bodies[j % 256],
                                headers=hdr,
                            )
                            assert r.status == 200, await r.text()
                            await r.read()
                            done += 1
                            j += 1

                    # warm this concurrency's bucket shapes
                    await asyncio.gather(*(one(i) for i in range(conc)))
                    t0 = time.time()
                    await asyncio.gather(*(worker(w) for w in range(conc)))
                    qps = done / (time.time() - t0)
                    log(
                        f"# serve[{kind}] http qps @conc={conc}: {qps:.0f}"
                        " (free-running, in-process client)",
                        recap=True,
                    )
        finally:
            await c.close()
            await engine.close()

    asyncio.run(run())


def bench_graph(x, queries, exact, timer) -> None:
    """Graph rungs (config 2) on a capped build (VST_BENCH_GRAPH_N,
    default 2^17): ef=64 first, then ef=96/128 for the crossover table
    as the budget allows."""
    import jax
    import jax.numpy as jnp

    from vector_store_tpu.core import SlotIndex, bruteforce
    from vector_store_tpu.core import distance as dist_mod
    from vector_store_tpu.core import search as search_mod
    from vector_store_tpu.types import IndexParams

    n, d = x.shape
    n_graph = min(n, int(os.environ.get("VST_BENCH_GRAPH_N", str(1 << 17))))
    if n_graph < n:
        # Capped build: generate a SELF-CONSISTENT corpus of the capped
        # size (cluster count scaled to n_graph) instead of slicing the
        # 1M corpus: the 1M corpus has n/50 = 20k centers, so a 131k
        # prefix holds ~6.5 rows per center and ~26% of every true
        # top-10 are near-orthogonal random rows that NO graph traversal
        # can navigate to (scripts/diag_graph_recall.py).  A capped rung
        # must bench a corpus a 131k deployment would actually hold.
        x, queries = make_dataset(n_graph, d, len(queries), seed=SEED)
    cap = max(1 << 16, 1 << (n_graph - 1).bit_length())
    idx = SlotIndex(
        IndexParams(dimensions=d, space="cosine", capacity=n_graph),
        initial_capacity=cap,
        insert_block=1024,
    )
    t0 = time.time()
    idx.add(x[:n_graph])
    rate = n_graph / (time.time() - t0)
    log(f"# graph ingest: {rate:.0f} vec/s over {n_graph} rows", recap=True)

    qdev_vars = [jnp.roll(jnp.asarray(queries), r, axis=0) for r in range(12)]
    if n_graph < n:
        # capped build: the full-dataset oracle doesn't apply — one
        # exact scan over the graph's own bank keeps the rung recalls
        # real (graph slots are insertion-ordered, so ids align)
        qp = dist_mod.preprocess(qdev_vars[0], "cosine").astype(
            idx.cfg.compute_dtype
        )
        _, oracle_ids = bruteforce.search(
            qp, idx.state.vectors, idx.state.valid, "cosine", K, approx=False
        )
        exact = np.asarray(oracle_ids)

    def rung(knobs):
        cfg = dataclasses.replace(idx.cfg, **knobs)
        d_, i_ = search_mod.search(idx.state, qdev_vars[0], cfg, K)
        jax.block_until_ready((d_, i_))
        rec = recall_of(np.asarray(i_), exact)
        qps = timer.qps(
            lambda r: search_mod.search(idx.state, qdev_vars[r % 12], cfg, K),
            len(queries),
            reps=6,
        )
        log(
            f"#   graph ef={cfg.ef_search} @ N={n_graph}: "
            f"recall@10={rec:.3f} qps={qps:.0f}",
            recap=True,
        )
        return (f"graph-ef{cfg.ef_search}", qps, rec, cfg)

    rung(EF_LADDER[1])  # ef=64
    # optional extra rungs for the crossover table
    for knobs in (EF_LADDER[2], EF_LADDER[3]):
        if remaining() < 90:
            break
        rung(knobs)
    del idx
    gc.collect()


def bench_large_n(x, queries, timer, ivf_box=None) -> None:
    """One >1M point: 8M × 768 int8 IVF on one device — ~6.1GB of live
    rows in a ~9.2GB reserved bank, the N where the IVF tier's
    flat-QPS-in-N argument actually bites (BASELINE configs 4-5 are
    10M-1B).

    Build: the reserve_rows bulk-load path — ONE recluster at 1M live
    rows, k/bucket sized for the final 8M, permuted on-device while the
    staging bank is still ~1.2GB (one recluster instead of one per
    doubling).

    Corpus: generated ON DEVICE, same generative model as make_dataset
    (n/50 gaussian centers, rows = center + 0.35·noise), fed to
    idx.add() as device-resident blocks, so the 24.6GB f32 corpus never
    crosses the host link.  The host ingest path itself is measured at 1M by the config-3 and
    serving phases — this phase's job is the 8M QPS/recall point.
    Queries: a 2048-row readback slice + host noise (same query model).
    Recall is measured against an EXACT full-bank scan oracle over the
    quantized bank itself, so corpus construction cannot flatter it.
    """
    import jax
    import jax.numpy as jnp

    from vector_store_tpu.core import distance as dist_mod
    from vector_store_tpu.core.ivf import (
        IvfIndex,
        search_clustered,
        search_clustered_kernel,
    )
    from vector_store_tpu.types import IndexParams

    if ivf_box:
        # release the live 1M index before the 8.6GB large-N bank and
        # its recluster/oracle transients are allocated
        ivf_box.clear()
        gc.collect()
    n, d = x.shape
    n8 = int(os.environ.get("VST_BENCH_LARGE_N", str(8 * n)))
    idx = IvfIndex(
        IndexParams(dimensions=d, space="cosine", dtype="int8", capacity=n8),
        cluster_min=n,  # one recluster, at 1M live rows
        reserve_rows=n8,  # k/bucket sized for the final count
        probes=4,
    )
    rng = np.random.default_rng(77)
    t0 = time.time()
    queries = None
    try:
        # --- device-side generator (make_dataset's model, jax PRNG) ----
        n_centers = max(n8 // 50, 16)
        key = jax.random.key(77)
        centers_d = jax.random.normal(
            jax.random.fold_in(key, 0), (n_centers, d), dtype=jnp.float32
        )  # ~491MB at 8M — dropped before the oracle/rung phase

        CH = 8192  # == add()'s chunk bound: one compiled variant

        @jax.jit
        def gen_chunk(centers, k):
            a = jax.random.randint(
                jax.random.fold_in(k, 1), (CH,), 0, centers.shape[0]
            )
            noise = jax.random.normal(
                jax.random.fold_in(k, 2), (CH, d), dtype=jnp.float32
            )
            return centers[a] + 0.35 * noise

        done = 0
        for ci in range(-(-n8 // CH)):
            blk = gen_chunk(centers_d, jax.random.fold_in(key, ci + 1))
            if done + CH > n8:
                blk = blk[: n8 - done]
            idx.add(blk)
            if queries is None:
                # query model = corpus row + 0.25·noise (make_dataset);
                # one small readback slice seeds it
                qn0 = min(len(queries_host := np.asarray(blk[:Q])), Q)
                queries = (
                    queries_host[:qn0]
                    + 0.25 * rng.standard_normal((qn0, d), dtype=np.float32)
                ).astype(np.float32)
            done += len(blk)
            if ci % 16 == 15:
                # staging-phase chunks never fetch (no assign readback
                # before the first recluster) — bound the dispatch queue
                jax.block_until_ready(idx.state.valid)
            if done % (1 << 20) == 0:
                log(
                    f"#   large-N ingest {done}/{n8}: "
                    f"{done / (time.time() - t0):.0f} vec/s (on-device gen)"
                )
            if done < n8 and remaining() < 150:
                log("# large-N ingest cut at budget (rungs still run)")
                break
        del centers_d, blk
        n_live = idx.count()
        st = idx.state
        log(
            f"# ivf @ N={n_live}: ingest {n_live / (time.time() - t0):.0f} vec/s "
            f"(clusters={st.n_clusters}, bucket={st.bucket}, "
            f"bank={st.vectors.size / (1 << 30):.1f}GB int8)",
            recap=True,
        )

        # ---- exact oracle: chunked full scan over the quantized bank ------
        KSTEP = 512  # [KSTEP*B, D] f32 cast transient ≈ 0.4GB at B=256

        @jax.jit
        def _oracle_slice(vecs, scls, valid, rowid, qp):
            # f32 math: a bf16 oracle scrambles near-ties (intra-cluster
            # rank gaps ~1e-3 vs bf16's ~4e-3 resolution) and reads as a
            # FLAT ~0.84 recall across every probe count
            rows = vecs.astype(jnp.float32) * scls[..., None]
            sim = jax.lax.dot_general(
                qp.astype(jnp.float32),
                rows.reshape(-1, rows.shape[-1]),
                dimension_numbers=(((1,), (1,)), ((), ())),
                preferred_element_type=jnp.float32,
            )  # [qn, kk*B]
            sim = jnp.where(valid.reshape(-1)[None, :], sim, -jnp.inf)
            val, pos = jax.lax.top_k(sim, K)
            return val, jnp.take(rowid.reshape(-1), pos)

        qn = len(queries)
        qp_all = dist_mod.preprocess(jnp.asarray(queries), "cosine")
        K_total = st.n_clusters
        QCH = 512  # bounds the per-slice [q, KSTEP*B] f32 sim at ~0.5GB
        exact8 = np.empty((qn, K), dtype=np.int64)
        for q0 in range(0, qn, QCH):
            qp = qp_all[q0 : q0 + QCH]
            parts = []
            for pi, k0 in enumerate(range(0, K_total, KSTEP)):
                k1 = min(k0 + KSTEP, K_total)
                parts.append(
                    _oracle_slice(
                        st.vectors[k0:k1],
                        st.scales[k0:k1],
                        st.valid[k0:k1],
                        st.rowid[k0:k1],
                        qp,
                    )
                )
                if (pi + 1) % 8 == 0:
                    # sync the dispatch queue: each slice holds a ~0.4GB
                    # f32 cast transient
                    jax.block_until_ready(parts[-1][0])
            vals, rids = jax.device_get(
                (
                    jnp.concatenate([p[0] for p in parts], axis=1),
                    jnp.concatenate([p[1] for p in parts], axis=1),
                )
            )
            best = np.argsort(-vals, axis=1)[:, :K]
            exact8[q0 : q0 + QCH] = np.take_along_axis(rids, best, axis=1)
            del parts, vals, rids
        log(f"# large-N oracle: exact int8 full-bank scan over {qn} queries")

        # ---- probe rungs, first clearing rung wins ----------------------
        qdev = [jnp.asarray(np.roll(queries, r, axis=0)) for r in range(12)]
        scan = search_clustered_kernel if idx._kernel else search_clustered
        best8 = None
        measured_p = []
        rung_qps = {}
        for probes in (2, 4, 8):
            # no early break: p=8 is also the two-stage A/B geometry below,
            # and the whole 2/4/8 curve is the flat-QPS-in-N evidence
            if measured_p and remaining() < 90:
                log("# large-N rungs truncated (budget)")
                break
            d_, i_ = idx.search(queries, K, probes=probes)
            rec = recall_of(i_, exact8)
            qps = timer.qps(
                lambda r: scan(st, qdev[r % 12], "cosine", K, probes),
                qn,
                reps=6,
            )
            line = f"#   ivf @ N={n_live} probes={probes}: recall@10={rec:.3f} qps={qps:.0f}"
            name = f"ivf8M-p{probes}"
            log(line, recap=True)
            measured_p.append(probes)
            rung_qps[probes] = qps
            if best8 is None or (rec >= TARGET_RECALL > best8[2]) or (
                rec >= TARGET_RECALL and qps > best8[1]
            ):
                best8 = (name, qps, rec)
        if best8 is not None:
            log(
                f"# large-N best: {best8[0]} recall@10={best8[2]:.3f} "
                f"qps={best8[1]:.0f}",
                recap=True,
            )

        # ---- two-stage A/B at the geometry its byte model favors ----------
        # At 8M the scan streams ~8x the bytes of the 1M headline, so
        # halving streamed bytes should matter here if anywhere.
        if measured_p and remaining() >= 120:
            probes = measured_p[-1]  # largest measured rung (p=8 normally)
            cand2 = bench_ivf_two_stage(idx, queries, exact8, timer, qdev, probes)
            if cand2 is not None:
                # compare against the SAME-probes int8 rung (bytes-per-row
                # is the variable under test, not the probe budget)
                ref = rung_qps.get(probes, best8[1] if best8 else 0.0)
                verdict = "WINS" if cand2[1] > ref else "loses"
                log(
                    f"# large-N two-stage vs int8 @ p={probes}: "
                    f"{cand2[1]:.0f} vs {ref:.0f} qps ({verdict})",
                    recap=True,
                )

    finally:
        # free the multi-GB bank even when a rung OOMs.  st/qdev/qp_all
        # alias bank/device arrays, so null every reference (including
        # the generator's 491MB centers and any in-flight oracle parts).
        idx = st = qdev = qp_all = exact8 = None  # noqa: F841
        centers_d = blk = parts = queries = None  # noqa: F841
        gc.collect()


def bench_scan_int8(x, queries, exact, timer) -> None:
    """Exact scan over int8 storage (quantized memory parity point)."""
    import jax.numpy as jnp

    from vector_store_tpu.core import SlotIndex, bruteforce
    from vector_store_tpu.core import distance as dist_mod
    from vector_store_tpu.types import IndexParams

    n, d = x.shape
    cap = max(1 << 16, 1 << (n - 1).bit_length())
    i8_idx = SlotIndex(
        IndexParams(dimensions=d, space="cosine", capacity=n, dtype="int8"),
        initial_capacity=cap,
        exact=True,
    )
    rate = add_with_progress(i8_idx, x, "scan-int8")
    log(f"# scan-int8 ingest: {rate:.0f} vec/s", recap=True)
    s8 = i8_idx.state
    qp = dist_mod.preprocess(jnp.asarray(queries), "cosine").astype(
        i8_idx.cfg.compute_dtype
    )
    qp_vars = [jnp.roll(qp, r, axis=0) for r in range(12)]
    i8_qps = timer.qps(
        lambda r: bruteforce.search(
            qp_vars[r % 12], s8.vectors, s8.valid, "cosine", K, scales=s8.scales
        ),
        len(queries),
    )
    o8 = bruteforce.search(
        qp_vars[0], s8.vectors, s8.valid, "cosine", K, scales=s8.scales
    )
    i8_rec = recall_of(np.asarray(o8[1]), exact)
    log(f"# scan-int8: recall@10={i8_rec:.3f} qps={i8_qps:.0f}", recap=True)
    del i8_idx, s8, o8
    gc.collect()


def bench_real_data(timer) -> None:
    """BASELINE configs 1-2 ask for recall on real embedding geometry;
    with zero egress no public set is fetchable, so the checked-in
    sample (bench_data/text10k.fvecs — char-trigram TF-IDF of real text
    on disk, random-projected to 128-d; scripts/make_fvecs_sample.py)
    provides anisotropic, naturally-clustered non-synthetic data for at
    least one on-record recall point."""
    import jax.numpy as jnp

    from vector_store_tpu.core import SlotIndex, bruteforce
    from vector_store_tpu.core import distance as dist_mod
    from vector_store_tpu.types import IndexParams
    from vector_store_tpu.utils.native import read_fvecs

    path = os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "bench_data", "text10k.fvecs"
    )
    x = read_fvecs(path, 10_000, 128)
    rng = np.random.default_rng(9)
    qi = rng.choice(len(x), 256, replace=False)
    queries = (
        x[qi] + 0.05 * rng.standard_normal((256, 128), dtype=np.float32)
    ).astype(np.float32)

    n, d = x.shape
    idx = SlotIndex(
        IndexParams(dimensions=d, space="cosine", capacity=n),
        initial_capacity=1 << 14,
    )
    idx.add(x)
    qp = dist_mod.preprocess(jnp.asarray(queries), "cosine").astype(
        idx.cfg.compute_dtype
    )
    st = idx.state
    _, gt = bruteforce.search(qp, st.vectors, st.valid, "cosine", K, approx=False)
    gt = np.asarray(gt)

    from vector_store_tpu.core import search as search_mod

    qdev = [jnp.asarray(np.roll(queries, r, axis=0)) for r in range(12)]
    d_, i_ = search_mod.search(st, qdev[0], idx.cfg, K)
    rec = recall_of(np.asarray(i_), gt)
    qps = timer.qps(
        lambda r: search_mod.search(st, qdev[r % 12], idx.cfg, K),
        len(queries),
        reps=6,
    )
    log(
        f"# real-data text10k.fvecs (graph, ef={idx.cfg.ef_search}): "
        f"recall@10={rec:.3f} qps={qps:.0f}"
    , recap=True)
    del idx
    gc.collect()


def bench_text(timer) -> None:
    """Text-search throughput — the reference's LIVE system is
    simple_query_string over OpenSearch (opensearch.rs:181-194); here
    the device BM25 scan serves it.  Synthetic zipf corpus; reports doc
    ingest rate, device-scan QPS, and end-to-end search() QPS (host
    parse + device + fetch)."""
    import jax.numpy as jnp

    from vector_store_tpu.text.bm25 import BM25Index, _score_topk

    n_docs = int(os.environ.get("VST_BENCH_TEXT_N", "100000"))
    rng = np.random.default_rng(11)
    v = 20_000
    p = 1.0 / np.arange(1, v + 1)
    p /= p.sum()
    idx = BM25Index(initial_capacity=n_docs)
    t0 = time.time()
    doc_terms = rng.choice(v, size=(n_docs, 24), p=p)
    for row in doc_terms:
        idx.add(" ".join(f"w{t}" for t in row))
    rate = n_docs / (time.time() - t0)
    log(f"# text ingest: {rate:.0f} docs/s ({n_docs} docs, vocab {v})", recap=True)

    q_batch = [
        " ".join(f"w{t}" for t in rng.choice(v, size=3, p=p))
        for _ in range(32)
    ]
    hits = idx.search(q_batch, K)  # compile + device upload
    assert any(hits), "text bench: no hits on zipf corpus"

    # device-only scan QPS through the jitted kernel (12 rotated inputs)
    arrays = idx._device_arrays()
    avg = np.float32(max(idx._total_len / max(idx._size, 1), 1.0))
    qt = np.zeros((12, 32, 16), dtype=np.int32)
    qi = np.zeros((12, 32, 16), dtype=np.float32)
    for r in range(12):
        for j in range(32):
            terms = rng.choice(v, size=3, p=p)
            qt[r, j, :3] = [idx._vocab.get(f"w{t}", 0) for t in terms]
            qi[r, j, :3] = [idx._idf(t) for t in qt[r, j, :3]]
    qz = np.zeros((32, 8), dtype=np.int32)
    qtd = [jnp.asarray(qt[r]) for r in range(12)]
    qid = [jnp.asarray(qi[r]) for r in range(12)]
    qzd = jnp.asarray(qz)
    scan_qps = timer.qps(
        lambda r: _score_topk(
            *arrays, qtd[r % 12], qid[r % 12], qzd, qzd,
            jnp.float32(avg), K,
        ),
        32,
        reps=6,
    )

    # end-to-end search(): host parse + idf + device + fetch + rank
    t0 = time.time()
    reps = 20
    for r in range(reps):
        idx.search(q_batch, K)
    e2e_qps = 32 * reps / (time.time() - t0)
    log(
        f"# text search @ {n_docs} docs: device-scan {scan_qps:.0f} qps, "
        f"end-to-end {e2e_qps:.0f} qps (batch 32, k={K})"
    , recap=True)
    del idx
    gc.collect()


def bench_ingest_pipeline() -> None:
    """Config 3 — streaming inserts through the REAL ingestion path:
    MemDb snapshot scan → EmbeddingStream → monitor_items LWW bridge →
    index actor (coalesced batched device inserts), i8-quantized 768-d.
    This is the rate a Scylla-CDC deployment would see, not a direct
    index.add()."""
    import asyncio

    n_ing = int(os.environ.get("VST_BENCH_INGEST_N", "250000"))
    d = D

    async def run() -> tuple[float, int]:
        from vector_store_tpu.engine import AnnIndexFactory
        from vector_store_tpu.ingest import monitor_items
        from vector_store_tpu.ingest.memdb import MemDb
        from vector_store_tpu.types import IndexParams

        rng = np.random.default_rng(11)
        db = MemDb()
        db.add_table("vectors", ("id",), d)
        # bulk preload (direct table load, one schema bump); the scan
        # phase then streams it through the monitor bridge exactly like
        # a Scylla initial full scan
        db.preload(
            "vectors",
            [(i,) for i in range(n_ing)],
            rng.standard_normal((n_ing, d), dtype=np.float32),
        )
        meta = db.add_index(
            "ks.stream",
            "vectors",
            IndexParams(dimensions=d, space="cosine", dtype="int8"),
        )

        # reserve_rows: the initial-scan bulk load declares its size up
        # front (a Scylla deployment knows the table's row count before
        # scanning) — ONE recluster sized for the final count instead of
        # one per doubling, and one compiled (K, B) shape
        factory = AnnIndexFactory(backend="ivf", reserve_rows=n_ing)
        handle = factory.create_index(meta.index_id, meta)
        t0 = time.time()
        stream = await db.get_db_index(meta)
        task = asyncio.create_task(monitor_items.run(stream, handle))
        # phase deadline: a wedged device dispatch must not silence the
        # bench past its budget (observed: one run stalled here >10min)
        deadline = t0 + min(max(remaining(), 60.0), 400.0)
        last_log = t0
        cnt = 0
        while cnt < n_ing and time.time() < deadline:
            try:
                # 150s: a cold compile burst can hold the actor's
                # executor thread for a while; only a genuinely wedged
                # dispatch exceeds this
                cnt = await asyncio.wait_for(handle.count(), timeout=150)
            except asyncio.TimeoutError:
                log("# config-3 count() timed out (wedged dispatch)")
                break
            now = time.time()
            if now - last_log > 30:
                log(f"#   pipeline ingest {cnt}/{n_ing}: {cnt / (now - t0):.0f} vec/s")
                last_log = now
            await asyncio.sleep(0.2)
        dt = time.time() - t0
        stream.stop()
        try:
            await asyncio.wait_for(stream.close(), timeout=30)
            if cnt >= n_ing:
                await asyncio.wait_for(task, timeout=60)
                cnt = await asyncio.wait_for(handle.count(), timeout=60)
                handle.close()
                await asyncio.wait_for(handle.join(), timeout=60)
            else:
                log(f"# config-3 pipeline cut at deadline ({cnt}/{n_ing} rows)")
        except asyncio.TimeoutError:
            log("# config-3 teardown timed out (wedged dispatch)")
        return dt, cnt

    dt, cnt = asyncio.run(run())
    log(
        f"# config-3 ingest pipeline (memdb→monitor→actor, int8 {d}-d): "
        f"{cnt / dt:.0f} vec/s over {cnt} rows"
    , recap=True)


def cpu_baseline_qps(x, queries) -> float:
    """CPU-HNSW anchor on identical data (cached; measuring takes hours
    single-core at 1M, so a missing cache entry is only filled when the
    budget clearly allows or VST_BENCH_FORCE_BASELINE=1)."""
    key = f"{N}x{D}-seed{SEED}"
    cache = {}
    if os.path.exists(BASELINE_CACHE):
        with open(BASELINE_CACHE) as fh:
            cache = json.load(fh)
        if key in cache:
            return float(cache[key]["qps"])
    if os.environ.get("VST_BENCH_SKIP_BASELINE") == "1":
        return 0.0
    if (
        os.environ.get("VST_BENCH_FORCE_BASELINE") != "1"
        and N * D > 100_000 * 128
    ):
        log(f"# cpu baseline: no cache entry for {key}; skipping (hours-long)")
        return 0.0

    from vector_store_tpu.utils.native import HnswBaseline

    n, d = x.shape
    t0 = time.time()
    h = HnswBaseline(d, m=16, ef_construction=128, space="cosine")
    h.add(x)
    build_s = time.time() - t0

    xn = x / np.linalg.norm(x, axis=1, keepdims=True)
    qn = queries / np.linalg.norm(queries, axis=1, keepdims=True)
    exact = np.argsort(1.0 - qn @ xn.T, axis=1)[:, :K]

    result = None
    for ef in (32, 48, 64, 96, 128, 192, 256):
        t0 = time.time()
        _, ids = h.search(queries, K, ef=ef)
        qps = len(queries) / (time.time() - t0)
        rec = recall_of(ids, exact)
        log(f"# cpu ef={ef}: recall={rec:.3f} qps={qps:.0f}")
        result = {"qps": qps, "recall": rec, "build_s": build_s, "ef": ef}
        if rec >= TARGET_RECALL:
            break

    cache[key] = result
    with open(BASELINE_CACHE, "w") as fh:
        json.dump(cache, fh, indent=1)
    return float(result["qps"])


def main() -> None:
    import jax

    from vector_store_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    dev = jax.devices()[0]
    log(
        f"# bench: N={N} D={D} Q={Q} budget={BUDGET_S:.0f}s "
        f"device={dev.platform}/{dev.device_kind} x{len(jax.devices())}"
    )
    signal.signal(signal.SIGTERM, _on_term)
    threading.Thread(target=_watchdog, daemon=True, name="headline-watchdog").start()
    timer = DeviceTimer()
    x, queries = make_dataset(N, D, Q)

    # 2. exact scan: ground truth + fallback candidate
    exact, exact_idx, _scan_cand = bench_exact_scan(x, queries, timer)

    # 3. IVF int8 — the headline candidate
    ivf, rest_probes = None, ()
    try:
        _ivf_cand, ivf, rest_probes = bench_ivf(x, queries, exact, timer)
    except Exception as exc:  # noqa: BLE001
        log(f"# ivf phase failed: {exc!r}")

    # -> HEADLINE, printed the moment a recall>=0.95 number exists
    best_qps = max((c[1] for c in CANDIDATES if c[2] >= TARGET_RECALL), default=0.0)
    base_qps = cpu_baseline_qps(x, queries)
    print_headline(best_qps / base_qps if base_qps else 0.0)
    if LITE:
        return

    # 4. best-effort extras under the wall-clock budget; nothing below
    #    this line may change the exit code.  ONE extra IVF curve point
    #    runs first (the live 1M IVF is hot).
    if ivf is not None and rest_probes and fits(60, "ivf curve rest"):
        try:
            import jax.numpy as jnp

            from vector_store_tpu.core.ivf import (
                search_clustered,
                search_clustered_kernel,
            )

            scan = search_clustered_kernel if ivf._kernel else search_clustered
            st = ivf.state
            qdev = [jnp.asarray(np.roll(queries, r, axis=0)) for r in range(12)]
            probes = rest_probes[0]
            _, i_ = ivf.search(queries, K, probes=probes)
            qps = timer.qps(
                lambda r: scan(st, qdev[r % 12], "cosine", K, probes),
                len(queries),
                reps=6,
            )
            log(
                f"#   ivf probes={probes}: recall@10={recall_of(i_, exact):.3f} "
                f"qps={qps:.0f}"
            )
            del st, qdev
        except Exception as exc:  # noqa: BLE001
            log(f"# ivf curve rest failed: {exc!r}")
    del exact_idx
    gc.collect()

    ivf_box = [ivf] if ivf is not None else []

    def churn_phase():
        # config-4: needs (and mutates) the live 1M IVF.  The large-N
        # phase RELEASES that index before allocating its 8.6GB bank, so
        # churn only runs when the index is still alive.
        if not ivf_box or not ivf_box[0]._clustered:
            log("# skip config-4 churn: live 1M ivf already released")
            return
        bench_churn(ivf_box[0], x, exact_probes=8)

    # The large-N phase releases the live 1M IVF, so it runs after the
    # phases that can share it; churn needs that index and runs only if
    # it is still alive.
    extras = [
        ("graph rung", 200, lambda: bench_graph(x, queries, exact, timer)),
        ("serving-path latency+qps", 120, bench_serving_latency),
        ("config-3 ingest pipeline", 120, bench_ingest_pipeline),
        ("large-N 8M ivf", 300, lambda: bench_large_n(x, queries, timer, ivf_box)),
        ("text search", 150, lambda: bench_text(timer)),
        ("config-4 churn+compact", 240, churn_phase),
        ("scan-int8", 150, lambda: bench_scan_int8(x, queries, exact, timer)),
        ("real-data recall", 150, lambda: bench_real_data(timer)),
    ]
    for phase, est, fn in extras:
        if not fits(est, phase, frac=0.6):
            continue
        try:
            t0 = time.time()
            fn()
            log(f"# {phase}: done in {time.time() - t0:.0f}s")
        except Exception as exc:  # noqa: BLE001 — headline already out
            log(f"# {phase} failed: {exc!r}")
            # drop the failed phase's device allocations before the next
            # phase (an OOM'd bank held via the exception chain would
            # starve every later phase)
            exc = None
            gc.collect()
    log(f"# bench done in {time.time() - T_START:.0f}s")


if __name__ == "__main__":
    try:
        main()
    finally:
        # the LAST line of output must be the headline JSON (the driver
        # parses the end of combined output; see emit_final)
        emit_final()
    sys.exit(0)
