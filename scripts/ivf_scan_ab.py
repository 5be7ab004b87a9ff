#!/usr/bin/env python
"""IVF probe-scan A/B on a GPU: the Pallas kernel against the XLA scan.

Builds the service's IVF index (1M x 768 int8 cosine by default, the
default rows-per-bucket geometry) from the bench's clustered corpus,
then times `IvfIndex.search_dispatch` end to end at probes=16, k=10 with
the kernel path and with the XLA path, in turns (xla, kernel, kernel,
xla, ...), for each batch size.  Each timing is the median of REPS runs
after warm-up; a run ends when its results are on the host.  Before the
timed part, the compiled kernel's [Q, p·B] pool is compared with numpy
on the probed blocks.

    python scripts/ivf_scan_ab.py [--n 1000000] [--batches 256,2048]

Needs a GPU; exits 2 without one.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        check=True,
    ).stdout.strip()


def pool_check(idx, queries, probes):
    """Compiled kernel pool vs float64 numpy on the same probed blocks."""
    import jax.numpy as jnp

    from vector_store_tpu.core import distance as dist_mod
    from vector_store_tpu.core.ivf import _route
    from vector_store_tpu.core.ivf_pallas import SENTINEL, live_rows, probe_scan

    st = idx.state
    q = jnp.asarray(queries)
    _, cids, _ = _route(st, q, "cosine", probes)
    qf = dist_mod.preprocess(q, "cosine")
    rid_masked = jnp.where(st.valid, st.rowid, SENTINEL)
    nlive = live_rows(st.valid)
    pool = np.asarray(
        probe_scan(st.vectors, st.scales, rid_masked, nlive, qf, cids, "cosine")
    )
    cids_h, nlive_h = np.asarray(cids), np.asarray(nlive)
    rid_h, qf_h = np.asarray(rid_masked), np.asarray(qf, np.float64)
    B = st.bucket
    err = 0.0
    for i in range(len(queries)):
        for r in range(cids_h.shape[1]):
            c = int(cids_h[i, r])
            x = np.asarray(st.vectors[c]).astype(np.float64)
            x *= np.asarray(st.scales[c], np.float64)[:, None]
            ref = 1.0 - x @ qf_h[i]
            ok = (np.arange(B) < nlive_h[c]) & (rid_h[c] != SENTINEL)
            got = pool[i, r * B : (r + 1) * B]
            if not (np.isinf(got) == ~ok).all():
                raise AssertionError(f"live mask differs at query {i} probe {r}")
            err = max(err, float(np.max(np.abs(got[ok] - ref[ok]), initial=0.0)))
    return err


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--d", type=int, default=768)
    ap.add_argument("--batches", default="256,2048")
    ap.add_argument("--probes", type=int, default=16)
    ap.add_argument("--reps", type=int, default=7)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--seed", type=int, default=42)
    args = ap.parse_args()

    import jax

    if jax.devices()[0].platform != "gpu":
        print("no GPU found", file=sys.stderr)
        sys.exit(2)
    from bench import clustered_corpus, perturbed_queries
    from vector_store_tpu.core.ivf import IvfIndex
    from vector_store_tpu.types import IndexParams
    from vector_store_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    print(f"# card: {_card()}  jax {jax.__version__}  {jax.devices()[0].device_kind}")
    t0 = time.time()
    x = clustered_corpus(args.n, args.d, args.seed)
    print(f"# corpus {args.n}x{args.d}: {time.time() - t0:.1f}s")
    idx = IvfIndex(IndexParams(dimensions=args.d, space="cosine", dtype="int8"))
    t0 = time.time()
    idx.add(x)
    jax.block_until_ready(idx.state)
    print(
        f"# ingest {time.time() - t0:.1f}s: K={idx.n_clusters} "
        f"B={idx.state.bucket} clustered={idx._clustered}"
    )
    assert idx._kernel, "GPU platform must choose the kernel path"

    q_small = perturbed_queries(x, 8, args.seed + 1)
    t0 = time.time()
    err = pool_check(idx, q_small, args.probes)
    print(
        f"# pool check: max |kernel - numpy f64| = {err:.3e} over 8 queries "
        f"x {args.probes} probes (f32 kernel, int8 bank) ({time.time() - t0:.1f}s)"
    )

    results = {}
    for batch in [int(b) for b in args.batches.split(",")]:
        qs = [perturbed_queries(x, batch, args.seed + 10 + r) for r in range(args.reps)]
        _, exact = idx.exact_search(qs[0], 10)
        outs, times = {}, {"xla": [], "kernel": []}

        def run(path, q):
            idx._kernel = path == "kernel"
            t = time.perf_counter()
            out = idx.search_dispatch(q, 10, args.probes)()
            return time.perf_counter() - t, out

        for path in ("xla", "kernel"):  # warm-up: compiles every chunk shape
            _, outs[path] = run(path, qs[0])
        order = ["xla", "kernel", "kernel", "xla"] * args.rounds
        for path in order:
            for q in qs:
                dt, _ = run(path, q)
                times[path].append(dt)
        idx._kernel = True
        rec = {
            p: float(
                np.mean(
                    [
                        len(set(outs[p][1][i]) & set(exact[i])) / 10
                        for i in range(batch)
                    ]
                )
            )
            for p in outs
        }
        med = {p: statistics.median(v) for p, v in times.items()}
        iqr = {
            p: statistics.quantiles(v, n=4)[2] - statistics.quantiles(v, n=4)[0]
            for p, v in times.items()
        }
        for p in ("xla", "kernel"):
            print(
                f"# batch {batch} {p}: median {med[p] * 1e3:.3f} ms "
                f"(IQR {iqr[p] * 1e3:.3f} ms, {batch / med[p]:.0f} QPS) over "
                f"{len(times[p])} runs, recall@10 {rec[p]:.4f}"
            )
        results[batch] = {"median_s": med, "iqr_s": iqr, "recall": rec}
    print(json.dumps({"card": _card(), "ab": results}))


if __name__ == "__main__":
    main()
