"""Diagnose graph recall saturation on a capped build.

Reproduces bench.py's capped graph build (first 2^17 rows of the 1M-style
clustered corpus, insert_block=1024, f32 bank) and sweeps the suspects:

  a. baseline rungs ef=64 / ef=128          (expect ~0.939 / ~0.943)
  b. approx_topk off (exact routing + merge)
  c. bigger entry stage (entry_points=32)
  d. refine(1) NN-descent pass, re-measure
  e. forced centroid router at this N (ROUTE_MIN_ROWS bypass)
  f. insert_block=256 rebuild (quality-vs-block A/B)

Usage: python scripts/diag_graph_recall.py [--n 131072] [--skip-rebuild]
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time

import numpy as np

sys.path.insert(0, ".")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from vector_store_tpu.core import SlotIndex, bruteforce  # noqa: E402
from vector_store_tpu.core import distance as dist_mod  # noqa: E402
from vector_store_tpu.core import search as search_mod  # noqa: E402
from vector_store_tpu.types import IndexParams  # noqa: E402

K = 10


def log(msg: str) -> None:
    print(f"[{time.time() - T0:5.0f}s] {msg}", file=sys.stderr, flush=True)


T0 = time.time()


def gen(n: int, d: int, q: int, seed: int = 42, n_full: int = 1_000_000):
    # bench.py's corpus recipe.  n_full controls the cluster count:
    # n_full=1M reproduces the bench's capped-prefix statistics (20k
    # centers, ~6.5 rows each in a 131k prefix); n_full=n generates a
    # self-consistent corpus of the built size (~50 rows per center).
    crng = np.random.default_rng([seed, 1])
    n_clusters = max(n_full // 50, 16)
    centers = crng.standard_normal((n_clusters, d), dtype=np.float32)
    x = crng.standard_normal((n, d), dtype=np.float32)
    x *= 0.35
    assign = crng.integers(0, n_clusters, n)
    x += centers[assign]
    rng = np.random.default_rng(seed)
    qi = rng.choice(n, q, replace=False)
    queries = x[qi] + 0.25 * rng.standard_normal((q, d), dtype=np.float32)
    return x, queries.astype(np.float32)


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


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1 << 17)
    ap.add_argument("--q", type=int, default=512)
    ap.add_argument("--d", type=int, default=768)
    ap.add_argument("--block", type=int, default=1024)
    ap.add_argument("--skip", default="", help="comma list of step letters")
    ap.add_argument(
        "--scaled-clusters",
        action="store_true",
        help="cluster count derived from --n, not the bench's 1M",
    )
    args = ap.parse_args()
    skip = set(args.skip.split(","))

    x, queries = gen(
        args.n,
        args.d,
        args.q,
        n_full=args.n if args.scaled_clusters else 1_000_000,
    )
    log(f"data ready {x.shape}")
    # oracle difficulty probe: how many of each query's true top-10 live
    # in the query's own generating cluster (host estimate via the best
    # cosine row) — the prefix-vs-scaled corpus difficulty in one number
    xn = x / np.linalg.norm(x, axis=1, keepdims=True)
    qn = queries / np.linalg.norm(queries, axis=1, keepdims=True)
    sims = qn[:64] @ xn.T  # [64, n]
    part = np.argpartition(-sims, 10, axis=1)[:, :10]
    top_sims = np.take_along_axis(sims, part, axis=1)
    log(
        "oracle top-10 cosine sims (64q): "
        f"best={top_sims.max(1).mean():.3f} "
        f"worst={top_sims.min(1).mean():.3f} "
        f"frac>0.5={float((top_sims > 0.5).mean()):.2f}"
    )
    del xn, qn, sims

    def build(block: int) -> SlotIndex:
        cap = max(1 << 16, 1 << (args.n - 1).bit_length())
        idx = SlotIndex(
            IndexParams(dimensions=args.d, space="cosine", capacity=args.n),
            initial_capacity=cap,
            insert_block=block,
        )
        t0 = time.time()
        idx.add(x)
        log(f"build block={block}: {args.n / (time.time() - t0):.0f} vec/s")
        return idx

    idx = build(args.block)

    qdev = jnp.asarray(queries)
    qp = dist_mod.preprocess(qdev, "cosine").astype(idx.cfg.compute_dtype)
    _, oracle_ids = bruteforce.search(
        qp, idx.state.vectors, idx.state.valid, "cosine", K, approx=False
    )
    exact = np.asarray(oracle_ids)

    def measure(tag: str, idx: SlotIndex, **knobs) -> float:
        cfg = dataclasses.replace(idx.cfg, **knobs)
        d_, i_ = search_mod.search(idx.state, qdev, cfg, K)
        jax.block_until_ready((d_, i_))
        rec = recall_of(np.asarray(i_), exact)
        log(f"  {tag}: recall@10={rec:.4f}")
        return rec

    if "a" not in skip:
        measure("a1 ef=64 (bench rung)", idx, ef_search=64, iters=12, beam_width=6)
        measure("a2 ef=128", idx, ef_search=128, iters=20, beam_width=8)
    if "b" not in skip:
        measure(
            "b  ef=64 approx_topk=off",
            idx,
            ef_search=64,
            iters=12,
            beam_width=6,
            approx_topk=False,
        )
    if "c" not in skip:
        measure(
            "c  ef=64 entry=64 sample=32k",
            idx,
            ef_search=64,
            iters=12,
            beam_width=6,
            entry_points=64,
            routing_sample=1 << 15,
        )
    if "e" not in skip:
        # force the centroid router at this N (normally ROUTE_MIN_ROWS-gated)
        idx._rebuild_router_locked(int(idx.state.frontier))
        measure("e  ef=64 routed", idx, ef_search=64, iters=12, beam_width=6)
        # back to flat for the refine comparison
        from vector_store_tpu.core import graph as graph_mod

        idx.cfg = dataclasses.replace(idx.cfg, route_k=0)
        rc, rm, rn = graph_mod.init_router(idx.cfg)
        idx._state = idx._state._replace(
            route_centroids=rc, route_members=rm, route_cnt=rn
        )
    if "d" not in skip:
        t0 = time.time()
        idx.refine(1)
        jax.block_until_ready(idx.state.neighbors)
        log(f"refine(1) took {time.time() - t0:.0f}s")
        measure("d1 ef=64 after refine", idx, ef_search=64, iters=12, beam_width=6)
        measure("d2 ef=128 after refine", idx, ef_search=128, iters=20, beam_width=8)
    if "f" not in skip:
        del idx
        idx = build(256)
        measure("f1 ef=64 block=256", idx, ef_search=64, iters=12, beam_width=6)
        measure("f2 ef=128 block=256", idx, ef_search=128, iters=20, beam_width=8)


if __name__ == "__main__":
    main()
