"""Closed-loop HTTP load generator for the ANN serving path.

Runs OUTSIDE the server process so client-side JSON/TCP work doesn't
share the server's GIL (in-process load generation can cap the measured
serving rate well below the server's capacity).  It never imports JAX,
so it does not take a share of the card.

Bodies are pre-encoded once (a real load generator would too); each
worker free-runs POSTs until the deadline.  Prints ONE JSON line:
  {"qps": N, "p50_ms": N, "p99_ms": N, "n": N}

Usage: python scripts/loadgen.py URL BODIES_FILE CONC SECONDS
  URL          e.g. http://127.0.0.1:8080/api/v1/indexes/ks/v1/ann
  BODIES_FILE  newline-separated pre-encoded JSON bodies
  CONC         concurrent workers (connection pool sized to match)
"""

from __future__ import annotations

import asyncio
import json
import sys
import time


async def main() -> None:
    import aiohttp

    url, bodies_file, conc_s, secs_s = sys.argv[1:5]
    conc, secs = int(conc_s), float(secs_s)
    with open(bodies_file, "rb") as f:
        bodies = f.read().split(b"\n")
    bodies = [b for b in bodies if b]
    hdr = {"Content-Type": "application/json"}

    connector = aiohttp.TCPConnector(limit=conc + 8)
    async with aiohttp.ClientSession(connector=connector) as c:
        # warm: one request per worker (connections + server compiles)
        async def warm(j):
            r = await c.post(url, data=bodies[j % len(bodies)], headers=hdr)
            assert r.status == 200, (r.status, await r.text())
            await r.read()

        await asyncio.gather(*(warm(j) for j in range(conc)))
        stop_at = time.time() + secs
        lats: list[float] = []

        async def worker(w: int) -> None:
            j = w * 131
            while time.time() < stop_at:
                t0 = time.time()
                r = await c.post(
                    url, data=bodies[j % len(bodies)], headers=hdr
                )
                assert r.status == 200, (r.status, await r.text())
                await r.read()
                lats.append(time.time() - t0)
                j += 1

        t0 = time.time()
        await asyncio.gather(*(worker(w) for w in range(conc)))
        dt = time.time() - t0
    lats.sort()
    n = len(lats)
    print(
        json.dumps(
            {
                "qps": round(n / dt, 1),
                "p50_ms": round(lats[n // 2] * 1e3, 1),
                "p99_ms": round(lats[min(n - 1, int(n * 0.99))] * 1e3, 1),
                "n": n,
            }
        )
    )


if __name__ == "__main__":
    asyncio.run(main())
