"""Service entry point — `python -m vector_store_tpu`.

Mirrors src/main.rs: load .env, init logging, parse the bind address
from the environment, run engine + HTTP server, wait for SIGINT/SIGTERM.
Optionally starts the ingestion monitors against a source (the MemDb
demo source with --demo; a real CDC source would plug in here).
"""

from __future__ import annotations

import argparse
import asyncio
import logging

from . import new_index_factory, run, wait_for_shutdown
from .config import Config, load_dotenv


async def main() -> None:
    load_dotenv()
    from .utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    cfg = Config()
    parser = argparse.ArgumentParser("vector_store_tpu")
    parser.add_argument("--addr", default=cfg.http_addr, help="host:port to bind")
    parser.add_argument(
        "--demo",
        action="store_true",
        help="attach an in-memory demo DB source with the ingestion monitors",
    )
    parser.add_argument(
        "--n-devices",
        type=int,
        default=cfg.n_devices,
        help="devices to shard indexes over (1=one device, 0=all visible)",
    )
    args = parser.parse_args()

    logging.basicConfig(
        level=cfg.log_level,
        format="%(asctime)s %(levelname)s %(name)s %(message)s",
    )

    # multi-host first (must precede the first backend-resolving call),
    # then resolve the device count
    if cfg.maybe_init_distributed():
        logging.getLogger("vst").info(
            "jax.distributed up: process %s/%s",
            cfg.dist_process_id,
            cfg.dist_num_processes,
        )
    n_devices = args.n_devices
    if n_devices == 0:
        import jax

        n_devices = len(jax.devices())

    server, engine = await run(
        args.addr,
        new_index_factory(
            max_batch=cfg.max_batch,
            window_s=cfg.batch_window_ms / 1000.0,
            n_devices=n_devices,
        ),
    )
    print(f"listening on http://{server.addr}  (swagger: /swagger-ui)")

    monitor = None
    if args.demo:
        from .ingest import MemDb, MonitorIndexes

        db = MemDb()
        monitor = MonitorIndexes(db, engine)
        monitor.spawn()

    try:
        await wait_for_shutdown()
    finally:
        if monitor is not None:
            await monitor.stop()
        await server.close()
        await engine.close()


if __name__ == "__main__":
    asyncio.run(main())
