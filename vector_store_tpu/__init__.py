"""vector_store_tpu — a vector & text search service on an accelerator.

A ground-up JAX/XLA/Pallas re-design of the capability set of
swasik/vector-store-text (ScyllaDB's vector-store sidecar + its text-search
fork): an ANN engine as a device-resident graph index driven by batched
jitted steps, a per-index actor runtime, a CDC-style ingestion pipeline
and a REST front — see SURVEY.md for the component-by-component mapping.

Public surface (mirrors reference src/lib.rs:267-295):
    run(addr, factory)      — start engine + HTTP server
    new_index_factory(...)  — default backend factory
    wait_for_shutdown()     — SIGINT/SIGTERM latch
"""

__version__ = "0.1.0"

from .types import (  # noqa: F401
    AnnResult,
    DbEmbedding,
    IndexId,
    IndexMetadata,
    IndexParams,
    Limit,
    PrimaryKey,
    Timestamp,
    primary_key,
)


def new_index_factory(
    exact: bool = False,
    max_batch: int = 256,
    window_s: float = 0.002,
    n_devices: int = 1,
):
    """Default factory: ANN + exact + text backends behind one routing
    seam (reference: lib.rs:275-277 built the opensearch factory).
    `n_devices > 1` shards ANN and text indexes over the device mesh."""
    from .engine.ann_index import AnnIndexFactory
    from .engine.factory import RoutingFactory
    from .engine.text_index import TextIndexFactory

    return RoutingFactory(
        {
            "ann": AnnIndexFactory(
                max_batch=max_batch, window_s=window_s, n_devices=n_devices
            ),
            "exact": AnnIndexFactory(
                exact=True, max_batch=max_batch, window_s=window_s
            ),
            "ivf": AnnIndexFactory(
                backend="ivf",
                max_batch=max_batch,
                window_s=window_s,
                n_devices=n_devices,
            ),
            "text": TextIndexFactory(window_s=window_s, n_devices=n_devices),
        }
    )


async def run(addr: str, index_factory=None):
    """Start engine + HTTP server; returns (HttpServer, EngineHandle)
    (reference: lib.rs:267-273)."""
    from .api.server import serve
    from .engine.engine import new_engine

    engine = await new_engine(index_factory or new_index_factory())
    server = await serve(addr, engine)
    return server, engine


async def wait_for_shutdown() -> None:
    """SIGINT/SIGTERM latch (reference: lib.rs:279-295)."""
    from .api.server import wait_for_shutdown as _wait

    await _wait()
