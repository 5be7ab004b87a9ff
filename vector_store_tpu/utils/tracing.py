"""Structured logging + device profiling helpers.

The reference wraps every actor task in a named tracing span carrying
the index id (src/index/usearch.rs:135, src/engine.rs:128, …) and traces
HTTP requests with tower-http (src/httproutes.rs:45).  The
equivalents here: stdlib logging with per-actor logger names (vst.engine,
vst.ann, …, already wired throughout), and `jax.profiler` traces around
device steps for XLA-level timing.
"""

from __future__ import annotations

import contextlib
import logging
import time
from typing import Iterator

log = logging.getLogger("vst.trace")


@contextlib.contextmanager
def span(name: str, **fields) -> Iterator[None]:
    """Debug-span analogue: logs entry/exit with duration at DEBUG."""
    t0 = time.perf_counter()
    extra = " ".join(f"{k}={v}" for k, v in fields.items())
    log.debug("enter %s %s", name, extra)
    try:
        yield
    finally:
        log.debug("exit %s %s dur=%.3fms", name, extra, 1e3 * (time.perf_counter() - t0))


@contextlib.contextmanager
def device_trace(name: str) -> Iterator[None]:
    """jax.profiler annotation (shows up in TensorBoard/perfetto traces)."""
    import jax

    with jax.profiler.TraceAnnotation(name):
        yield


def start_profiler(logdir: str) -> None:
    import jax

    jax.profiler.start_trace(logdir)


def stop_profiler() -> None:
    import jax

    jax.profiler.stop_trace()
