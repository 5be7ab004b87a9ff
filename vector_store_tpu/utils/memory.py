"""Device memory size, for the capacity rules that scale with it."""

from __future__ import annotations

import functools
import os

import jax


@functools.lru_cache(maxsize=1)
def device_memory_bytes() -> int:
    """Bytes the default device lets this process allocate (the
    backend's `bytes_limit`).  The CPU backend reports no limit; there
    the host's physical memory stands in, since that is what its arrays
    live in."""
    stats = jax.devices()[0].memory_stats() or {}
    limit = stats.get("bytes_limit")
    if limit:
        return int(limit)
    return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
