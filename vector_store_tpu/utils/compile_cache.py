"""Persistent XLA compilation cache placement."""

from __future__ import annotations

import os

import jax

# The checkout that holds this package: <checkout>/vector_store_tpu/utils/
CHECKOUT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its
    directory.  Where JAX_COMPILATION_CACHE_DIR is set, JAX reads it
    itself and no other directory is set; otherwise the cache is
    <checkout>/.jax_cache.  Call before the first compile."""
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not path:
        path = os.path.join(CHECKOUT, ".jax_cache")
        jax.config.update("jax_compilation_cache_dir", path)
    return path
