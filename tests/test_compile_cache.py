"""Persistent compile cache placement (utils/compile_cache.py): the
directory JAX_COMPILATION_CACHE_DIR names when it is set, else
<checkout>/.jax_cache — and cache files land only there."""

import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROG = """
import sys
import jax, jax.numpy as jnp
import vector_store_tpu.utils.compile_cache as cc
cc.CHECKOUT = sys.argv[1]
print(cc.enable_compile_cache())
jax.jit(lambda a: jnp.sin(a) * 3 + 1)(jnp.arange(64.0)).block_until_ready()
"""


def _files(path):
    return sorted(
        os.path.join(d, f) for d, _, fs in os.walk(path) for f in fs
    )


@pytest.mark.parametrize("env_set", [True, False])
def test_cache_lands_in_one_place(tmp_path, env_set):
    checkout = tmp_path / "checkout"
    named = tmp_path / "named"
    checkout.mkdir()
    env = {
        k: v for k, v in os.environ.items() if k != "JAX_COMPILATION_CACHE_DIR"
    }
    env.update(
        JAX_PLATFORMS="cpu",
        PYTHONPATH=ROOT,
        JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS="0",
    )
    if env_set:
        env["JAX_COMPILATION_CACHE_DIR"] = str(named)
    out = subprocess.run(
        [sys.executable, "-c", _PROG, str(checkout)],
        env=env,
        capture_output=True,
        text=True,
        timeout=120,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    want = named if env_set else checkout / ".jax_cache"
    assert out.stdout.strip().splitlines()[0] == str(want)
    assert _files(want), "no cache entry written"
    other = checkout if env_set else named
    assert not _files(other)
