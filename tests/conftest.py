"""Test harness: the CPU backend with 8 virtual devices, by default.

Multi-device tests run on a virtual 8-device CPU mesh
(`xla_force_host_platform_device_count`).  Tests that need the card are
marked `gpu` and take the `gpu` fixture, which skips them on the CPU.

To run them on a GPU machine, set VST_TEST_DEVICE=gpu, which leaves
JAX's platform choice alone:

    VST_TEST_DEVICE=gpu python -m pytest tests -m gpu
"""

import os
import sys

ON_CARD = os.environ.get("VST_TEST_DEVICE") == "gpu"

if not ON_CARD:
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()
    os.environ["JAX_PLATFORMS"] = "cpu"

import jax

if not ON_CARD:
    jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import pytest


@pytest.fixture
def gpu():
    """Skip unless the default device is a GPU (decided at run time,
    never at collection, so every worker collects the same tests)."""
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU (run with VST_TEST_DEVICE=gpu on the card)")
    return jax.devices()[0]


@pytest.fixture
def rng():
    return np.random.default_rng(0x5EED)


# --- minimal async test support (pytest-asyncio is not in the image) -------

import asyncio
import inspect


def pytest_configure(config):
    config.addinivalue_line("markers", "asyncio: run test in an event loop")


@pytest.hookimpl(tryfirst=True)
def pytest_pyfunc_call(pyfuncitem):
    fn = pyfuncitem.obj
    if inspect.iscoroutinefunction(fn):
        kwargs = {
            name: pyfuncitem.funcargs[name]
            for name in pyfuncitem._fixtureinfo.argnames
        }
        asyncio.run(fn(**kwargs))
        return True
    return None
