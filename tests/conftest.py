"""Test harness: CPU-backed JAX with a virtual 8-device mesh.

Mirrors the reference's test strategy (SURVEY §4): tmpdir/in-memory object
stores stand in for S3, and `xla_force_host_platform_device_count=8` gives a
fake multi-chip mesh so sharding tests run anywhere (the TPU analog of the
reference's shared-runtime test fixtures, storage.rs:386-396).
"""

import os

# Must happen before jax initializes a backend. Force CPU: unit tests are
# deterministic oracles; the driver benches the real chip separately.
os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()
# Any test path that hits the aggregation dispatcher's 'auto' cold may
# trigger a calibration micro-A/B (ops/agg_registry.py); shrink it so the
# one-time cost is milliseconds, not seconds. Tests that pin their own
# size/cache (test_agg_registry.py) override via monkeypatch.
os.environ.setdefault("HORAEDB_AGG_CALIB_N", "20000")

import asyncio
import functools

import pytest

# A pytest plugin may have imported jax before this conftest ran; the backend
# is still uninitialized at collection time, so the config route also works.
import jax

jax.config.update("jax_platforms", "cpu")


def async_test(fn):
    """Run an async test via asyncio.run (no pytest-asyncio dependency)."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        return asyncio.run(fn(*args, **kwargs))

    return wrapper


@pytest.fixture()
def mem_store():
    from horaedb_tpu.objstore import MemStore

    return MemStore()


@pytest.fixture()
def local_store(tmp_path):
    from horaedb_tpu.objstore import LocalStore

    return LocalStore(str(tmp_path / "store"))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device; skips where there is none"
    )
