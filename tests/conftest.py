"""Test configuration: virtual 8-device CPU mesh, float64 enabled.

Multi-device sharding is validated on a virtual CPU mesh
(``xla_force_host_platform_device_count=8``); numerics are checked in
float64 against the in-repo native C++ twins (and the compiled reference
C++ oracle when it is mounted, see ``_oracle.py``).  The GPU run is
``chip_smoke.py``, not this suite.
"""
import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)

from cp_pfdr_graph_d1_tpu.utils.compile_cache import \
    enable_compile_cache  # noqa: E402

# persistent compile cache: the CP solvers compile several bucket-size
# variants; caching across test runs cuts suite time dramatically
enable_compile_cache()

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from . import _oracle  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "oracle: test requires the compiled reference library")
    config.addinivalue_line(
        "markers", "slow: example-scale acceptance test")


def pytest_collection_modifyitems(config, items):
    if _oracle.available():
        return
    skip = pytest.mark.skip(reason="reference oracle unavailable")
    for item in items:
        if "oracle" in item.keywords:
            item.add_marker(skip)


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(42)


def make_grid_graph(h, w, seed=0, weight_scale=1.0):
    """2-D 4-neighborhood grid graph with random positive weights."""
    r = np.random.default_rng(seed)
    idx = np.arange(h * w).reshape(h, w)
    eu = np.concatenate([idx[:, :-1].ravel(), idx[:-1, :].ravel()])
    ev = np.concatenate([idx[:, 1:].ravel(), idx[1:, :].ravel()])
    la = weight_scale * (0.5 + r.random(eu.shape[0]))
    return eu.astype(np.int32), ev.astype(np.int32), la


@pytest.fixture
def grid_graph():
    return make_grid_graph
