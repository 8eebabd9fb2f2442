"""Test configuration: by default run everything on the CPU with 8
virtual devices, so multi-device sharding paths are exercised without
accelerators (SURVEY.md §4: multi-chip tests via
xla_force_host_platform_device_count).

Tests that need the GPU carry the `gpu` marker and take the `gpu`
fixture, which skips them when JAX has no GPU. `chip_smoke.py` runs them
on the card: it sets BMSP_TEST_DEVICE=gpu, which leaves JAX's platform
choice alone.

Must run before jax initializes a backend, hence the env mutation at
import time.
"""

import os

if os.environ.get("BMSP_TEST_DEVICE") != "gpu":
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()

import jax

if os.environ.get("BMSP_TEST_DEVICE") != "gpu":
    jax.config.update("jax_platforms", "cpu")

import numpy as np
import pytest
import scipy.sparse as sp


REFERENCE_DATA = "/root/reference/data/real"
REPO_DATA = os.path.join(os.path.dirname(__file__), "..", "data", "real")


def data_path(name: str) -> str:
    for base in (REPO_DATA, REFERENCE_DATA):
        p = os.path.join(base, name)
        if os.path.exists(p):
            return p
    pytest.skip(f"sample matrix {name} not found")


@pytest.fixture(scope="session")
def ragusa16():
    """The in-repo sample matrix (Pajek/Ragusa16: 24x24, 81 nnz)."""
    import scipy.io

    return scipy.io.mmread(data_path("A_matrix.mtx")).tocoo()


def random_coo(m, n, density=0.1, seed=0, dtype=np.float32):
    """Random sparse matrix with no duplicate coordinates."""
    rng = np.random.default_rng(seed)
    nnz = max(1, int(m * n * density))
    flat = rng.choice(m * n, size=nnz, replace=False)
    rows, cols = np.divmod(flat, n)
    vals = rng.standard_normal(nnz).astype(dtype)
    # avoid exact zeros so structural nnz == numeric nnz
    vals = np.where(np.abs(vals) < 1e-3, np.float32(1.0), vals).astype(dtype)
    order = np.lexsort((cols, rows))
    return (
        rows[order].astype(np.int32),
        cols[order].astype(np.int32),
        vals[order],
    )


@pytest.fixture
def rng():
    return np.random.default_rng(42)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU (run on the card by "
        "chip_smoke.py; skipped elsewhere)")


@pytest.fixture
def gpu():
    """The first JAX device when it is a GPU; skips the test otherwise."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU, JAX runs on {dev.platform}")
    return dev
