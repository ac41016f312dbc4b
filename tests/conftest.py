"""Test configuration: force the CPU backend (8 virtual devices for
sharding tests) before JAX initializes, and provide corpus fixtures.

The golden corpus in tests/data is the reference test suite's input +
output_verify trees (data fixtures inherited from Python Circuitscape 4,
same provenance as the reference's own goldens).
"""

import os
import sys

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                           " --xla_force_host_platform_device_count=8")
os.environ["JAX_PLATFORMS"] = "cpu"

import jax

jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import pytest

DATA_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device (skips without one)")


@pytest.fixture(scope="session")
def data_dir():
    return DATA_DIR


@pytest.fixture()
def in_data_dir(tmp_path, monkeypatch):
    """Run inside tests/data with a clean output/ directory (the INI
    files use paths relative to the corpus root)."""
    monkeypatch.chdir(DATA_DIR)
    outdir = os.path.join(DATA_DIR, "output")
    os.makedirs(outdir, exist_ok=True)
    yield DATA_DIR
