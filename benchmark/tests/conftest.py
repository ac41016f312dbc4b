"""CPU tests of the benchmark (the `cuda` test skips without a card):

    python -m pytest benchmark/tests -q

Nothing here imports JAX or the JAX package."""

import pytest
import torch

from helpers import make_tiny_tree

# one intra-op thread, as the repository's port tests run
torch.set_num_threads(1)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device (skips without one)")


@pytest.fixture()
def tiny_tree(tmp_path):
    return make_tiny_tree(tmp_path)
