import os

# Tests run single-device (the dry-run sets its own 512-device env in a
# subprocess).  Force float64 availability for oracle comparisons.
os.environ.setdefault("JAX_ENABLE_X64", "1")

import numpy as np
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU and nvcc; skips without them")


@pytest.fixture(scope="session")
def small_graphs():
    """A couple of small graphs shared across tests."""
    from repro.graphs import ring_of_cliques, gaussian_blobs_knn, grid_graph

    roc, roc_truth = ring_of_cliques(4, 10)
    blobs, blobs_truth = gaussian_blobs_knn(30, 4, seed=1)
    grid = grid_graph(8, 8)
    return {
        "roc": (roc, roc_truth),
        "blobs": (blobs, blobs_truth),
        "grid": (grid, None),
    }


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(42)
