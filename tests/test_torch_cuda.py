"""Each CUDA kernel of the port against its plain PyTorch twin, on the
GPU.  Imports neither JAX nor the reference, so it runs on a GPU host
that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Every test here is marked ``cuda`` and skips without a CUDA device.
Tolerances: fp64 to 1e-12; fp32 to rtol 2e-4 / atol 2e-5, the bounds of
the CPU parity tests (the kernel sums slots in order, the twin pairwise)."""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the reference-only CI has no torch

from repro_torch import convert

K = importlib.import_module("repro_torch.kernels.sellcs_spmm.sellcs_spmm")

TOL = {np.float32: dict(rtol=2e-4, atol=2e-5),
       np.float64: dict(rtol=1e-12, atol=1e-12)}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


def _graph(n, seed=0):
    """Background degree ~4 plus two hubs and one isolated vertex
    (a row of pads only), so slices of several widths."""
    rng = np.random.default_rng(seed)
    r = rng.integers(1, n, 2 * n)
    c = rng.integers(1, n, 2 * n)
    hub_r = np.repeat([1, 2], 40)
    hub_c = rng.integers(3, n, hub_r.size)
    rows = np.concatenate([r, c, hub_r, hub_c])
    cols = np.concatenate([c, r, hub_c, hub_r])
    keep = rows != cols
    key = rows[keep] * n + cols[keep]
    _, idx = np.unique(key, return_index=True)
    rows, cols = rows[keep][idx], cols[keep][idx]
    return (rows, cols, rng.uniform(0.5, 1.5, rows.size)), (n, n)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("p,eps", [(1.2, 1e-8), (1.5, 0.0), (2.0, 1e-6)])
@pytest.mark.parametrize("C", [8, 32])
def test_cuda_kernels_match_twins(cuda_device, dtype, p, eps, C):
    coo, shape = _graph(1000)
    W = convert.sparse_matrix(coo, shape, device=cuda_device, dtype=dtype,
                              build_sellcs=True, sell_c=C)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    tdt = W.vals.dtype
    U = torch.randn(shape[0], 4, generator=gen, device=cuda_device, dtype=tdt)
    E = torch.randn(shape[0], 4, generator=gen, device=cuda_device, dtype=tdt)
    mv = torch.rand(W.nnz, 4, generator=gen, device=cuda_device, dtype=tdt)
    Wh = W.with_vals(mv)
    before = dict(K.LAUNCHES)
    pairs = [(K.sellcs_spmm(W, U), K.sellcs_spmm_plain(W, U)),
             (K.sellcs_spmm(Wh, U), K.sellcs_spmm_plain(Wh, U)),
             (K.sellcs_plap_apply(W, U, p, eps),
              K.sellcs_plap_apply_plain(W, U, p, eps))]
    if eps > 0:     # eps = 0: phi'(0) = inf on the pads, in both versions
        pairs.append((K.sellcs_plap_hvp(W, U, E, p, eps),
                      K.sellcs_plap_hvp_plain(W, U, E, p, eps)))
    torch.cuda.synchronize()
    for got, want in pairs:
        np.testing.assert_allclose(convert.to_numpy(got),
                                   convert.to_numpy(want), **TOL[dtype])
    assert float(pairs[0][0][0].abs().max()) == 0.0     # isolated vertex 0
    assert K.LAUNCHES["sellcs_spmm"] == before["sellcs_spmm"] + 2
    assert K.LAUNCHES["sellcs_plap_apply"] == before["sellcs_plap_apply"] + 1
    assert K.LAUNCHES["sellcs_plap_hvp"] == \
        before["sellcs_plap_hvp"] + (1 if eps > 0 else 0)


@pytest.mark.cuda
def test_cuda_wrappers_reject_bad_operands(cuda_device):
    coo, shape = _graph(300)
    W = convert.sparse_matrix(coo, shape, device=cuda_device,
                              dtype=np.float32, build_sellcs=True)
    X = torch.randn(shape[0], 2, device=cuda_device)
    for bad in (X.half(), X.double(), X[:-1], X.T.contiguous().T, X.cpu()):
        with pytest.raises((TypeError, ValueError)):
            K.sellcs_spmm(W, bad)


@pytest.mark.cuda
def test_cuda_pipeline_runs_through_the_kernels(cuda_device):
    from repro_torch.core.psc import PSCConfig, p_spectral_cluster
    from repro_torch.graphs import ring_of_cliques

    W, truth = ring_of_cliques(4, 300, device=cuda_device, build_sellcs=True)
    K.reset_launch_counts()
    res = p_spectral_cluster(W, PSCConfig(k=4, p_target=1.4, newton_iters=10,
                                          tcg_iters=8, hvp_mode="matrix_free",
                                          backend="sellcs"))
    from repro_torch.core.metrics import clustering_accuracy

    assert clustering_accuracy(res.labels, truth, 4) == 1.0
    assert all(count > 0 for count in K.LAUNCHES.values())
