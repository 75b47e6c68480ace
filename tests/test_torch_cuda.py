"""Each CUDA kernel of the port (SELL-C-σ and BSR) against its plain
PyTorch twin, on the GPU.  Imports neither JAX nor the reference, so it runs on a GPU host
that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Every test here is marked ``cuda`` and skips without a CUDA device.
Tolerances: fp64 to 1e-12; fp32 to rtol 2e-4 / atol 2e-5, the bounds of
the CPU parity tests (the kernels sum in their own order, the twins
pairwise)."""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the reference-only CI has no torch

from repro_torch import convert

K = importlib.import_module("repro_torch.kernels.sellcs_spmm.sellcs_spmm")
KB = importlib.import_module("repro_torch.kernels.bsr_spmm.bsr_spmm")
KP = importlib.import_module("repro_torch.kernels.plap_edge.plap_edge")

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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("p", [1.2, 1.5, 2.0])
@pytest.mark.parametrize("bs", [32, 128])
def test_cuda_bsr_kernels_match_twins(cuda_device, dtype, p, bs):
    coo, shape = _graph(1000)               # ragged last block at both bs
    W = convert.sparse_matrix(coo, shape, device=cuda_device, dtype=dtype,
                              build_bsr=True, block_size=bs)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    tdt = W.vals.dtype
    U = torch.randn(shape[0], 4, generator=gen, device=cuda_device, dtype=tdt)
    E = torch.randn(shape[0], 4, generator=gen, device=cuda_device, dtype=tdt)
    S = torch.randn(shape[0], 24, generator=gen, device=cuda_device,
                    dtype=tdt)                # LOBPCG's [X, R, P] width
    eps = 1e-8
    before = dict(KB.LAUNCHES, **KP.LAUNCHES)
    pairs = [(KB.bsr_spmm(W, U), KB.bsr_spmm_plain(W, U)),
             (KB.bsr_spmm(W, S), KB.bsr_spmm_plain(W, S)),
             (KP.plap_apply(W, U, p, eps), KP.plap_apply_plain(W, U, p, eps)),
             (KP.plap_hvp(W, U, E, p, eps),
              KP.plap_hvp_plain(W, U, E, p, eps))]
    torch.cuda.synchronize()
    for got, want in pairs:
        np.testing.assert_allclose(convert.to_numpy(got),
                                   convert.to_numpy(want), **TOL[dtype])
    assert float(pairs[0][0][0].abs().max()) == 0.0     # isolated vertex 0
    assert KB.LAUNCHES["bsr_spmm"] == before["bsr_spmm"] + 2
    assert KP.LAUNCHES["plap_apply"] == before["plap_apply"] + 1
    assert KP.LAUNCHES["plap_hvp"] == before["plap_hvp"] + 1


@pytest.mark.cuda
def test_cuda_bsr_spmm_column_windows_and_rectangular(cuda_device):
    """A multivector too wide for one launch's shared memory runs in
    column windows (one launch each); a rectangular matrix masks its
    ragged column block."""
    rng = np.random.default_rng(1)
    rows, cols = rng.integers(0, 700, 3000), rng.integers(0, 450, 3000)
    W = convert.sparse_matrix((rows, cols, rng.uniform(0.5, 1.5, 3000)),
                              (700, 450), device=cuda_device,
                              dtype=np.float64, build_bsr=True,
                              block_size=128)
    X = torch.randn(450, 120, device=cuda_device, dtype=torch.float64)
    before = KB.LAUNCHES["bsr_spmm"]
    got = KB.bsr_spmm(W, X)
    assert KB.LAUNCHES["bsr_spmm"] == before + 2     # 113 + 7 columns
    np.testing.assert_allclose(convert.to_numpy(got),
                               convert.to_numpy(KB.bsr_spmm_plain(W, X)),
                               **TOL[np.float64])


@pytest.mark.cuda
def test_cuda_bsr_wrappers_reject_bad_operands(cuda_device):
    coo, shape = _graph(300)
    W = convert.sparse_matrix(coo, shape, device=cuda_device,
                              dtype=np.float32, build_bsr=True, block_size=32)
    X = torch.randn(shape[0], 2, device=cuda_device)
    for bad in (X.half(), X.double(), X[:-1], X.T.contiguous().T, X.cpu()):
        with pytest.raises((TypeError, ValueError)):
            KB.bsr_spmm(W, bad)
        with pytest.raises((TypeError, ValueError)):
            KP.plap_apply(W, bad, 1.5, 1e-8)
        with pytest.raises((TypeError, ValueError)):
            KP.plap_hvp(W, X, bad, 1.5, 1e-8)


@pytest.mark.cuda
@pytest.mark.parametrize("multilevel", [False, True])
def test_cuda_pipeline_runs_through_the_bsr_kernels(cuda_device, multilevel):
    from repro_torch.core.metrics import clustering_accuracy
    from repro_torch.core.psc import PSCConfig, p_spectral_cluster
    from repro_torch.graphs import ring_of_cliques
    from repro_torch.multilevel import MultilevelConfig

    W, truth = ring_of_cliques(4, 300, device=cuda_device, build_bsr=True,
                               build_ell=False, build_sellcs=False)
    KB.reset_launch_counts()
    KP.reset_launch_counts()
    res = p_spectral_cluster(W, PSCConfig(
        k=4, p_target=1.4, newton_iters=10, tcg_iters=8,
        hvp_mode="matrix_free", backend="edge_pallas",
        multilevel=MultilevelConfig(coarse_size=256) if multilevel else None))
    assert clustering_accuracy(res.labels, truth, 4) == 1.0
    assert KP.LAUNCHES["plap_apply"] > 0 and KP.LAUNCHES["plap_hvp"] > 0
    if not multilevel:       # stage 1 on a BSR-and-COO graph: bsr_pallas
        assert KB.LAUNCHES["bsr_spmm"] > 0
