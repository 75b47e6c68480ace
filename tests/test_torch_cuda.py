"""Each CUDA kernel of the port (SELL-C-σ, BSR, flash attention and the
kmeans assignment) against its plain PyTorch twin, on the GPU.  Imports
neither JAX nor the reference, so it runs on a GPU host that has only
PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Every test here is marked ``cuda`` and skips without a CUDA device.
Tolerances: fp64 to 1e-12; fp32 to rtol 2e-4 / atol 2e-5, the bounds of
the CPU parity tests (the kernels sum in their own order, the twins
pairwise).  Flash attention in fp32 to 1e-5, in bf16 to 2^-6 (1 + |ref|)
against fp32 math on the same inputs; kmeans distances to 8 ulps of the
largest term their identity cancels."""
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
    before, spmm_before = dict(KP.LAUNCHES), KB.LAUNCHES["bsr_spmm"]
    windows = len(KB.spmm_windows(4, tdt)) + len(KB.spmm_windows(24, tdt))
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
    assert KB.LAUNCHES["bsr_spmm"] == spmm_before + windows
    # k = 4 is one window of the phi kernels, in skip mode at eps = 1e-8
    assert KP.LAUNCHES == dict(before, plap_apply=before["plap_apply"] + 1,
                               plap_hvp=before["plap_hvp"] + 1)


@pytest.mark.cuda
def test_cuda_bsr_spmm_column_windows_and_rectangular(cuda_device):
    """A multivector wider than the kernel's widest register tile runs in
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
    windows = KB.spmm_windows(120, torch.float64)   # 7 x 16 + 8 columns
    assert len(windows) > 1
    assert KB.LAUNCHES["bsr_spmm"] == before + len(windows)
    np.testing.assert_allclose(convert.to_numpy(got),
                               convert.to_numpy(KB.bsr_spmm_plain(W, X)),
                               **TOL[np.float64])


def _graph_with_empty_row_block(n, bs, seed=0):
    """_graph's pattern without any entry in rows [bs, 2 bs): a row-block
    with no tiles, written as zeros."""
    (rows, cols, vals), shape = _graph(n, seed)
    keep = (rows < bs) | (rows >= 2 * bs)
    return (rows[keep], cols[keep], vals[keep]), shape


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("bs", [32, 128])
@pytest.mark.parametrize("k", [1, 4, 8, 24, 120])
def test_cuda_bsr_spmm_widths_match_plain_and_repeat_bitwise(cuda_device,
                                                             dtype, bs, k):
    """Every width the main path uses (4, 8, 24), one column, and a
    multivector cut into windows; one launch per window of the plan, and
    the same call twice gives the same bits (no atomics)."""
    coo, shape = _graph_with_empty_row_block(1000, bs)
    W = convert.sparse_matrix(coo, shape, device=cuda_device, dtype=dtype,
                              build_bsr=True, block_size=bs)
    gen = torch.Generator(device=cuda_device).manual_seed(k)
    X = torch.randn(shape[0], k, generator=gen, device=cuda_device,
                    dtype=W.vals.dtype)
    before = KB.LAUNCHES["bsr_spmm"]
    got = KB.bsr_spmm(W, X)
    again = KB.bsr_spmm(W, X)
    torch.cuda.synchronize()
    assert KB.LAUNCHES["bsr_spmm"] == \
        before + 2 * len(KB.spmm_windows(k, X.dtype))
    assert torch.equal(got, again)
    assert float(got[bs:2 * bs].abs().max()) == 0.0     # no tiles there
    np.testing.assert_allclose(convert.to_numpy(got),
                               convert.to_numpy(KB.bsr_spmm_plain(W, X)),
                               **TOL[dtype])


@pytest.mark.cuda
def test_cuda_bsr_spmm_rejects_tiles_above_128(cuda_device):
    coo, shape = _graph(300)
    W = convert.sparse_matrix(coo, shape, device=cuda_device,
                              dtype=np.float32, build_bsr=True,
                              block_size=256)
    with pytest.raises(ValueError, match="at most 128"):
        KB.bsr_spmm(W, torch.zeros(shape[0], 4, device=cuda_device))


# ------------------------------------------------- the BSR phi kernels

def _phi_matrix(device, dtype, bs, n=1000, seed=0):
    """_graph's pattern at n = 1000 (a ragged last block at bs 32 and 128)
    with no entry in rows [bs, 2 bs) (a row-block without tiles) and its
    first stored tile off the diagonal zeroed (a stored tile that is
    entirely zero).  Vertex 0 has no edge: its column is reached only
    through the zero weights of the tiles of column block 0."""
    coo, shape = _graph_with_empty_row_block(n, bs, seed)
    W = convert.sparse_matrix(coo, shape, device=device, dtype=dtype,
                              build_bsr=True, block_size=bs)
    rb = np.repeat(np.arange(len(W.bsr_indptr) - 1), np.diff(W.bsr_indptr))
    off = np.nonzero(rb != convert.to_numpy(W.bsr_indices))[0]
    W.bsr_blocks[int(off[0])].zero_()
    return W


def _multivectors(W, k, seed):
    gen = torch.Generator(device=W.bsr_blocks.device).manual_seed(seed)
    return [torch.randn(W.n_rows, k, generator=gen, device=W.bsr_blocks.device,
                        dtype=W.bsr_blocks.dtype) for _ in range(2)]


def _assert_matches_plain(got, want, dtype):
    """NaN exactly where the plain version has it, the rest within the
    tolerance."""
    got, want = convert.to_numpy(got), convert.to_numpy(want)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, equal_nan=True, **TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("bs", [32, 128])
@pytest.mark.parametrize("p", [1.2, 1.5, 2.0])
@pytest.mark.parametrize("k", [1, 4, 8, 20])
def test_cuda_phi_kernels_match_plain_and_repeat_bitwise(cuda_device, dtype,
                                                        bs, p, k):
    """Both phi kernels in skip mode at one column, the main path's 4, 8
    (two windows in fp64) and 20 (three fp32 windows, five fp64): within
    the tolerance of their plain versions, the row-block without tiles
    zero, one launch per window under the skip counters, and the same
    call twice gives the same bits."""
    W = _phi_matrix(cuda_device, dtype, bs)
    U, E = _multivectors(W, k, seed=k)
    eps = 1e-8
    windows = len(KP.phi_windows(k, U.dtype))
    before = dict(KP.LAUNCHES)
    got_a, again_a = KP.plap_apply(W, U, p, eps), KP.plap_apply(W, U, p, eps)
    got_h, again_h = (KP.plap_hvp(W, U, E, p, eps),
                      KP.plap_hvp(W, U, E, p, eps))
    torch.cuda.synchronize()
    assert KP.LAUNCHES == dict(
        before, plap_apply=before["plap_apply"] + 2 * windows,
        plap_hvp=before["plap_hvp"] + 2 * windows)
    assert torch.equal(got_a, again_a) and torch.equal(got_h, again_h)
    for got, want in ((got_a, KP.plap_apply_plain(W, U, p, eps)),
                      (got_h, KP.plap_hvp_plain(W, U, E, p, eps))):
        assert bool(torch.isfinite(got).all())
        assert float(got[bs:2 * bs].abs().max()) == 0.0   # no tiles there
        _assert_matches_plain(got, want, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("bs", [32, 128])
def test_cuda_phi_eps_zero_hvp_full_mode_nan_where_plain(cuda_device, dtype,
                                                        bs):
    """At eps = 0 the hvp runs in full mode and returns NaN exactly where
    its plain version does (a stored column j with u_j = u_i, the
    diagonal included; U repeats values so off-diagonal columns meet it
    too); the apply stays in skip mode and finite."""
    W = _phi_matrix(cuda_device, dtype, bs)
    U, E = _multivectors(W, 4, seed=5)
    U[1::5] = U[0::5][:U[1::5].shape[0]]         # u_j = u_i off the diagonal
    before = dict(KP.LAUNCHES)
    got_h = KP.plap_hvp(W, U, E, 1.5, 0.0)
    got_a = KP.plap_apply(W, U, 1.5, 0.0)
    torch.cuda.synchronize()
    assert KP.LAUNCHES == dict(
        before, plap_hvp_full=before["plap_hvp_full"] + 1,
        plap_apply=before["plap_apply"] + 1)
    want_h = KP.plap_hvp_plain(W, U, E, 1.5, 0.0)
    assert bool(torch.isnan(want_h).any())
    assert not bool(torch.isnan(want_h).all())
    _assert_matches_plain(got_h, want_h, dtype)
    assert bool(torch.isfinite(got_a).all())
    _assert_matches_plain(got_a, KP.plap_apply_plain(W, U, 1.5, 0.0), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("bs", [32, 128])
@pytest.mark.parametrize("where", ["U", "E"])
@pytest.mark.parametrize("value", [np.nan, np.inf, -np.inf])
def test_cuda_phi_nonfinite_reached_through_zero_weights(cuda_device, dtype,
                                                         bs, where, value):
    """A NaN or +-inf at vertex 0, which only zero weights reach: in skip
    mode the tiles that stage it are evaluated in full, so the kernels
    give NaN exactly where the plain versions do (every row of a
    row-block with a tile in column block 0, in that column) and agree
    elsewhere."""
    W = _phi_matrix(cuda_device, dtype, bs)
    U, E = _multivectors(W, 4, seed=6)
    (U if where == "U" else E)[0, 1] = float(value)
    p, eps = 1.2, 1e-8
    before = dict(KP.LAUNCHES)
    got_h = KP.plap_hvp(W, U, E, p, eps)
    want_h = KP.plap_hvp_plain(W, U, E, p, eps)
    assert bool(torch.isnan(want_h[:, 1]).any())
    assert bool(torch.isfinite(want_h[:, [0, 2, 3]]).all())
    _assert_matches_plain(got_h, want_h, dtype)
    if where == "U":
        got_a = KP.plap_apply(W, U, p, eps)
        want_a = KP.plap_apply_plain(W, U, p, eps)
        assert bool(torch.isnan(want_a[:, 1]).any())
        _assert_matches_plain(got_a, want_a, dtype)
    assert KP.LAUNCHES["plap_hvp"] == before["plap_hvp"] + 1
    assert KP.LAUNCHES["plap_hvp_full"] == before["plap_hvp_full"]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("scale", [0.5, 1.0, 2.0, 4.0])
def test_cuda_phi_values_near_the_overflow_threshold(cuda_device, dtype,
                                                     scale):
    """Inputs of magnitude scale x OVERFLOW_AT, signs alternating, at the
    vertices 0, 7, 14, ..., which lose their edges (only zero weights
    reach them), in column 0 of U and column 2 of E.  Below the threshold
    (0.5) skip mode proper; at and above it the tiles that stage them are
    evaluated in full: with the same finite result at 1.0 and 2.0 (where
    d^2 overflows but (p - 2) d^2 does not, so phi' = 0), and at 4.0,
    where both overflow, with phi' and a zero weight's term NaN, as in the
    plain version (E's differences stay finite)."""
    (rows, cols, vals), shape = _graph(1000)
    keep = (rows % 7 != 0) & (cols % 7 != 0)
    W = convert.sparse_matrix((rows[keep], cols[keep], vals[keep]), shape,
                              device=cuda_device, dtype=dtype,
                              build_bsr=True, block_size=128)
    U, E = _multivectors(W, 4, seed=7)
    big = scale * KP.OVERFLOW_AT[U.dtype]
    signs = torch.ones(U[::7].shape[0], device=cuda_device, dtype=U.dtype)
    signs[1::2] = -1.0
    U[::7, 0] = big * signs
    E[::7, 2] = big * signs
    p, eps = 1.2, 1e-8
    got_a, got_h = KP.plap_apply(W, U, p, eps), KP.plap_hvp(W, U, E, p, eps)
    want_a = KP.plap_apply_plain(W, U, p, eps)
    want_h = KP.plap_hvp_plain(W, U, E, p, eps)
    assert bool(torch.isfinite(want_a).all())
    if scale <= 2.0:
        assert bool(torch.isfinite(want_h).all())
    else:
        assert bool(torch.isnan(want_h[:, 0]).any())
    _assert_matches_plain(got_a, want_a, dtype)
    _assert_matches_plain(got_h, want_h, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("name,p,eps", [("plap_apply", 2.5, 1e-8),
                                        ("plap_hvp", 2.5, 1e-8),
                                        ("plap_hvp", 1.5, 0.0),
                                        ("plap_apply", 1.2, 1e-50)])
def test_cuda_phi_full_mode_counts_its_launches(cuda_device, name, p, eps):
    """Calls outside skip mode's conditions run the full mode, one launch
    per window under the ``_full`` counter, and match the plain version."""
    W = _phi_matrix(cuda_device, np.float32, 128)
    U, E = _multivectors(W, 8, seed=8)
    assert KP.phi_mode(name, p, eps, U.dtype) == "full"
    before = dict(KP.LAUNCHES)
    if name == "plap_apply":
        got, want = (KP.plap_apply(W, U, p, eps),
                     KP.plap_apply_plain(W, U, p, eps))
    else:
        got, want = (KP.plap_hvp(W, U, E, p, eps),
                     KP.plap_hvp_plain(W, U, E, p, eps))
    key = KP.counter(name, "full")
    assert KP.LAUNCHES == dict(before, **{key: before[key] + 1})
    _assert_matches_plain(got, want, np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("bs", [32, 128])
def test_cuda_phi_divergent_variant_matches_plain(cuda_device, bs):
    """The variant kept for timing (each lane tests its own weights)
    computes the same function, counted apart from the routed modes."""
    W = _phi_matrix(cuda_device, np.float32, bs)
    U, E = _multivectors(W, 4, seed=9)
    before = dict(KP.LAUNCHES)
    got_a = KP.run_divergent("plap_apply", W, U, U, 1.2, 1e-8)
    got_h = KP.run_divergent("plap_hvp", W, U, E, 1.2, 1e-8)
    assert KP.LAUNCHES == dict(
        before, plap_apply_divergent=before["plap_apply_divergent"] + 1,
        plap_hvp_divergent=before["plap_hvp_divergent"] + 1)
    _assert_matches_plain(got_a, KP.plap_apply_plain(W, U, 1.2, 1e-8),
                          np.float32)
    _assert_matches_plain(got_h, KP.plap_hvp_plain(W, U, E, 1.2, 1e-8),
                          np.float32)


@pytest.mark.cuda
def test_cuda_phi_kernels_reject_tiles_above_128(cuda_device):
    coo, shape = _graph(300)
    W = convert.sparse_matrix(coo, shape, device=cuda_device,
                              dtype=np.float32, build_bsr=True,
                              block_size=256)
    X = torch.zeros(shape[0], 4, device=cuda_device)
    with pytest.raises(ValueError, match="at most 128"):
        KP.plap_apply(W, X, 1.5, 1e-8)
    with pytest.raises(ValueError, match="at most 128"):
        KP.plap_hvp(W, X, X, 1.5, 1e-8)


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
    # every phi launch of the solve skips zero weights
    assert sum(KP.LAUNCHES.values()) == (KP.LAUNCHES["plap_apply"]
                                         + KP.LAUNCHES["plap_hvp"])
    if not multilevel:       # stage 1 on a BSR-and-COO graph: bsr_pallas
        assert KB.LAUNCHES["bsr_spmm"] > 0


# ---------------------------------------------- flash attention, kmeans_assign

KF = importlib.import_module(
    "repro_torch.kernels.flash_attention.flash_attention")
KK = importlib.import_module(
    "repro_torch.kernels.kmeans_assign.kmeans_assign")


def _bf16_close(got, want):
    """bf16 keeps 8 significant bits (unit roundoff 2^-8); the kernel
    rounds P and O to bf16 and the reference is fp32 math on the same
    bf16 inputs, so |kernel - reference| <= 2^-6 (1 + |reference|)."""
    err = (got.float() - want).abs() / (1 + want.abs())
    assert bool(torch.isfinite(got).all())
    assert float(err.max()) <= 2 ** -6, float(err.max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,Hq,Hkv,S,D,causal,window", [
    (2, 8, 1, 256, 256, True, None),      # Gemma's MQA at head_dim 256
    (1, 8, 2, 200, 128, True, None),      # ragged S, GQA
    (2, 4, 4, 129, 64, False, None),
    (1, 4, 2, 300, 32, True, 50),         # sliding window
    (1, 2, 1, 77, 16, False, 20),
    (1, 2, 1, 1, 256, True, None),
])
def test_cuda_flash_matches_plain(cuda_device, dtype, B, Hq, Hkv, S, D,
                                  causal, window):
    from repro_torch.kernels.flash_attention import (attention_ref,
                                                     flash_attention)

    gen = torch.Generator(device=cuda_device).manual_seed(S + D)
    q, k, v = (torch.randn(shape, generator=gen, device=cuda_device).to(dtype)
               for shape in ((B, Hq, S, D), (B, Hkv, S, D), (B, Hkv, S, D)))
    name = f"flash_attention_{KF.kernel_variant(dtype, D)}"
    before = KF.LAUNCHES[name]
    got = flash_attention(q, k, v, causal=causal, window=window)
    want = attention_ref(q.float(), k.float(), v.float(), causal=causal,
                         window=window)
    torch.cuda.synchronize()
    assert KF.LAUNCHES[name] == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    if dtype == torch.float32:
        np.testing.assert_allclose(convert.to_numpy(got),
                                   convert.to_numpy(want), rtol=1e-5,
                                   atol=1e-5)
    else:
        _bf16_close(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("D,B,Hq,Hkv,S,causal,window", [
    (256, 2, 8, 1, 1000, True, None),     # Gemma-2B: MQA, group 8, ragged
    (256, 1, 4, 1, 77, True, 50),         # group 4, window
    (256, 1, 7, 1, 1, True, None),        # group 7, one token
    (256, 1, 2, 2, 200, False, None),     # group 1, non-causal
    (128, 2, 8, 2, 1000, True, 512),      # group 4, window 512
    (128, 1, 14, 2, 200, True, None),     # group 7
    (128, 1, 8, 1, 77, False, None),      # group 8, non-causal
    (128, 1, 3, 3, 1, True, None),        # group 1, one token
    (64, 1, 14, 2, 1000, True, None),     # InternVL2: group 7
    (64, 2, 4, 4, 200, True, 50),         # group 1, window
    (64, 1, 8, 1, 77, True, 512),         # group 8, window past S
    (64, 1, 16, 4, 1, False, None),       # group 4, one token
    (256, 1, 16, 1, 129, True, None),     # group 16, one row past a tile
])
def test_cuda_flash_wgmma_matches_fp32_math(cuda_device, D, B, Hq, Hkv, S,
                                            causal, window):
    """The wgmma kernel (bf16, D in {64, 128, 256}) at every group the
    port's configs use, ragged S, windows and non-causal masks."""
    from repro_torch.kernels.flash_attention import (attention_ref,
                                                     flash_attention)

    assert KF.kernel_variant(torch.bfloat16, D) == "wgmma"
    gen = torch.Generator(device=cuda_device).manual_seed(S + D + Hq)
    q, k, v = (torch.randn(shape, generator=gen, device=cuda_device)
               .to(torch.bfloat16)
               for shape in ((B, Hq, S, D), (B, Hkv, S, D), (B, Hkv, S, D)))
    before = dict(KF.LAUNCHES)
    got = flash_attention(q, k, v, causal=causal, window=window)
    want = attention_ref(q.float(), k.float(), v.float(), causal=causal,
                         window=window)
    torch.cuda.synchronize()
    assert KF.LAUNCHES["flash_attention_wgmma"] == \
        before["flash_attention_wgmma"] + 1
    assert KF.LAUNCHES["flash_attention_mma"] == before["flash_attention_mma"]
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    _bf16_close(got, want)


@pytest.mark.cuda
def test_cuda_flash_gradient_recomputes_through_the_plain_version(
        cuda_device):
    from repro_torch.kernels.flash_attention import flash_attention

    gen = torch.Generator(device=cuda_device).manual_seed(3)
    leaves = [torch.randn(s, generator=gen, device=cuda_device,
                          dtype=torch.float64).float().requires_grad_()
              for s in ((1, 4, 40, 16), (1, 2, 40, 16), (1, 2, 40, 16))]
    flash_attention(*leaves, causal=True).square().sum().backward()
    cpu = [t.detach().cpu().requires_grad_() for t in leaves]
    flash_attention(*cpu, causal=True).square().sum().backward()
    for a, b in zip(leaves, cpu):
        np.testing.assert_allclose(convert.to_numpy(a.grad),
                                   b.grad.numpy(), rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
def test_cuda_flash_wrapper_rejects_bad_operands(cuda_device):
    q = torch.zeros((1, 2, 16, 32), device=cuda_device, dtype=torch.bfloat16)
    k = torch.zeros((1, 1, 16, 32), device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="contiguous"):
        KF.flash_attention_cuda(q.transpose(2, 3).contiguous()
                                .transpose(2, 3), k, k)
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        KF.flash_attention_cuda(q.half(), k.half(), k.half())
    with pytest.raises(ValueError, match="head dim"):
        KF.flash_attention_cuda(q[..., :12].contiguous(),
                                k[..., :12].contiguous(),
                                k[..., :12].contiguous())
    big = torch.zeros((1, 2, 4, 264), device=cuda_device)
    with pytest.raises(ValueError, match="head dim"):
        KF.flash_attention_cuda(big, big[:, :1].contiguous(),
                                big[:, :1].contiguous())
    with pytest.raises(ValueError, match="CUDA"):
        KF.flash_attention_cuda(q.cpu(), k.cpu(), k.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n,d,kc,R", [(1 << 16, 4, 4, 8), (1000, 5, 7, 3),
                                      (333, 64, 128, 1), (257, 16, 1, 2)])
def test_cuda_kmeans_assign_matches_plain(cuda_device, dtype, n, d, kc, R):
    from repro_torch.kernels.kmeans_assign import (kmeans_assign,
                                                   kmeans_assign_ref,
                                                   pairwise_sqdist)

    gen = torch.Generator(device=cuda_device).manual_seed(n + d)
    X = torch.randn((n, d), generator=gen, device=cuda_device, dtype=dtype)
    C = torch.randn((R, kc, d), generator=gen, device=cuda_device,
                    dtype=dtype)
    before = KK.LAUNCHES["kmeans_assign"]
    lab, dist = kmeans_assign(X, C)
    want_lab, want_dist = kmeans_assign_ref(X, C)
    torch.cuda.synchronize()
    assert KK.LAUNCHES["kmeans_assign"] == before + 1
    assert lab.dtype == torch.int32 and lab.shape == (R, n)
    # 8 ulps of the largest term the identity cancels
    eps = torch.finfo(dtype).eps
    scale = float((X * X).sum(1).max() + (C * C).sum(-1).max())
    np.testing.assert_allclose(convert.to_numpy(dist),
                               convert.to_numpy(want_dist), rtol=0,
                               atol=8 * eps * scale)
    # labels agree except where the two nearest centroids tie to that
    if kc > 1:
        top2 = pairwise_sqdist(X, C).topk(2, dim=-1, largest=False).values
        tie = (top2[..., 1] - top2[..., 0]) <= 16 * eps * scale
        assert not bool(((lab != want_lab) & ~tie).any())
    lab1, dist1 = kmeans_assign(X, C[0])
    assert torch.equal(lab1, lab[0]) and torch.equal(dist1, dist[0])


@pytest.mark.cuda
def test_cuda_kmeans_assign_rejects_bad_operands(cuda_device):
    X = torch.zeros((10, 4), device=cuda_device)
    with pytest.raises(ValueError, match="at most 128"):
        KK.kmeans_assign_cuda(X, torch.zeros((129, 4), device=cuda_device))
    wide = torch.zeros((10, 65), device=cuda_device)
    with pytest.raises(ValueError, match="at most 64"):
        KK.kmeans_assign_cuda(wide, wide[:2].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        KK.kmeans_assign_cuda(torch.zeros((4, 10), device=cuda_device).T,
                              torch.zeros((2, 4), device=cuda_device))
    with pytest.raises(ValueError, match="CUDA"):
        KK.kmeans_assign_cuda(X.cpu(), torch.zeros((2, 4)))


@pytest.mark.cuda
def test_cuda_pipeline_launches_kmeans_assign_in_stage_3(cuda_device):
    """Both kmeans stages (the p=2 start's and the final discretization)
    assign through the kernel: per stage, k - 1 kmeans++ steps and
    iters + 1 Lloyd assignments."""
    from repro_torch.core.metrics import clustering_accuracy
    from repro_torch.core.psc import PSCConfig, p_spectral_cluster
    from repro_torch.graphs import ring_of_cliques

    W, truth = ring_of_cliques(4, 300, device=cuda_device, build_sellcs=True)
    KK.reset_launch_counts()
    cfg = PSCConfig(k=4, p_target=1.4, newton_iters=10, tcg_iters=8,
                    hvp_mode="matrix_free", backend="sellcs")
    res = p_spectral_cluster(W, cfg)
    assert clustering_accuracy(res.labels, truth, 4) == 1.0
    assert KK.LAUNCHES["kmeans_assign"] == 2 * (cfg.kmeans_iters + 1
                                                + cfg.k - 1)


@pytest.mark.cuda
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_cuda_engine_runs_through_the_flash_kernel(cuda_device,
                                                   compute_dtype):
    """A reduced Gemma-2B served on the card: one flash launch per layer
    per prefill, and the greedy tokens of the CPU engine on the same
    weights (fp32; in bf16, the prefill logits within 2^-6 relative)."""
    import dataclasses

    from repro_torch.configs import get_reduced_config
    from repro_torch.models import model as M
    from repro_torch.serve import GenerationConfig, ServeEngine

    cfg = dataclasses.replace(get_reduced_config("gemma-2b"),
                              compute_dtype=compute_dtype)
    P = M.init_params(cfg, seed=1, device=cuda_device)
    Pc = M.init_params(cfg, seed=1, device="cpu")
    Pc.load_state_dict({k: v.cpu() for k, v in P.state_dict().items()})
    prompts = np.random.default_rng(0).integers(0, cfg.vocab, (3, 150))
    gen = GenerationConfig(max_new_tokens=5)
    KF.reset_launch_counts()
    out = ServeEngine(cfg, P, max_len=160).generate(prompts, gen)
    assert sum(KF.LAUNCHES.values()) == cfg.n_layers
    if compute_dtype == "float32":
        np.testing.assert_array_equal(
            out, ServeEngine(cfg, Pc, max_len=160).generate(prompts, gen))
    else:
        tok = torch.as_tensor(prompts)
        got = M.prefill(cfg, P, tok.to(cuda_device), 160)[0].float().cpu()
        want = M.prefill(cfg, Pc, tok, 160)[0].float()
        assert float((got - want).norm() / want.norm()) <= 2 ** -6
