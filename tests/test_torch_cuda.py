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
    got_h = K.sellcs_plap_hvp(W, U, E, p, eps)
    want_h = K.sellcs_plap_hvp_plain(W, U, E, p, eps)
    torch.cuda.synchronize()
    for got, want in pairs:
        np.testing.assert_allclose(convert.to_numpy(got),
                                   convert.to_numpy(want), **TOL[dtype])
    # eps = 0: phi'(0) = inf on the pads (val 0, e_i - e_j = 0), so NaN
    # in the rows that hold pads, in both versions; eps > 0: finite
    assert bool(torch.isnan(want_h).any()) == (eps == 0.0)
    _assert_matches_plain(got_h, want_h, dtype)
    assert float(pairs[0][0][0].abs().max()) == 0.0     # isolated vertex 0
    assert K.LAUNCHES["sellcs_spmm"] == before["sellcs_spmm"] + 2
    assert K.LAUNCHES["sellcs_plap_apply"] == before["sellcs_plap_apply"] + 1
    assert K.LAUNCHES["sellcs_plap_hvp"] == before["sellcs_plap_hvp"] + 1


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
@pytest.mark.parametrize("dtype,B,Hq,Hkv,S,D,Dv,window", [
    (torch.bfloat16, 1, 4, 4, 300, 192, 128, None),   # MLA: the mma route
    (torch.bfloat16, 2, 6, 1, 200, 128, 64, 50),      # the wgmma route
    (torch.float32, 1, 4, 2, 77, 24, 16, None),       # the fp32 route
])
def test_cuda_flash_takes_a_narrower_value_head_dim(cuda_device, dtype, B,
                                                    Hq, Hkv, S, D, Dv,
                                                    window):
    """v (B, Hkv, S, Dv) with Dv < D: one launch on v padded to D, the
    first Dv columns returned, against fp32 math on the same inputs."""
    from repro_torch.kernels.flash_attention import (attention_ref,
                                                     flash_attention)

    gen = torch.Generator(device=cuda_device).manual_seed(S + Dv)
    q, k, v = (torch.randn(shape, generator=gen, device=cuda_device).to(dtype)
               for shape in ((B, Hq, S, D), (B, Hkv, S, D), (B, Hkv, S, Dv)))
    name = f"flash_attention_{KF.kernel_variant(dtype, D)}"
    before = dict(KF.LAUNCHES)
    got = flash_attention(q, k, v, causal=True, window=window)
    want = attention_ref(q.float(), k.float(), v.float(), causal=True,
                         window=window)
    torch.cuda.synchronize()
    assert {n: c - before[n] for n, c in KF.LAUNCHES.items()} == {
        n: int(n == name) for n in KF.LAUNCHES}
    assert got.dtype == dtype and got.shape == (B, Hq, S, Dv)
    if dtype == torch.float32:
        np.testing.assert_allclose(convert.to_numpy(got),
                                   convert.to_numpy(want), rtol=1e-5,
                                   atol=1e-5)
    else:
        _bf16_close(got, want)
    with pytest.raises(ValueError, match="Dv <= D"):
        flash_attention(q[..., :Dv].contiguous(), k[..., :Dv].contiguous(),
                        torch.cat([v, v], dim=-1))


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
    before = dict(KK.LAUNCHES)
    lab, dist = kmeans_assign(X, C)
    want_lab, want_dist = kmeans_assign_ref(X, C)
    torch.cuda.synchronize()
    _assert_launches_follow_plan(before, R, kc, d, X.element_size())
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


def _assert_launches_follow_plan(before, R, kc, d, itemsize, calls=1):
    """One launch per entry of the plan and call, under its variant's
    counter."""
    plan = KK.launch_plan(R, kc, d, itemsize)
    for variant, name in (("narrow", "kmeans_assign"),
                          ("tiled", "kmeans_assign_tiled")):
        assert KK.LAUNCHES[name] == before[name] + calls * sum(
            v == variant for v, _, _ in plan)


@pytest.mark.cuda
def test_cuda_kmeans_assign_rejects_bad_operands(cuda_device):
    X = torch.zeros((10, 4), device=cuda_device)
    with pytest.raises(ValueError, match="at most 128"):
        KK.kmeans_assign_cuda(X, torch.zeros((129, 4), device=cuda_device))
    wide = torch.zeros((10, 17), device=cuda_device)
    with pytest.raises(ValueError, match="at most 16"):
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


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["mixtral-8x22b", "deepseek-v3-671b"])
def test_cuda_moe_engine_runs_through_the_flash_kernel(cuda_device, arch):
    """A reduced mixtral (window cut to 64, so it masks) and deepseek (MLA,
    a leading dense layer, a shared expert) served on the card in fp32:
    one flash launch per layer per prefill and the greedy tokens of the
    CPU engine on the same weights."""
    import dataclasses

    from repro_torch.configs import get_reduced_config
    from repro_torch.models import model as M
    from repro_torch.serve import GenerationConfig, ServeEngine

    cfg = get_reduced_config(arch)
    if cfg.window:
        cfg = dataclasses.replace(cfg, window=64)
    P = M.init_params(cfg, seed=1, device=cuda_device)
    Pc = M.init_params(cfg, seed=1, device="cpu")
    Pc.load_state_dict({k: v.cpu() for k, v in P.state_dict().items()})
    prompts = np.random.default_rng(0).integers(0, cfg.vocab, (3, 150))
    gen = GenerationConfig(max_new_tokens=5)
    KF.reset_launch_counts()
    out = ServeEngine(cfg, P, max_len=160).generate(prompts, gen)
    assert KF.LAUNCHES["flash_attention_f32"] == cfg.n_layers
    assert sum(KF.LAUNCHES.values()) == cfg.n_layers
    np.testing.assert_array_equal(
        out, ServeEngine(cfg, Pc, max_len=160).generate(prompts, gen))


# ------------------------------------- SELL-C-σ: the redesigned row kernels

def _sell_operands(W, k, seed):
    gen = torch.Generator(device=W.vals.device).manual_seed(seed)
    tdt = W.vals.dtype
    X = torch.randn(W.n_rows, k, generator=gen, device=W.vals.device,
                    dtype=tdt)
    mv = torch.rand(W.nnz, k, generator=gen, device=W.vals.device, dtype=tdt)
    return X, W.with_vals(mv)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("eps", [1e-8, 0.0])
@pytest.mark.parametrize("k", [1, 4, 8, 24, 33])
@pytest.mark.parametrize("C", [8, 32])
def test_cuda_sellcs_row_kernels_match_plain_and_repeat_bitwise(
        cuda_device, dtype, eps, k, C):
    """sellcs_spmm (scalar values and (nnz, k) multivalues) and
    sellcs_plap_apply at compiled widths (4, 8, 24) and through the
    generic variant (1, 33), against their plain versions; two calls equal
    bit for bit; one launch each."""
    coo, shape = _graph(1000)
    W = convert.sparse_matrix(coo, shape, device=cuda_device, dtype=dtype,
                              build_sellcs=True, sell_c=C)
    X, Wh = _sell_operands(W, k, seed=k)
    calls = [(lambda: K.sellcs_spmm(W, X), K.sellcs_spmm_plain(W, X),
              "sellcs_spmm"),
             (lambda: K.sellcs_spmm(Wh, X), K.sellcs_spmm_plain(Wh, X),
              "sellcs_spmm"),
             (lambda: K.sellcs_plap_apply(W, X, 1.2, eps),
              K.sellcs_plap_apply_plain(W, X, 1.2, eps), "sellcs_plap_apply")]
    for call, want, name in calls:
        before = K.LAUNCHES[name]
        got = call()
        again = call()
        torch.cuda.synchronize()
        assert K.LAUNCHES[name] == before + 2
        assert torch.equal(got, again)
        np.testing.assert_allclose(convert.to_numpy(got),
                                   convert.to_numpy(want), **TOL[dtype])
    # the isolated vertex 0 has only pads: exactly 0
    assert float(calls[0][0]()[0].abs().max()) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("k", [4, 8, 24])
def test_cuda_sellcs_misaligned_operands_take_the_generic_variant(
        cuda_device, dtype, k):
    """A contiguous multivector that does not start on a 16-byte boundary
    runs the generic variant and matches the plain version."""
    coo, shape = _graph(500)
    W = convert.sparse_matrix(coo, shape, device=cuda_device, dtype=dtype,
                              build_sellcs=True, sell_c=32)
    X, _ = _sell_operands(W, k, seed=1)
    buf = torch.empty(X.numel() + 1, dtype=X.dtype, device=cuda_device)
    Xm = buf[1:].view(X.shape)
    Xm.copy_(X)
    assert Xm.is_contiguous() and Xm.data_ptr() % 16 != 0
    assert K.launch_plan("sellcs_spmm", W.n_rows, k, X.dtype,
                         aligned=False).variant == "row_generic"
    for got, want in ((K.sellcs_spmm(W, Xm), K.sellcs_spmm_plain(W, X)),
                      (K.sellcs_plap_apply(W, Xm, 1.5, 1e-8),
                       K.sellcs_plap_apply_plain(W, X, 1.5, 1e-8))):
        np.testing.assert_allclose(convert.to_numpy(got),
                                   convert.to_numpy(want), **TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("C", [8, 32])
@pytest.mark.parametrize("value", [np.nan, np.inf])
def test_cuda_sellcs_nonfinite_lands_where_plain(cuda_device, dtype, C,
                                                 value):
    """A NaN or inf in one row of X: NaN and inf exactly where the plain
    versions put them (the row's neighbours; its own row where a pad or
    phi meets it), the rest within the tolerance."""
    coo, shape = _graph(1000)
    W = convert.sparse_matrix(coo, shape, device=cuda_device, dtype=dtype,
                              build_sellcs=True, sell_c=C)
    X, Wh = _sell_operands(W, 4, seed=2)
    X[1, 1] = float(value)     # vertex 1 is a hub
    for got, want in ((K.sellcs_spmm(W, X), K.sellcs_spmm_plain(W, X)),
                      (K.sellcs_spmm(Wh, X), K.sellcs_spmm_plain(Wh, X)),
                      (K.sellcs_plap_apply(W, X, 1.2, 1e-8),
                       K.sellcs_plap_apply_plain(W, X, 1.2, 1e-8))):
        assert not bool(torch.isfinite(want).all())
        _assert_matches_plain(got, want, dtype)
        np.testing.assert_array_equal(convert.to_numpy(torch.isinf(got)),
                                      convert.to_numpy(torch.isinf(want)))


# --------------------------------------------- kmeans: the tiled variant

@pytest.mark.cuda
@pytest.mark.parametrize("dtype,n,d,kc,R", [
    (torch.float32, 3000, 70, 70, 8),      # stage 3 at k = 70
    (torch.float64, 3000, 48, 48, 8),      # stage 3 at k = 48: 7 + 1
    (torch.float32, 1000, 70, 1, 8),       # kmeans++'s first step at k = 70
    (torch.float32, 500, 100, 3, 2),
    (torch.float64, 333, 4, 200, 1),       # more than 128 centroids
    (torch.float32, 257, 65, 129, 3),
    (torch.float64, 129, 33, 31, 2),
])
def test_cuda_kmeans_planned_launches_match_plain(cuda_device, dtype, n, d,
                                                  kc, R):
    """Every launch of the plan, narrow or tiled, against the plain
    version: distances to 8 ulps of the largest term their identity
    cancels, labels equal except at ties to 16."""
    from repro_torch.kernels.kmeans_assign import (kmeans_assign,
                                                   kmeans_assign_ref,
                                                   pairwise_sqdist)

    gen = torch.Generator(device=cuda_device).manual_seed(n + d)
    X = torch.randn((n, d), generator=gen, device=cuda_device, dtype=dtype)
    C = torch.randn((R, kc, d), generator=gen, device=cuda_device,
                    dtype=dtype)
    before = dict(KK.LAUNCHES)
    lab, dist = kmeans_assign(X, C)
    want_lab, want_dist = kmeans_assign_ref(X, C)
    torch.cuda.synchronize()
    _assert_launches_follow_plan(before, R, kc, d, X.element_size())
    eps = torch.finfo(dtype).eps
    scale = float((X * X).sum(1).max() + (C * C).sum(-1).max())
    np.testing.assert_allclose(convert.to_numpy(dist),
                               convert.to_numpy(want_dist), rtol=0,
                               atol=8 * eps * scale)
    if kc > 1:
        top2 = pairwise_sqdist(X, C).topk(2, dim=-1, largest=False).values
        tie = (top2[..., 1] - top2[..., 0]) <= 16 * eps * scale
        assert not bool(((lab != want_lab) & ~tie).any())


@pytest.mark.cuda
def test_cuda_kmeans_tiled_variant_agrees_with_narrow(cuda_device):
    """On a shape both take, the narrow and the tiled variant in fp32
    add the same products in the same order: the same labels, distances
    within 2 ulps of the largest term (the compiler may contract the last
    step differently)."""
    gen = torch.Generator(device=cuda_device).manual_seed(7)
    X = torch.randn((2000, 16), generator=gen, device=cuda_device)
    C = torch.randn((4, 40, 16), generator=gen, device=cuda_device)
    lab_n, dist_n = KK.kmeans_assign_cuda(X, C)
    lab_w, dist_w = KK.kmeans_assign_tiled_cuda(X, C)
    torch.cuda.synchronize()
    assert torch.equal(lab_n, lab_w)
    scale = float((X * X).sum(1).max() + (C * C).sum(-1).max())
    assert float((dist_n - dist_w).abs().max()) <= \
        2 * torch.finfo(torch.float32).eps * scale


@pytest.mark.cuda
@pytest.mark.parametrize("k,dtype", [(70, torch.float32),
                                     (48, torch.float64)])
def test_cuda_stage3_at_large_k_runs_through_the_kernels(cuda_device, k,
                                                         dtype):
    """Stage 3 (kmeans++ and Lloyd over 8 restarts) at k = 70 fp32 and
    k = 48 fp64 on the card: every assignment through the kernels, and
    Lloyd from one C0 gives the labels of Lloyd through the plain
    assignment, on well-separated points."""
    from unittest import mock

    from repro_torch.core import kmeans as KM
    from repro_torch.core import psc
    from repro_torch.kernels.kmeans_assign import kmeans_assign_ref

    rng = np.random.default_rng(k)
    centers = rng.standard_normal((k, k))
    X = centers[rng.integers(0, k, 20000)] + 0.05 * rng.standard_normal(
        (20000, k))
    U = torch.as_tensor(X, dtype=dtype, device=cuda_device)
    KK.reset_launch_counts()
    labels = psc.discretize(U, k, torch.Generator(device=cuda_device)
                            .manual_seed(0))
    assert labels.shape == (20000,) and int(labels.max()) < k
    assert KK.LAUNCHES["kmeans_assign_tiled"] >= (k - 1) + 51
    assert KK.LAUNCHES["kmeans_assign"] == 0
    # every restart starts next to the k centres: no point near a tie
    C0 = torch.as_tensor(centers[None] + 0.01 * rng.standard_normal(
        (8, k, k)), dtype=dtype, device=cuda_device)
    got, _, _ = KM.lloyd(U, C0, iters=10)
    with mock.patch.object(KM, "kmeans_assign", kmeans_assign_ref):
        want, _, _ = KM.lloyd(U, C0, iters=10)
    assert torch.equal(got, want)


# ------------------------------------- BSR tiles above the kernels' limit

@pytest.mark.cuda
def test_cuda_bsr_block_256_goes_through_auto_to_coo(cuda_device):
    from repro_torch.grblas import (BackendUnavailableError, Descriptor, mxm,
                                    plap_edge_semiring, reals_ring)
    from repro_torch.grblas import backends as BE

    coo, shape = _graph(1000)
    W = convert.sparse_matrix(coo, shape, device=cuda_device,
                              dtype=np.float32, build_ell=False,
                              build_sellcs=False, build_bsr=True,
                              block_size=256)
    X = torch.randn(shape[0], 4, device=cuda_device)
    assert BE.select_backend(W, X, reals_ring, Descriptor()).name == "coo"
    np.testing.assert_allclose(convert.to_numpy(mxm(W, X)),
                               convert.to_numpy(KB.bsr_spmm_plain(W, X)),
                               **TOL[np.float32])
    ring = plap_edge_semiring(1.5, 1e-8)
    np.testing.assert_allclose(
        convert.to_numpy(mxm(W, X, ring)),
        convert.to_numpy(KP.plap_apply_plain(W, X, 1.5, 1e-8)),
        **TOL[np.float32])
    with pytest.raises(BackendUnavailableError):
        mxm(W, X, desc=Descriptor(backend="bsr_pallas"))
    with pytest.raises(BackendUnavailableError):
        mxm(W, X, ring, desc=Descriptor(backend="edge_pallas"))


@pytest.mark.cuda
def test_cuda_bsr_solve_at_block_256(cuda_device):
    """A graph built with BSR at block_size 256 and COO only: the auto
    solve runs on coo and clusters it; naming edge_pallas raises before
    any work."""
    from repro_torch.core.metrics import clustering_accuracy
    from repro_torch.core.psc import PSCConfig, p_spectral_cluster
    from repro_torch.graphs import ring_of_cliques
    from repro_torch.grblas import BackendUnavailableError

    W, truth = ring_of_cliques(4, 300, device=cuda_device, build_bsr=True,
                               block_size=256, build_ell=False,
                               build_sellcs=False)
    KB.reset_launch_counts()
    KP.reset_launch_counts()
    res = p_spectral_cluster(W, PSCConfig(k=4, p_target=1.4, newton_iters=10,
                                          tcg_iters=8))
    assert clustering_accuracy(res.labels, truth, 4) == 1.0
    assert sum(KB.LAUNCHES.values()) == 0 and sum(KP.LAUNCHES.values()) == 0
    with pytest.raises(BackendUnavailableError):
        p_spectral_cluster(W, PSCConfig(k=4, backend="edge_pallas"))


# --------------------------------------------- fixed-order float sums

KS = importlib.import_module("repro_torch.kernels.segment_sum.segment_sum")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("transpose", [False, True])
def test_cuda_coo_sum_repeats_bitwise_and_equals_cpu(cuda_device, dtype,
                                                     transpose):
    """The COO backend's reals SpMM with (nnz, 4) multivalues, twice:
    equal bit for bit, and to the CPU's sequential index_add_."""
    from repro_torch.grblas import Descriptor, mxm

    coo, shape = _graph(3000)
    W = convert.sparse_matrix(coo, shape, device=cuda_device, dtype=dtype)
    X, Wh = _sell_operands(W, 4, seed=3)
    desc = Descriptor(backend="coo", transpose=transpose)
    before = KS.LAUNCHES["segment_sum"]
    got = mxm(Wh, X, desc=desc)
    again = mxm(Wh, X, desc=desc)
    torch.cuda.synchronize()
    assert KS.LAUNCHES["segment_sum"] == before + 2
    assert torch.equal(got, again)
    Wc = convert.sparse_matrix(coo, shape, device="cpu", dtype=dtype)
    Wc = Wc.with_vals(Wh.vals.cpu())
    np.testing.assert_array_equal(convert.to_numpy(got),
                                  convert.to_numpy(mxm(Wc, X.cpu(),
                                                       desc=desc)))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_cuda_row_sums_repeat_bitwise_and_equal_cpu(cuda_device, dtype):
    coo, shape = _graph(3000)
    W = convert.sparse_matrix(coo, shape, device=cuda_device, dtype=dtype)
    d1, d2 = W.row_sums(), W.row_sums()
    torch.cuda.synchronize()
    assert torch.equal(d1, d2)
    Wc = convert.sparse_matrix(coo, shape, device="cpu", dtype=dtype)
    np.testing.assert_array_equal(convert.to_numpy(d1),
                                  convert.to_numpy(Wc.row_sums()))


@pytest.mark.cuda
@pytest.mark.parametrize("sorted_ids", [True, False])
@pytest.mark.parametrize("shape", [(5000,), (5000, 3)])
def test_cuda_segment_sum_equals_index_add_on_cpu(cuda_device, sorted_ids,
                                                  shape):
    rng = np.random.default_rng(8)
    ids = rng.integers(0, 700, 5000)
    if sorted_ids:
        ids = np.sort(ids)
    vals = rng.standard_normal(shape) * 10.0 ** rng.uniform(-4, 4, shape)
    V = torch.as_tensor(vals, dtype=torch.float32)
    I = torch.as_tensor(ids)
    I_dev = I.to(cuda_device)
    ptr = KS.csr_pointers(I_dev, 703) if sorted_ids else None
    got = KS.segment_sum(V.to(cuda_device), I_dev, 703, ptr)
    want = torch.zeros((703,) + shape[1:]).index_add_(0, I, V)
    np.testing.assert_array_equal(convert.to_numpy(got),
                                  convert.to_numpy(want))


# ------------------------------------ SELL-C-σ: the HVP on the row kernel

def _misaligned(X):
    """A contiguous copy of X that starts off a 16-byte boundary."""
    buf = torch.empty(X.numel() + 1, dtype=X.dtype, device=X.device)
    Xm = buf[1:].view(X.shape)
    Xm.copy_(X)
    assert Xm.is_contiguous() and Xm.data_ptr() % 16 != 0
    return Xm


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("k", [4, 8, 16, 24, 5])
@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("C", [8, 32])
def test_cuda_sellcs_hvp_row_kernel_matches_plain_and_repeats_bitwise(
        cuda_device, dtype, k, aligned, C):
    """sellcs_plap_hvp on the row kernel at the compiled widths (4, 8, 16,
    24) and through the generic variant (k = 5, and misaligned operands),
    against its plain version; two calls equal bit for bit; one launch
    each."""
    coo, shape = _graph(1000)
    W = convert.sparse_matrix(coo, shape, device=cuda_device, dtype=dtype,
                              build_sellcs=True, sell_c=C)
    gen = torch.Generator(device=cuda_device).manual_seed(k)
    U = torch.randn(W.n_rows, k, generator=gen, device=cuda_device,
                    dtype=W.vals.dtype)
    E = torch.randn(W.n_rows, k, generator=gen, device=cuda_device,
                    dtype=W.vals.dtype)
    if not aligned:
        U, E = _misaligned(U), _misaligned(E)
    plan = K.launch_plan("sellcs_plap_hvp", W.n_rows, k, U.dtype, aligned)
    assert plan.variant == ("row" if aligned and k != 5 else "row_generic")
    before = K.LAUNCHES["sellcs_plap_hvp"]
    got = K.sellcs_plap_hvp(W, U, E, 1.2, 1e-8)
    again = K.sellcs_plap_hvp(W, U, E, 1.2, 1e-8)
    torch.cuda.synchronize()
    assert K.LAUNCHES["sellcs_plap_hvp"] == before + 2
    assert torch.equal(got, again)
    want = K.sellcs_plap_hvp_plain(W, U, E, 1.2, 1e-8)
    np.testing.assert_allclose(convert.to_numpy(got), convert.to_numpy(want),
                               **TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("where", ["U", "E"])
@pytest.mark.parametrize("value", [np.nan, np.inf])
def test_cuda_sellcs_hvp_nonfinite_lands_where_plain(cuda_device, dtype,
                                                     where, value):
    """A NaN or inf in one row of U or of E (the hub, vertex 1): NaN and
    inf exactly where the plain version puts them, the rest within the
    tolerance."""
    coo, shape = _graph(1000)
    W = convert.sparse_matrix(coo, shape, device=cuda_device, dtype=dtype,
                              build_sellcs=True, sell_c=32)
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    U = torch.randn(W.n_rows, 4, generator=gen, device=cuda_device,
                    dtype=W.vals.dtype)
    E = torch.randn(W.n_rows, 4, generator=gen, device=cuda_device,
                    dtype=W.vals.dtype)
    (U if where == "U" else E)[1, 2] = float(value)
    got = K.sellcs_plap_hvp(W, U, E, 1.2, 1e-8)
    want = K.sellcs_plap_hvp_plain(W, U, E, 1.2, 1e-8)
    assert not bool(torch.isfinite(want).all())
    _assert_matches_plain(got, want, dtype)
    np.testing.assert_array_equal(convert.to_numpy(torch.isinf(got)),
                                  convert.to_numpy(torch.isinf(want)))


# ---------------------------- kmeans: the redesigned narrow and tiled kernels

def _kmeans_inputs(device, dtype, n, d, kc, R, seed):
    gen = torch.Generator(device=device).manual_seed(seed)
    X = torch.randn((n, d), generator=gen, device=device, dtype=dtype)
    X /= torch.linalg.norm(X, dim=1, keepdim=True)
    C = X[torch.randint(0, n, (R, kc), generator=gen, device=device)]
    return X, (C + 0.01 * torch.randn(C.shape, generator=gen, device=device,
                                      dtype=dtype)).contiguous()


def _assert_kmeans_matches_plain(X, C, lab, dist):
    from repro_torch.kernels.kmeans_assign import (kmeans_assign_ref,
                                                   pairwise_sqdist)

    want_lab, want_dist = kmeans_assign_ref(X, C)
    eps = torch.finfo(X.dtype).eps
    scale = float((X * X).sum(1).max() + (C * C).sum(-1).max())
    np.testing.assert_allclose(convert.to_numpy(dist),
                               convert.to_numpy(want_dist), rtol=0,
                               atol=8 * eps * scale)
    top2 = pairwise_sqdist(X, C).topk(2, dim=-1, largest=False).values
    tie = (top2[..., 1] - top2[..., 0]) <= 16 * eps * scale
    assert not bool(((lab != want_lab) & ~tie).any())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,n,d,kc,R,variant", [
    (torch.float32, 1 << 20, 4, 4, 8, "narrow"),    # the main path
    (torch.float64, 5000, 48, 48, 8, "tiled"),      # stage 3 at k = 48
    (torch.float32, 5000, 70, 70, 8, "tiled"),      # stage 3 at k = 70
    (torch.float32, 3001, 16, 16, 8, "narrow"),     # the widest narrow row
    (torch.float32, 3001, 17, 16, 8, "tiled"),      # one dimension more
    (torch.float64, 3001, 4, 128, 2, "narrow"),     # the most narrow centroids
    (torch.float64, 3001, 4, 129, 2, "tiled"),      # one more
    (torch.float32, 999, 3, 5, 3, "narrow"),        # d, n off the vector loads
    (torch.float64, 999, 130, 9, 3, "tiled"),       # d beyond the resident X
    (torch.float32, 777, 200, 3, 2, "tiled"),       # ... in fp32 too
    (torch.float64, 3001, 16, 128, 13, "narrow"),   # 13 sets fit at once
    (torch.float64, 3001, 16, 128, 14, "narrow"),   # 14 are split 13 + 1
    (torch.float64, 3001, 17, 5, 3, "tiled"),       # DMMA, a partial step
    (torch.float64, 999, 130, 70, 2, "tiled"),      # ... over X in chunks
])
def test_cuda_kmeans_routes_match_plain_and_repeat_bitwise(
        cuda_device, dtype, n, d, kc, R, variant):
    """The main path's shape, stage 3's at k = 48 fp64 and k = 70 fp32 (a
    smaller n), and each routing boundary taken both ways: the plan's
    variant launches, distances to 8 ulps of the largest term, labels off
    ties equal, two calls bit for bit."""
    from repro_torch.kernels.kmeans_assign import kmeans_assign

    X, C = _kmeans_inputs(cuda_device, dtype, n, d, kc, R, seed=d + kc)
    assert {v for v, _, _ in KK.launch_plan(R, kc, d, X.element_size())} \
        == {variant}
    before = dict(KK.LAUNCHES)
    lab, dist = kmeans_assign(X, C)
    lab2, dist2 = kmeans_assign(X, C)
    torch.cuda.synchronize()
    _assert_launches_follow_plan(before, R, kc, d, X.element_size(), 2)
    assert torch.equal(lab, lab2) and torch.equal(dist, dist2)
    _assert_kmeans_matches_plain(X, C, lab, dist)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,d,kc", [(torch.float32, 4, 4),
                                        (torch.float64, 16, 40),
                                        (torch.float64, 48, 48),
                                        (torch.float32, 70, 70)])
def test_cuda_kmeans_set_alone_equals_batched(cuda_device, dtype, d, kc):
    """A set taken alone, and any group of sets, gives the batched
    result bit for bit: a set's result depends neither on R nor on the
    grouping (the tiled variant's tiles straddle the sets differently)."""
    from repro_torch.kernels.kmeans_assign import kmeans_assign

    X, C = _kmeans_inputs(cuda_device, dtype, 2000, d, kc, 8, seed=11)
    lab, dist = kmeans_assign(X, C)
    for r in range(8):
        lab1, dist1 = kmeans_assign(X, C[r])
        assert torch.equal(lab1, lab[r]) and torch.equal(dist1, dist[r])
    lab3, dist3 = kmeans_assign(X, C[2:5])
    assert torch.equal(lab3, lab[2:5]) and torch.equal(dist3, dist[2:5])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,d,kc", [(torch.float32, 4, 4),
                                        (torch.float64, 16, 40),
                                        (torch.float64, 48, 48),
                                        (torch.float32, 70, 70)])
def test_cuda_kmeans_ties_go_to_the_lowest_index_and_nan_rows(cuda_device,
                                                              dtype, d, kc):
    """Centroid kc - 1 repeats centroid 1 (and, in the tiled variant,
    lies in another thread's columns and tile): it never wins.  A row of
    X with a NaN gives NaN distances in every set, as the plain version
    does, and label 0 (the first distance is NaN and sticks)."""
    from repro_torch.kernels.kmeans_assign import (kmeans_assign,
                                                   kmeans_assign_ref)

    X, C = _kmeans_inputs(cuda_device, dtype, 3000, d, kc, 4, seed=12)
    C[:, kc - 1] = C[:, 1]
    X[7, d // 2] = float("nan")
    lab, dist = kmeans_assign(X, C)
    want_lab, want_dist = kmeans_assign_ref(X, C)
    torch.cuda.synchronize()
    assert bool(torch.isnan(dist[:, 7]).all())
    assert bool(torch.isnan(want_dist[:, 7]).all())
    assert bool((lab[:, 7] == 0).all())
    assert not bool((lab == kc - 1).any())
    assert bool((lab == 1).any())
    keep = torch.ones(X.shape[0], dtype=torch.bool, device=cuda_device)
    keep[7] = False
    _assert_kmeans_matches_plain(X[keep], C, lab[:, keep], dist[:, keep])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("case", ["big 0.5", "big 1", "big 2", "big 4",
                                  "eps 1e-30"])
def test_cuda_sellcs_hvp_near_overflow_lands_where_plain(cuda_device, dtype,
                                                         case):
    """The HVP row kernel against its plain version where phi' and the
    differences overflow: inputs of scale x
    OVERFLOW_AT at every seventh vertex of U and E (d^2 overflows from
    2), and, in fp32, eps = 1e-30, where eps^((p-4)/2) overflows at the
    pads and at repeated values of U: inf and NaN where the plain version
    puts them, the rest within the tolerance."""
    coo, shape = _graph(1000)
    W = convert.sparse_matrix(coo, shape, device=cuda_device, dtype=dtype,
                              build_sellcs=True, sell_c=32)
    gen = torch.Generator(device=cuda_device).manual_seed(9)
    U = torch.randn(W.n_rows, 4, generator=gen, device=cuda_device,
                    dtype=W.vals.dtype)
    E = torch.randn(W.n_rows, 4, generator=gen, device=cuda_device,
                    dtype=W.vals.dtype)
    eps = 1e-8
    if case.startswith("big"):
        big = float(case.split()[1]) * KP.OVERFLOW_AT[U.dtype]
        signs = torch.ones(U[::7].shape[0], device=cuda_device,
                           dtype=U.dtype)
        signs[1::2] = -1.0
        U[::7, 0] = big * signs
        E[::7, 2] = big * signs
    else:
        eps = 1e-30
        U[1::5] = U[0::5][:U[1::5].shape[0]]     # u_j = u_i off the diagonal
    got = K.sellcs_plap_hvp(W, U, E, 1.2, eps)
    want = K.sellcs_plap_hvp_plain(W, U, E, 1.2, eps)
    if case in ("big 4", "eps 1e-30") and dtype == np.float32:
        assert not bool(torch.isfinite(want).all())
    _assert_matches_plain(got, want, dtype)
    np.testing.assert_array_equal(convert.to_numpy(torch.isinf(got)),
                                  convert.to_numpy(torch.isinf(want)))


# ------------------------------------------- resilience and telemetry paths

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("p,eps", [(1.2, 1e-8), (1.0, 1e-8), (2.0, 0.0)])
def test_cuda_apply_k1_matches_plain(cuda_device, dtype, p, eps):
    """The p-Laplacian apply at k = 1 (the inverse-power driver's one
    column; the generic variant) against its plain version, twice equal
    bit for bit, counted under k = 1."""
    coo, shape = _graph(1000)
    W = convert.sparse_matrix(coo, shape, device=cuda_device, dtype=dtype,
                              build_sellcs=True, sell_c=32)
    gen = torch.Generator(device=cuda_device).manual_seed(11)
    u = torch.randn(W.n_rows, 1, generator=gen, device=cuda_device,
                    dtype=W.vals.dtype)
    assert K.launch_plan("sellcs_plap_apply", W.n_rows, 1,
                         u.dtype).variant == "row_generic"
    K.reset_launch_counts()
    got = K.sellcs_plap_apply(W, u, p, eps)
    assert K.APPLY_LAUNCHES_BY_K == {1: 1}
    assert torch.equal(got, K.sellcs_plap_apply(W, u, p, eps))
    np.testing.assert_allclose(
        convert.to_numpy(got),
        convert.to_numpy(K.sellcs_plap_apply_plain(W, u, p, eps)),
        **TOL[dtype])


@pytest.mark.cuda
def test_cuda_guarded_backend_fault_falls_back_to_coo(cuda_device):
    """A guarded solve with the sellcs backend down ends on the
    backend_fallback rung: the coo backend through segment_sum, and the
    backend registry is restored afterwards."""
    from repro_torch.core.psc import PSCConfig, p_spectral_cluster
    from repro_torch.graphs import sbm_graph
    from repro_torch.grblas import backends
    from repro_torch.kernels import segment_sum as KS
    from repro_torch.testing import backend_fault

    W, _ = sbm_graph([30] * 4, 0.92, 0.03, seed=0, device=cuda_device,
                     build_sellcs=True)
    cfg = PSCConfig(k=4, newton_iters=8, tcg_iters=5, p_target=1.5,
                    p_factor=0.85, guard=True, backend="sellcs")
    clean = p_spectral_cluster(W, cfg)
    orig = backends.registered_backends()["sellcs"]
    KS.reset_launch_counts()
    with backend_fault("sellcs") as log:
        res = p_spectral_cluster(W, cfg)
    assert log.count("backend_fault") >= 1
    assert res.recovery.final_rung == "backend_fallback"
    assert res.recovery.rungs[-1].backend == "coo"
    assert not res.recovery.degraded
    assert KS.LAUNCHES["segment_sum"] > 1
    assert np.isfinite(res.rcut) and res.rcut <= clean.rcut * 1.10 + 1e-9
    assert backends.registered_backends()["sellcs"] is orig
    assert p_spectral_cluster(W, cfg).recovery.clean


@pytest.mark.cuda
def test_cuda_boolean_ring_components_match_cpu(cuda_device):
    """The BFS's boolean products (a scatter-max over int32) on the card
    label the components as on the CPU, twice bit for bit."""
    from repro_torch.graphs import connected_components

    coo, shape = _graph(1000)
    labels = {}
    for dev in ("cpu", cuda_device):
        W = convert.sparse_matrix(coo, shape, device=dev, dtype=np.float32)
        comps = connected_components(W)
        labels[str(dev)] = comps.labels
        np.testing.assert_array_equal(comps.labels,
                                      connected_components(W).labels)
    np.testing.assert_array_equal(labels["cpu"], labels[str(cuda_device)])


@pytest.mark.cuda
@pytest.mark.parametrize("solver", ["newton", "scf"])
def test_cuda_bucket_batch_matches_flat_and_repeats_bitwise(cuda_device,
                                                            solver):
    """One bucket batch of the clustering serve engine on the card: the
    block-diagonal COO sums through segment_sum, stage 3 through
    kmeans_assign, each request's labels equal the flat pipeline's on
    the card, pad rows of the built solve are exactly zero and two calls
    of it equal bit for bit."""
    from repro_torch.core.psc import PSCConfig, p_spectral_cluster
    from repro_torch.graphs import sbm_graph
    from repro_torch.kernels import kmeans_assign as KK
    from repro_torch.kernels import segment_sum as KS
    from repro_torch.serve import ClusterServeEngine, assemble_batch
    from repro_torch.serve import psc_engine

    cfg = PSCConfig(k=4, newton_iters=10, tcg_iters=6, kmeans_restarts=4,
                    solver=solver)
    graphs = [sbm_graph([25 + s, 25, 25, 25], 0.5, 0.02, seed=s,
                        device=cuda_device)[0] for s in range(3)]
    KS.reset_launch_counts()
    KK.reset_launch_counts()
    eng = ClusterServeEngine(cfg, max_batch=4)
    out = eng.serve(graphs)
    assert KS.LAUNCHES["segment_sum"] > 0
    assert KK.LAUNCHES["kmeans_assign"] > 0
    assert eng.stats.n_batches == 1 and eng.stats.n_failed == 0
    for W, res in zip(graphs, out):
        assert res.ok and res.stats.lane == "bucket"
        assert res.U.device.type == "cuda"
        np.testing.assert_array_equal(res.labels,
                                      p_spectral_cluster(W, cfg).labels)
    spec = out[0].stats.bucket
    solve, _ = psc_engine._bucket_solver(psc_engine.BucketSpec(*spec[2:],
                                                               spec[1]), cfg)
    batch = assemble_batch(graphs, solve.spec)
    args = [torch.as_tensor(a, device=cuda_device)
            for a in (batch.rows, batch.cols, batch.vals, batch.mask)]
    U1, f1 = solve(*args)
    U2, f2 = solve(*args)
    assert torch.equal(U1, U2) and torch.equal(f1, f2)
    for b, n in enumerate(batch.n_real):
        assert bool((U1[b, n:] == 0.0).all())


@pytest.mark.cuda
def test_cuda_kernel_error_leaves_the_serve_engine(cuda_device, monkeypatch):
    """A failed kernel launch on the bucket lane reaches the caller as the
    kernel layer's exception; no request is quarantined."""
    from repro_torch.core.psc import PSCConfig
    from repro_torch.graphs import sbm_graph
    from repro_torch.kernels.nvcc import KernelError
    from repro_torch.serve import ClusterServeEngine

    KS = importlib.import_module("repro_torch.kernels.segment_sum."
                                 "segment_sum")

    def broken(*a, **k):
        raise KernelError("segment_sum: CUDA error 700 (injected)")

    monkeypatch.setattr(KS.LIBRARY, "load", broken)
    eng = ClusterServeEngine(PSCConfig(k=4, newton_iters=4, tcg_iters=2))
    eng.submit(sbm_graph([20] * 4, 0.5, 0.02, seed=0,
                         device=cuda_device)[0])
    with pytest.raises(KernelError, match="injected"):
        eng.flush()
    assert eng.stats.n_failed == 0


def _shard_operands(case, C, dtype, k, device):
    """Rank d's SELL-C-σ shard of a 3-shard partition of ``_graph(1000)``
    and its x_src, built by hand: under a halo plan the extended-local
    vector (own rows, then at R + s*H + h row send[s, d*H + h] of shard
    s), under a gather plan the whole vector with own rows at d*R.  R =
    334 is not a multiple of C, so the last slice is partial."""
    from repro_torch.grblas import make_row_partition

    coo, shape = _graph(1000)
    W = convert.sparse_matrix(coo, shape, device="cpu", dtype=dtype,
                              build_ell=True)
    S, d = 3, 1
    Ap = make_row_partition(W, S, mode="halo" if case != "gather" else
                            "gather", sellcs=True, sell_c=C)
    R, H = Ap.rows_per_shard, Ap.halo_width
    assert R % C != 0
    x = np.random.default_rng(k).standard_normal((S * R, k)).astype(dtype)
    x[shape[0]:] = 0.0
    if case == "gather":
        x_src, row0 = x, d * R
    else:
        send = Ap.send_idx
        x_src = np.concatenate([x[d * R:(d + 1) * R]] + [
            x[s * R + send[s, d * H:(d + 1) * H]] for s in range(S)])
        row0 = 0
    sell = Ap.sell
    sh = K.shard_layout([c[d] for c in sell.run_cols],
                        [v[d] for v in sell.run_vals],
                        [o[d] for o in sell.run_own], sell.inv[d], C, row0,
                        device)
    return sh, torch.as_tensor(x_src, device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("C", [8, 32])
@pytest.mark.parametrize("k", [1, 4, 8, 24, 5])
@pytest.mark.parametrize("case", ["halo", "gather"])
def test_cuda_shard_launch_matches_twin(cuda_device, case, k, C, dtype):
    """The shard launches of the SELL-C-σ reals and apply kernels
    against their plain versions on the same CUDA tensors.  "halo": the
    pad rows of the partial last slice (own = 0, val = 0) are not
    launched, or they would overwrite local row 0; "gather": x_i is read
    at d*R + own and the result taken from there."""
    sh, xs = _shard_operands(case, C, dtype, k, cuda_device)
    tol = TOL[dtype]
    K.reset_launch_counts()
    got = K.sellcs_shard_spmm(sh, xs)
    want = K.sellcs_shard_spmm_plain(sh, xs)
    assert got.shape == (sh.n, k) and bool(want[0].abs().sum() > 0)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), **tol)
    got = K.sellcs_shard_plap_apply(sh, xs, 1.5, 1e-8)
    want = K.sellcs_shard_plap_apply_plain(sh, xs, 1.5, 1e-8)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), **tol)
    assert K.SHARD_LAUNCHES == {f"sellcs_shard_spmm k={k}": 1,
                                f"sellcs_shard_plap_apply k={k}": 1}
    assert K.LAUNCHES["sellcs_spmm"] == 0


@pytest.mark.cuda
def test_cuda_shard_launch_rejects_bad_operands(cuda_device):
    sh, xs = _shard_operands("halo", 8, np.float32, 4, cuda_device)
    short = xs[:sh.x_rows - 1]      # misses the largest column id
    for bad in (short, xs.double(), xs.T.contiguous().T, xs.cpu()):
        with pytest.raises((TypeError, ValueError)):
            K.sellcs_shard_spmm(sh, bad)
