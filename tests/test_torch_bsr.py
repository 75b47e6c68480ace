"""The port's BSR path against the reference, on the CPU: the layout, the
RCM / degree reorderings, the twins of the three BSR kernels, the
``bsr_pallas`` / ``edge_pallas`` / ``spgemm`` backends and their place in
the auto order, and a flat ``edge_pallas`` solve after ``reorder="rcm"``.

Tolerances:
  * layout arrays, permutations and bandwidths: exact;
  * twins against the reference's Pallas kernels (interpret mode) and its
    ref.py oracles: fp32 rtol 2e-4 / atol 2e-5 (the bounds of
    tests/test_kernels_sparse.py: sums in another order, pow by another
    library), fp64 1e-12;
  * backends against the port's own ``coo`` backend: fp64 1e-11;
  * the solve: accuracy on the planted partition, RCut at most 1.05 x the
    reference's on the same graph, and U^T U within 1e-4 of I (jax.random
    and torch.Generator streams differ, so runs are held by quality).
"""
import functools

import numpy as np
import pytest
import scipy.sparse as sp

torch = pytest.importorskip("torch")  # the reference-only CI has no torch

import jax.numpy as jnp
from repro.core import PSCConfig as RefConfig
from repro.core import p_spectral_cluster as ref_cluster
from repro.graphs import delaunay_graph, sbm_graph
from repro.graphs.reorder import bandwidth as ref_bandwidth
from repro.graphs.reorder import reorder as ref_reorder
from repro.grblas import SparseMatrix as RefMatrix
from repro.grblas import api as ref_api
from repro.kernels.bsr_spmm import bsr_spmm_pallas, bsr_spmm_ref
from repro.kernels.plap_edge import (plap_apply_pallas, plap_apply_ref,
                                     plap_hvp_edge_ref, plap_hvp_pallas)
from repro_torch import convert
from repro_torch.core import metrics
from repro_torch.core.psc import PSCConfig, p_spectral_cluster
from repro_torch.graphs import bandwidth, reorder
from repro_torch.grblas import (BackendUnavailableError, Descriptor,
                                SparseMatrix, api, plap_edge_semiring,
                                plap_hvp_edge_semiring, reals_ring)
from repro_torch.kernels import bsr_spmm as KB
from repro_torch.kernels import plap_edge as KP

# Small CPU problems: intra-op threads only contend with the other test
# workers.
torch.set_num_threads(1)

TOL = {np.float32: dict(rtol=2e-4, atol=2e-5),
       np.float64: dict(rtol=1e-12, atol=1e-12)}
BSR_ARRAYS = ("bsr_indices", "bsr_row_ids", "bsr_blocks")


def _port(ref, **layout):
    return convert.sparse_matrix(ref.host_coo(), (ref.n_rows, ref.n_cols),
                                 device="cpu", **layout)


def _assert_bsr_equal(ref, port):
    assert port.block_size == ref.block_size
    assert port.bsr_indptr.dtype == np.int64
    np.testing.assert_array_equal(port.bsr_indptr, ref.bsr_indptr)
    np.testing.assert_array_equal(port.bsr_indptr_dev.numpy(),
                                  ref.bsr_indptr.astype(np.int32))
    for name in BSR_ARRAYS:
        want, got = np.asarray(getattr(ref, name)), getattr(port, name).numpy()
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    assert port.bsr_fill_ratio() == ref.bsr_fill_ratio()


def _random_matrix(n, m, density, seed, symmetric=True):
    A = sp.random(n, m, density=density,
                  random_state=np.random.RandomState(seed), format="coo")
    return (A + A.T).tocoo() if symmetric else A


# ------------------------------------------------------------------ layout

@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("bs", [16, 32, 128])
def test_bsr_layout_equals_reference(bs, dtype):
    ref, _ = delaunay_graph(10, build_bsr=True, block_size=bs, dtype=dtype)
    port = _port(ref, build_bsr=True, block_size=bs, dtype=dtype)
    _assert_bsr_equal(ref, port)


@pytest.mark.parametrize("shape", [(100, 100), (70, 130), (130, 45)])
def test_bsr_layout_ragged_and_rectangular(shape):
    A = _random_matrix(*shape, 0.05, seed=1, symmetric=False)
    ref = RefMatrix.from_scipy(A, build_bsr=True, block_size=32,
                               dtype=jnp.float64)
    port = SparseMatrix.from_scipy(A, build_bsr=True, block_size=32,
                                   dtype=torch.float64, device="cpu")
    _assert_bsr_equal(ref, port)
    assert port.bsr_blocks.numpy().sum() == pytest.approx(
        port.vals.numpy().sum(), rel=1e-12)


def test_bsr_layout_repeated_entry_equals_reference():
    """A (row, col) stored twice keeps one value in its tile, the one the
    reference's numpy assignment keeps."""
    coo = (np.array([0, 3, 3, 5, 0]), np.array([1, 2, 2, 0, 1]),
           np.array([1.0, 2.0, 7.0, 3.0, 4.0]))
    ref = RefMatrix.from_coo(*coo, (6, 6), build_bsr=True, block_size=4,
                             dtype=jnp.float64)
    port = convert.sparse_matrix(coo, (6, 6), device="cpu", build_bsr=True,
                                 block_size=4, dtype=np.float64)
    _assert_bsr_equal(ref, port)


def test_with_vals_drops_bsr():
    ref, _ = delaunay_graph(9, build_bsr=True, block_size=32)
    port = _port(ref, build_bsr=True, block_size=32)
    m = port.with_vals(port.vals * 2)
    assert m.bsr_blocks is None and m.bsr_indptr is None
    assert np.isnan(m.bsr_fill_ratio())


# ----------------------------------------------------------------- reorder

@pytest.mark.parametrize("method", ["rcm", "degree"])
@pytest.mark.parametrize("graph", ["delaunay", "sbm"])
def test_reorder_equals_reference(graph, method):
    layout = dict(build_bsr=True, block_size=32, build_sellcs=True,
                  sell_c=8)
    if graph == "delaunay":
        ref, _ = delaunay_graph(9, locality_order=False, **layout)
    else:
        ref, _ = sbm_graph([40] * 3, p_in=0.3, p_out=0.02, seed=1, **layout)
    port = _port(ref, **layout)
    ref2, ref_perm, ref_inv = ref_reorder(ref, method)
    port2, perm, inv = reorder(port, method)
    np.testing.assert_array_equal(perm, ref_perm)
    np.testing.assert_array_equal(inv, ref_inv)
    assert perm.dtype == ref_perm.dtype == np.int64
    for a, b in zip(port2.host_coo(), ref2.host_coo()):
        np.testing.assert_array_equal(a, b)
    _assert_bsr_equal(ref2, port2)
    assert port2.sell_cols is not None and port2.ell_cols is not None
    assert bandwidth(port2) == ref_bandwidth(ref2)
    assert bandwidth(port) == ref_bandwidth(ref)


# ------------------------------------------------------------ kernel twins

def _tiles(dtype, bs=32, n=200, k=3):
    """Reference BSR arrays of a symmetric random graph, a ragged last
    block included, and multivectors padded to whole blocks."""
    A = _random_matrix(n, n, 0.03, seed=2)
    ref = RefMatrix.from_scipy(A, build_bsr=True, block_size=bs, dtype=dtype)
    n_rb = len(ref.bsr_indptr) - 1
    rng = np.random.default_rng(3)
    X = np.zeros((n_rb * bs, k), dtype)
    E = np.zeros((n_rb * bs, k), dtype)
    X[:n] = rng.standard_normal((n, k))
    E[:n] = 0.1 * rng.standard_normal((n, k))
    arrays = [np.asarray(a) for a in (ref.bsr_blocks, ref.bsr_indices,
                                      ref.bsr_row_ids)]
    return arrays, X, E, n_rb, bs


def _t(a):
    return convert.tensor(a, device="cpu")


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_bsr_spmm_twin_matches_pallas_and_ref(dtype):
    (blocks, idx, rid), X, _, n_rb, bs = _tiles(dtype)
    got = convert.to_numpy(KB.bsr_spmm_ref(_t(blocks), _t(idx), _t(rid),
                                           _t(X), n_rb, bs))
    args = (jnp.asarray(blocks), jnp.asarray(idx), jnp.asarray(rid),
            jnp.asarray(X))
    pallas = bsr_spmm_pallas(*args, n_row_blocks=n_rb, block_size=bs,
                             interpret=True)
    np.testing.assert_allclose(got, np.asarray(pallas), **TOL[dtype])
    np.testing.assert_allclose(got, np.asarray(bsr_spmm_ref(*args, n_rb, bs)),
                               **TOL[dtype])


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("p", [1.2, 1.5, 2.0])
def test_plap_twins_match_pallas_and_ref(dtype, p):
    (blocks, idx, rid), X, E, n_rb, bs = _tiles(dtype)
    eps = 1e-8
    tb, ti, tr = _t(blocks), _t(idx), _t(rid)
    jb, ji, jr = jnp.asarray(blocks), jnp.asarray(idx), jnp.asarray(rid)
    got = convert.to_numpy(KP.plap_apply_ref(tb, ti, tr, _t(X), n_rb, bs, p,
                                             eps))
    pallas = plap_apply_pallas(jb, ji, jr, jnp.asarray(X), n_row_blocks=n_rb,
                               block_size=bs, p=p, eps=eps, interpret=True)
    ref = plap_apply_ref(jb, ji, jr, jnp.asarray(X), n_rb, bs, p, eps)
    np.testing.assert_allclose(got, np.asarray(pallas), **TOL[dtype])
    np.testing.assert_allclose(got, np.asarray(ref), **TOL[dtype])

    got = convert.to_numpy(KP.plap_hvp_edge_ref(tb, ti, tr, _t(X), _t(E),
                                                n_rb, bs, p, eps))
    pallas = plap_hvp_pallas(jb, ji, jr, jnp.asarray(X), jnp.asarray(E),
                             n_row_blocks=n_rb, block_size=bs, p=p, eps=eps,
                             interpret=True)
    ref = plap_hvp_edge_ref(jb, ji, jr, jnp.asarray(X), jnp.asarray(E), n_rb,
                            bs, p, eps)
    np.testing.assert_allclose(got, np.asarray(pallas), **TOL[dtype])
    np.testing.assert_allclose(got, np.asarray(ref), **TOL[dtype])


def test_plap_twins_chunked_equal_unchunked(monkeypatch):
    """The twins' tile chunking (which keeps their temporaries bounded at
    full size) does not change the result."""
    (blocks, idx, rid), X, E, n_rb, bs = _tiles(np.float64)
    args = (_t(blocks), _t(idx), _t(rid))
    whole_a = KP.plap_apply_ref(*args, _t(X), n_rb, bs, 1.3, 1e-8)
    whole_h = KP.plap_hvp_edge_ref(*args, _t(X), _t(E), n_rb, bs, 1.3, 1e-8)
    monkeypatch.setattr(KP.plap_edge, "CHUNK_ELEMS", 3 * bs * bs * X.shape[1])
    assert len(KP.plap_edge._chunks(len(blocks), bs, X.shape[1])) > 2
    np.testing.assert_allclose(
        KP.plap_apply_ref(*args, _t(X), n_rb, bs, 1.3, 1e-8).numpy(),
        whole_a.numpy(), rtol=1e-13, atol=1e-13)
    np.testing.assert_allclose(
        KP.plap_hvp_edge_ref(*args, _t(X), _t(E), n_rb, bs, 1.3, 1e-8).numpy(),
        whole_h.numpy(), rtol=1e-13, atol=1e-13)


def test_hvp_twin_eps_zero_nan_where_reference_nan():
    """At eps = 0, phi'(0) = inf and a zero weight gives 0 * inf: the twin
    evaluates the same terms as the reference, NaNs included."""
    (blocks, idx, rid), X, E, n_rb, bs = _tiles(np.float64)
    got = KP.plap_hvp_edge_ref(_t(blocks), _t(idx), _t(rid), _t(X), _t(E),
                               n_rb, bs, 1.5, 0.0).numpy()
    want = np.asarray(plap_hvp_edge_ref(
        jnp.asarray(blocks), jnp.asarray(idx), jnp.asarray(rid),
        jnp.asarray(X), jnp.asarray(E), n_rb, bs, 1.5, 0.0))
    assert np.isnan(want).any()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))


def test_wrappers_reject_bad_operands():
    A = _random_matrix(60, 60, 0.1, seed=4)
    W = convert.sparse_matrix((A.row, A.col, A.data), A.shape, device="cpu",
                              dtype=np.float32, build_bsr=True, block_size=16)
    X = torch.zeros((60, 2))
    for bad in (X.double(), X[:-1], X.T.contiguous().T, X.to("meta"),
                X.half()):
        with pytest.raises((TypeError, ValueError)):
            KB.bsr_spmm(W, bad)
        with pytest.raises((TypeError, ValueError)):
            KP.plap_hvp(W, X, bad, 1.5, 1e-8)
    no_bsr = convert.sparse_matrix((A.row, A.col, A.data), A.shape,
                                   device="cpu", dtype=np.float32)
    with pytest.raises(ValueError, match="BSR layout"):
        KP.plap_apply(no_bsr, X, 1.5, 1e-8)
    B = _random_matrix(60, 40, 0.1, seed=5, symmetric=False)
    rect = convert.sparse_matrix((B.row, B.col, B.data), B.shape,
                                 device="cpu", dtype=np.float32,
                                 build_bsr=True, block_size=16)
    with pytest.raises(ValueError, match="square"):
        KP.plap_apply(rect, torch.zeros((40, 2)), 1.5, 1e-8)
    assert KB.LAUNCHES["bsr_spmm"] == 0 and KP.LAUNCHES["plap_hvp"] == 0


# ----------------------------------------------------------------- backends

def _backend_pair(bs, shape=(150, 150), symmetric=True):
    A = _random_matrix(*shape, 0.04, seed=6, symmetric=symmetric)
    coo = (A.row, A.col, A.data)
    port = convert.sparse_matrix(coo, shape, device="cpu", dtype=np.float64,
                                 build_bsr=True, block_size=bs,
                                 build_ell=False, build_sellcs=False)
    return A, port


@pytest.mark.parametrize("bs", [16, 32, 128])
@pytest.mark.parametrize("k", [1, 4])
def test_bsr_backends_match_coo(bs, k):
    _, port = _backend_pair(bs)
    rng = np.random.default_rng(k)
    U = _t(rng.standard_normal((port.n_rows, k)))
    E = _t(0.1 * rng.standard_normal((port.n_rows, k)))
    coo = Descriptor(backend="coo")
    pairs = [
        (api.mxm(port, U, desc=Descriptor(backend="bsr_pallas")),
         api.mxm(port, U, desc=coo)),
        (api.mxm(port, U, plap_edge_semiring(1.3, 1e-8),
                 desc=Descriptor(backend="edge_pallas")),
         api.mxm(port, U, plap_edge_semiring(1.3, 1e-8), desc=coo)),
        (api.mxm(port, (U, E), plap_hvp_edge_semiring(1.3, 1e-8),
                 desc=Descriptor(backend="edge_pallas")),
         api.mxm(port, (U, E), plap_hvp_edge_semiring(1.3, 1e-8), desc=coo)),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-11,
                                   atol=1e-11)


def test_bsr_pallas_rectangular_matches_coo():
    _, port = _backend_pair(32, shape=(150, 90), symmetric=False)
    X = _t(np.random.default_rng(0).standard_normal((90, 3)))
    np.testing.assert_allclose(
        api.mxm(port, X, desc=Descriptor(backend="bsr_pallas")).numpy(),
        api.mxm(port, X, desc=Descriptor(backend="coo")).numpy(),
        rtol=1e-11, atol=1e-11)
    with pytest.raises(BackendUnavailableError):
        api.mxm(port, X, plap_edge_semiring(1.5, 1e-8),
                desc=Descriptor(backend="edge_pallas"))


def test_bsr_backends_refuse_what_they_cannot_run():
    _, port = _backend_pair(32)
    U = torch.zeros((port.n_rows, 2), dtype=torch.float64)
    for args in [(U[:, 0], reals_ring, "bsr_pallas"),          # 1-D
                 (U, reals_ring, "edge_pallas"),                # reals
                 (U, plap_edge_semiring(1.5), "bsr_pallas")]:
        with pytest.raises(BackendUnavailableError):
            api.mxm(port, args[0], args[1],
                    desc=Descriptor(backend=args[2]))
    with pytest.raises(BackendUnavailableError):
        api.mxm(port, U, desc=Descriptor(backend="bsr_pallas",
                                         transpose=True))
    with pytest.raises(BackendUnavailableError):       # multivalues
        api.mxm(port.with_vals(torch.ones((port.nnz, 2), dtype=U.dtype)), U,
                desc=Descriptor(backend="bsr_pallas"))


@pytest.mark.parametrize("layout,reals,edge", [
    (dict(build_sellcs=True), "sellcs", "sellcs"),
    (dict(build_ell=True, build_sellcs=False), "ell", "edge_pallas"),
    (dict(build_ell=False, build_sellcs=False), "bsr_pallas", "edge_pallas"),
])
def test_auto_order_puts_bsr_after_sellcs_and_ell(layout, reals, edge):
    A = _random_matrix(80, 80, 0.05, seed=7)
    port = convert.sparse_matrix((A.row, A.col, A.data), A.shape,
                                 device="cpu", build_bsr=True, block_size=16,
                                 **layout)
    U = torch.zeros((80, 4))
    assert api.available_backends(port, U)[0] == reals
    assert api.available_backends(
        port, U, plap_edge_semiring(1.5))[0] == edge
    assert api.available_backends(
        port, (U, U), plap_hvp_edge_semiring(1.5))[0] == edge


@pytest.mark.parametrize("transpose", [False, True])
def test_spgemm_matches_reference(transpose):
    A = _random_matrix(70, 50, 0.08, seed=8, symmetric=False)
    B = _random_matrix(70 if transpose else 50, 40, 0.1, seed=9,
                       symmetric=False)
    desc = dict(transpose=transpose)
    refA = RefMatrix.from_scipy(A, dtype=jnp.float64)
    refB = RefMatrix.from_scipy(B, dtype=jnp.float64)
    want = ref_api.mxm(refA, refB, desc=ref_api.Descriptor(**desc))
    got = api.mxm(_port(refA, dtype=np.float64), _port(refB, dtype=np.float64),
                  desc=Descriptor(**desc))
    assert (got.n_rows, got.n_cols) == (want.n_rows, want.n_cols)
    assert got.ell_cols is None and got.sell_cols is None
    for g, w in zip(got.host_coo(), want.host_coo()):
        np.testing.assert_array_equal(g, w)


# -------------------------------------------------------------- end to end

@functools.lru_cache(maxsize=None)
def _reference_rcm_solve():
    W, truth = sbm_graph([30, 30, 30, 30], p_in=0.5, p_out=0.03, seed=5,
                         build_bsr=True, block_size=32)
    kw = dict(k=4, p_target=1.3, newton_iters=15, tcg_iters=10, seed=0)
    res = ref_cluster(W, RefConfig(reorder="rcm", **kw))
    return W, truth, kw, float(res.rcut)


@pytest.mark.parametrize("mode", ["graphblas", "matrix_free"])
def test_flat_edge_pallas_rcm_solve_matches_reference_quality(mode):
    W, truth, kw, ref_rcut = _reference_rcm_solve()
    port = _port(W, build_bsr=True, block_size=32, build_ell=False,
                 build_sellcs=False)
    res = p_spectral_cluster(port, PSCConfig(backend="edge_pallas",
                                             reorder="rcm", hvp_mode=mode,
                                             **kw))
    assert metrics.clustering_accuracy(res.labels, truth, 4) >= 0.95
    assert res.rcut <= ref_rcut * 1.05 + 1e-9, (res.rcut, ref_rcut)
    assert res.rcut <= res.init_rcut * 1.01 + 1e-9
    G = convert.to_numpy(res.U.T @ res.U)
    np.testing.assert_allclose(G, np.eye(4), atol=1e-4)
    # labels, init_labels and U come back in the caller's vertex order:
    # the cut of the returned labels on the unpermuted graph is the RCut
    assert float(metrics.rcut(port, res.labels, 4)) == pytest.approx(
        res.rcut, rel=1e-6)
    assert float(metrics.rcut(port, res.init_labels, 4)) == pytest.approx(
        res.init_rcut, rel=1e-6)
