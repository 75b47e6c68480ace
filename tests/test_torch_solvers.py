"""Stage 1 (LOBPCG / dense eigh), one trust-region Newton level, kmeans
and the cut metrics against the reference, from identical inputs.

Eigenvectors and QR retractions are compared as subspaces (principal
angles), because their signs and rotations are not fixed."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the reference-only CI has no torch

import jax.numpy as jnp
from repro.core import grassmann as ref_grassmann
from repro.core import kmeans as ref_km
from repro.core import lobpcg as ref_lobpcg
from repro.core import metrics as ref_metrics
from repro.core import plap as ref_plap
from repro.graphs import ring_of_cliques, sbm_graph_sparse
from repro.grblas import Descriptor as RefDesc
from repro_torch import convert
from repro_torch.core import grassmann, kmeans, lobpcg, metrics, plap
from repro_torch.grblas import Descriptor

# Small CPU problems: intra-op threads only contend with the other test
# workers.
torch.set_num_threads(1)


def _port(W, **layout):
    return convert.sparse_matrix(W.host_coo(), (W.n_rows, W.n_cols),
                                 device="cpu", **layout)


def _sin_theta(A, B):
    """Largest principal sine between the column spaces of A and B."""
    Qa = np.linalg.qr(A)[0]
    Qb = np.linalg.qr(B)[0]
    return float(np.linalg.norm(Qb - Qa @ (Qa.T @ Qb), 2))


@pytest.fixture(scope="module")
def sbm():
    """n = 1200 > 1024: smallest_eigvecs takes the LOBPCG path."""
    W, truth = sbm_graph_sparse([300] * 4, deg_in=12, deg_out=0.6, seed=2,
                                dtype=jnp.float64)
    return W, truth


def test_dense_eigh_path_matches_reference():
    W, _ = ring_of_cliques(4, 10, dtype=jnp.float64)
    ev, U = lobpcg.smallest_eigvecs(_port(W), 4)
    rev, rU = ref_lobpcg.smallest_eigvecs(W, 4)
    np.testing.assert_allclose(convert.to_numpy(ev), np.asarray(rev),
                               rtol=1e-10, atol=1e-10)
    assert _sin_theta(convert.to_numpy(U), np.asarray(rU)) <= 1e-6


@pytest.mark.parametrize("backend", ["coo", "sellcs"])
def test_lobpcg_path_with_injected_x0_matches_reference(sbm, backend):
    W, _ = sbm
    n, k = W.n_rows, 4
    m = max(2 * k, k + 4)
    X0 = np.random.default_rng(5).standard_normal((n, m))
    port = _port(W, build_sellcs=True, sell_c=32)
    ev, U = lobpcg.smallest_eigvecs(port, k, tol=1e-9, X0=convert.tensor(
        X0, device="cpu"), desc=Descriptor(backend=backend))
    rev, rU = ref_lobpcg.smallest_eigvecs(W, k, tol=1e-9, X0=jnp.asarray(X0),
                                          desc=RefDesc(backend="coo"))
    np.testing.assert_allclose(convert.to_numpy(ev), np.asarray(rev),
                               rtol=1e-8, atol=1e-9)
    assert _sin_theta(convert.to_numpy(U), np.asarray(rU)) <= 1e-6


@pytest.mark.parametrize("mode", ["graphblas", "matrix_free"])
def test_one_rtr_level_matches_reference(sbm, mode):
    W, _ = sbm
    _, rU = ref_lobpcg.smallest_eigvecs(W, 4)
    U0 = np.linalg.qr(np.asarray(rU))[0]
    p, eps = 1.6, 1e-8
    port = _port(W, build_sellcs=True, sell_c=32)
    d = Descriptor(backend="sellcs")
    rd = RefDesc(backend="coo")
    rh = {"graphblas": ref_plap.hess_eta_graphblas,
          "matrix_free": ref_plap.hess_eta_matrix_free}[mode]
    h = {"graphblas": plap.hess_eta_graphblas,
         "matrix_free": plap.hess_eta_matrix_free}[mode]
    ref = ref_grassmann.rtr_minimize(
        lambda U: ref_plap.value(W, U, p, eps, rd),
        lambda U: ref_plap.euc_grad(W, U, p, eps, rd),
        lambda U, e: rh(W, U, e, p, eps, desc=rd),
        jnp.asarray(U0), max_iters=6, tcg_iters=10, grad_tol=1e-5)
    got = grassmann.rtr_minimize(
        lambda U: plap.value(port, U, p, eps, d),
        lambda U: plap.euc_grad(port, U, p, eps, d),
        lambda U, e: h(port, U, e, p, eps, desc=d),
        convert.tensor(U0, device="cpu"), max_iters=6, tcg_iters=10,
        grad_tol=1e-5)
    assert got.iters == int(ref.iters)
    assert got.n_hvp == int(ref.n_hvp)
    np.testing.assert_allclose(float(got.fval), float(ref.fval), rtol=1e-8)
    assert _sin_theta(convert.to_numpy(got.U), np.asarray(ref.U)) <= 1e-6


def test_retract_qr_and_proj_match_reference():
    rng = np.random.default_rng(3)
    U = np.linalg.qr(rng.standard_normal((50, 3)))[0]
    Z = 0.2 * rng.standard_normal((50, 3))
    t = lambda a: convert.tensor(a, device="cpu")
    np.testing.assert_allclose(
        convert.to_numpy(grassmann.proj(t(U), t(Z))),
        np.asarray(ref_grassmann.proj(jnp.asarray(U), jnp.asarray(Z))),
        rtol=1e-12, atol=1e-12)
    R = convert.to_numpy(grassmann.retract_qr(t(U), t(Z)))
    rR = np.asarray(ref_grassmann.retract_qr(jnp.asarray(U), jnp.asarray(Z)))
    np.testing.assert_allclose(R, rR, rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_lloyd_with_same_c0_gives_identical_labels(dtype):
    rng = np.random.default_rng(7)
    centers = rng.standard_normal((4, 3)) * 4
    X = (centers[rng.integers(0, 4, 300)]
         + rng.standard_normal((300, 3))).astype(dtype)
    C0 = X[rng.choice(300, 4, replace=False)]
    a, C, inertia = kmeans.lloyd(convert.tensor(X, device="cpu"),
                                 convert.tensor(C0, device="cpu"), iters=20)
    ra, rC, rinertia = ref_km.lloyd(jnp.asarray(X), jnp.asarray(C0), iters=20)
    np.testing.assert_array_equal(convert.to_numpy(a), np.asarray(ra))
    tol = 1e-4 if dtype == np.float32 else 1e-10
    np.testing.assert_allclose(convert.to_numpy(C), np.asarray(rC), rtol=tol,
                               atol=tol)
    np.testing.assert_allclose(float(inertia), float(rinertia), rtol=tol)


def test_batched_lloyd_equals_each_run_alone():
    rng = np.random.default_rng(8)
    X = convert.tensor(rng.standard_normal((200, 2)), device="cpu")
    C0 = convert.tensor(rng.standard_normal((3, 4, 2)), device="cpu")
    a, C, inertia = kmeans.lloyd(X, C0, iters=10)
    for r in range(3):
        a1, C1, i1 = kmeans.lloyd(X, C0[r], iters=10)
        assert torch.equal(a[r], a1)
        torch.testing.assert_close(C[r], C1)


def test_assign_breaks_ties_to_the_lowest_index():
    X = np.array([[0.0, 0.0], [2.0, 0.0], [5.0, 5.0]])
    C = np.array([[1.0, 0.0], [-1.0, 0.0], [1.0, 0.0], [0.0, 1.0]])
    got = convert.to_numpy(kmeans.assign(convert.tensor(X, device="cpu"),
                                         convert.tensor(C, device="cpu")))
    np.testing.assert_array_equal(got, [0, 0, 0])
    np.testing.assert_array_equal(
        got, np.asarray(ref_km.assign(jnp.asarray(X), jnp.asarray(C))))


def test_kmeans_recovers_separated_blobs():
    rng = np.random.default_rng(9)
    truth = np.repeat(np.arange(3), 60)
    X = np.array([[0, 0], [10, 0], [0, 10]])[truth] + rng.standard_normal(
        (180, 2))
    gen = torch.Generator().manual_seed(0)
    labels, _ = kmeans.kmeans(gen, convert.tensor(X, device="cpu"), 3,
                              restarts=4, iters=20)
    assert metrics.clustering_accuracy(labels, truth, 3) == 1.0


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_cut_metrics_equal_reference(sbm, dtype):
    W, truth = sbm
    port = _port(W, dtype=dtype)
    labels = np.random.default_rng(1).integers(0, 4, W.n_rows)
    labels[:4] = np.arange(4)
    tol = 1e-6 if dtype == np.float32 else 1e-12
    for fn, rfn in ((metrics.rcut, ref_metrics.rcut),
                    (metrics.ncut, ref_metrics.ncut)):
        np.testing.assert_allclose(float(fn(port, labels, 4)),
                                   float(rfn(W, labels, 4)), rtol=tol)
        np.testing.assert_allclose(float(fn(port, truth, 4)),
                                   float(rfn(W, truth, 4)), rtol=tol)
    np.testing.assert_allclose(
        convert.to_numpy(metrics.cut_matrix(port, labels, 4)),
        np.asarray(ref_metrics.cut_matrix(W, labels, 4)), rtol=tol)
    assert metrics.clustering_accuracy(labels, truth, 4) == \
        ref_metrics.clustering_accuracy(labels, truth, 4)
