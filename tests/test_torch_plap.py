"""p-Laplacian parts, value, gradient and both HVPs against the reference
(fp64, to 1e-10) and against a torch.func jvp-of-grad oracle."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the reference-only CI has no torch

import jax.numpy as jnp
from repro.core import plap as ref_plap
from repro.graphs import gaussian_blobs_knn
from repro.grblas import Descriptor as RefDesc
from repro_torch import convert
from repro_torch.core import plap
from repro_torch.grblas import Descriptor

# Small CPU problems: intra-op threads only contend with the other test
# workers.
torch.set_num_threads(1)

TOL = dict(rtol=1e-10, atol=1e-10)
EPS = 1e-6


@pytest.fixture(scope="module")
def graph():
    W, _ = gaussian_blobs_knn(20, 3, seed=4, build_sellcs=True, sell_c=8,
                              dtype=jnp.float64)
    port = convert.sparse_matrix(W.host_coo(), (W.n_rows, W.n_cols),
                                 device="cpu", build_sellcs=True, sell_c=8)
    rng = np.random.default_rng(0)
    U = np.linalg.qr(rng.standard_normal((W.n_rows, 3)))[0]
    eta = 0.1 * rng.standard_normal((W.n_rows, 3))
    return W, port, U, eta


def _np(t):
    return convert.to_numpy(t) if torch.is_tensor(t) else np.asarray(t)


@pytest.mark.parametrize("backend", ["coo", "sellcs"])
@pytest.mark.parametrize("p", [1.2, 1.5, 2.0])
def test_parts_value_grad_match_reference(graph, backend, p):
    W, port, U, _ = graph
    d = Descriptor(backend=backend)
    rd = RefDesc(backend=backend)
    Ut = convert.tensor(U, device="cpu")
    got = plap.parts(port, Ut, p, EPS, d)
    want = ref_plap.parts(W, jnp.asarray(U), p, EPS, rd)
    for a, b in zip(got, want):
        np.testing.assert_allclose(_np(a), _np(b), **TOL)
    np.testing.assert_allclose(
        float(plap.value(port, Ut, p, EPS, d)),
        float(ref_plap.value(W, jnp.asarray(U), p, EPS, rd)), **TOL)
    np.testing.assert_allclose(
        _np(plap.euc_grad(port, Ut, p, EPS, d)),
        _np(ref_plap.euc_grad(W, jnp.asarray(U), p, EPS, rd)), **TOL)
    f, g = plap.value_and_grad(port, Ut, p, EPS, d)
    np.testing.assert_allclose(_np(g), _np(plap.euc_grad(port, Ut, p, EPS, d)),
                               rtol=0, atol=0)


@pytest.mark.parametrize("backend", ["coo", "sellcs"])
@pytest.mark.parametrize("mode", ["graphblas", "matrix_free"])
@pytest.mark.parametrize("p", [1.2, 1.5, 2.0])
def test_hvps_match_reference(graph, backend, mode, p):
    W, port, U, eta = graph
    fn = {"graphblas": (plap.hess_eta_graphblas, ref_plap.hess_eta_graphblas),
          "matrix_free": (plap.hess_eta_matrix_free,
                          ref_plap.hess_eta_matrix_free)}[mode]
    got = fn[0](port, convert.tensor(U, device="cpu"),
                convert.tensor(eta, device="cpu"), p, EPS,
                desc=Descriptor(backend=backend))
    want = fn[1](W, jnp.asarray(U), jnp.asarray(eta), p, EPS,
                 desc=RefDesc(backend=backend))
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


@pytest.mark.parametrize("p", [1.3, 1.8])
def test_grad_and_hvps_match_torch_func_oracle(graph, p):
    from torch.func import grad

    _, port, U, eta = graph
    Ut = convert.tensor(U, device="cpu")
    Et = convert.tensor(eta, device="cpu")
    f = plap.autodiff_value(port, p, EPS)
    np.testing.assert_allclose(_np(plap.euc_grad(port, Ut, p, EPS)),
                               _np(grad(f)(Ut)), rtol=1e-9, atol=1e-11)
    oracle = _np(plap.autodiff_hvp(port, Ut, Et, p, EPS))
    for hvp in (plap.hess_eta_graphblas, plap.hess_eta_matrix_free):
        np.testing.assert_allclose(_np(hvp(port, Ut, Et, p, EPS)), oracle,
                                   rtol=1e-8, atol=1e-9)


def test_alg1_operands_match_reference(graph):
    W, port, U, _ = graph
    D, what = plap.build_alg1_operands(port, convert.tensor(U, device="cpu"),
                                       1.4, EPS)
    rD, rwhat = ref_plap.build_alg1_operands(W, jnp.asarray(U), 1.4, EPS)
    np.testing.assert_allclose(_np(D), _np(rD), **TOL)
    np.testing.assert_allclose(_np(what), _np(rwhat), **TOL)


def test_graphblas_hvp_builds_what_once(graph, monkeypatch):
    """One W-hat layout per Algorithm-1 HVP: its D and its SpMM share it."""
    from repro_torch.grblas.containers import SparseMatrix

    _, port, U, eta = graph
    calls = []
    with_vals = SparseMatrix.with_vals
    monkeypatch.setattr(SparseMatrix, "with_vals",
                        lambda self, v: calls.append(1) or with_vals(self, v))
    Ut, Et = convert.tensor(U, device="cpu"), convert.tensor(eta, device="cpu")
    plap.hess_eta_graphblas(port, Ut, Et, 1.4, EPS,
                            desc=Descriptor(backend="sellcs"))
    assert len(calls) == 1
