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


# ------------------------------------------- grblas names of the reference

@pytest.mark.parametrize("eps", [0.0, 1e-6])
@pytest.mark.parametrize("p", [1.1, 1.5, 2.0])
def test_phi_p_matches_reference(p, eps):
    """``grblas.semiring.phi_p``, both branches, on the same seeded fp64
    inputs as the reference's (to 1e-12; 0 maps to 0 exactly)."""
    from repro.grblas.semiring import phi_p as ref_phi_p
    from repro_torch.grblas.semiring import phi_p

    x = np.random.default_rng(3).standard_normal(64) * 3.0
    x[:2] = 0.0
    got = _np(phi_p(convert.tensor(x, device="cpu"), p, eps))
    want = np.asarray(ref_phi_p(jnp.asarray(x), p, eps))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    assert (got[:2] == 0.0).all()


def test_plap_hess_edge_semiring_matches_reference(graph):
    """The deprecated pre-fused Hessian ring: the same name and kind as
    the reference's, and the same product under ``coo`` (fp64, 1e-10)."""
    from repro.grblas import mxm as ref_mxm
    from repro.grblas.semiring import plap_hess_edge_semiring as ref_ring
    from repro_torch.grblas import api
    from repro_torch.grblas.semiring import plap_hess_edge_semiring

    W, port, _, eta = graph
    ring, rring = plap_hess_edge_semiring(1.5), ref_ring(1.5)
    assert "Deprecated" in plap_hess_edge_semiring.__doc__
    assert (ring.name, ring.kind) == (rring.name, rring.kind)
    got = api.mxm(port, convert.tensor(eta, device="cpu"), ring,
                  desc=Descriptor(backend="coo"))
    want = ref_mxm(W, jnp.asarray(eta), rring, desc=RefDesc(backend="coo"))
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


@pytest.mark.parametrize("p", [1.2, 1.5, 2.0])
def test_fused_plap_apply_matches_reference(graph, p):
    """``grblas.ops.fused_plap_apply`` is one ``api.mxm`` under
    ``plap_edge_semiring``: bit-equal to that call in the port, and to
    the reference's fused apply within 1e-10 (fp64).  The reference's
    body runs unjitted (``__wrapped__``): under its ``jax.jit`` a traced
    ``eps`` reaches ``core.phi``'s python ``if eps == 0.0`` and raises."""
    from repro.grblas import ops as ref_ops
    from repro_torch.grblas import api, ops
    from repro_torch.grblas.semiring import plap_edge_semiring

    W, port, U, _ = graph
    Ut = convert.tensor(U, device="cpu")
    got = ops.fused_plap_apply(port, Ut, p, EPS, k=3)
    same = api.mxm(port, Ut, plap_edge_semiring(p, EPS))
    assert torch.equal(got, same)
    want = ref_ops.fused_plap_apply.__wrapped__(W, jnp.asarray(U), p, EPS,
                                                k=3)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
