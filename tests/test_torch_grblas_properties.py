"""Property tests for the port's algebraic layer and system invariants,
mirroring ``tests/test_grblas_properties.py`` (its 9 properties, same
strategies and example counts).

Draws come from the vendored ``repro._vendor.minihypothesis`` (seeded,
deterministic; test-side only — the port never imports ``repro``).
Where a property also compares with the reference, the reference gets
the same draw: ring operations bit for bit, ``phi_p`` to 1e-12, the
SpMV, the boolean reachability and the cut metrics to the reference's
own tolerances.  Everything runs on the CPU.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the reference-only CI has no torch

import jax.numpy as jnp
import scipy.sparse as sp
from repro._vendor.minihypothesis import given, settings, strategies as st
from repro.core import metrics as ref_metrics
from repro.graphs import ring_of_cliques as ref_ring_of_cliques
from repro.grblas import SparseMatrix as RefSparseMatrix
from repro.grblas import boolean_ring as ref_boolean_ring
from repro.grblas import max_times_ring as ref_max_times_ring
from repro.grblas import min_plus_ring as ref_min_plus_ring
from repro.grblas import mxv as ref_mxv
from repro.grblas import reals_ring as ref_reals_ring
from repro.grblas.semiring import phi_p as ref_phi_p
from repro_torch import convert
from repro_torch.core import metrics
from repro_torch.core import phi as PHI
from repro_torch.graphs import ring_of_cliques
from repro_torch.grblas import (Descriptor, SparseMatrix, boolean_ring,
                                max_times_ring, min_plus_ring, mxm, mxv,
                                plap_edge_semiring, plap_hvp_edge_semiring,
                                reals_ring)
from repro_torch.grblas.semiring import phi_p

# Small CPU problems: intra-op threads only contend with the other test
# workers.
torch.set_num_threads(1)

finite = st.floats(min_value=-100, max_value=100, allow_nan=False,
                   width=32)
CPU = "cpu"


def _t(x, dtype=torch.float64):
    return torch.as_tensor(np.asarray(x), dtype=dtype)


@settings(max_examples=50, deadline=None)
@given(a=finite, b=finite, c=finite)
def test_semiring_laws_reals(a, b, c):
    rings = ((reals_ring, ref_reals_ring), (min_plus_ring, ref_min_plus_ring),
             (max_times_ring, ref_max_times_ring))
    for ring, ref in rings:
        A, B, C = (_t(v, torch.float32) for v in (a, b, c))
        # add associativity + commutativity
        l = ring.add(ring.add(A, B), C)
        r = ring.add(A, ring.add(B, C))
        np.testing.assert_allclose(float(l), float(r), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(float(ring.add(A, B)),
                                   float(ring.add(B, A)), rtol=1e-6)
        # identities (a tensor operand: the port's rings are defined over
        # tensors, and torch.minimum/maximum take no Python scalar)
        zero, one = (_t(v, torch.float32) for v in (ring.zero, ring.one))
        np.testing.assert_allclose(float(ring.add(A, zero)), a,
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(float(ring.mul(A, one)), a,
                                   rtol=1e-6, atol=1e-6)
        # the same draw through the reference's ring: the same float32
        jA, jB = jnp.float32(a), jnp.float32(b)
        assert float(ring.add(A, B)) == float(ref.add(jA, jB))
        assert float(ring.mul(A, B)) == float(ref.mul(jA, jB))
        assert (ring.zero, ring.one) == (ref.zero, ref.one)


@settings(max_examples=40, deadline=None)
@given(x=finite, p=st.floats(min_value=1.05, max_value=2.0))
def test_phi_p_odd_and_monotone(x, p):
    f = float(phi_p(_t(x), p))
    f_neg = float(phi_p(_t(-x), p))
    np.testing.assert_allclose(f, -f_neg, rtol=1e-8, atol=1e-12)
    if abs(x) > 1e-3:
        g = float(phi_p(_t(x * 1.1), p))
        assert (g - f) * np.sign(x) >= -1e-9    # monotone increasing
    np.testing.assert_allclose(f, float(ref_phi_p(jnp.float64(x), p)),
                               rtol=1e-12, atol=1e-12)


@settings(max_examples=30, deadline=None)
@given(p=st.floats(min_value=1.05, max_value=2.0),
       eps=st.floats(min_value=1e-12, max_value=1e-4))
def test_phi_prime_nonnegative(p, eps):
    xs = torch.linspace(-5, 5, 101, dtype=torch.float64)
    d = PHI.phi_prime(xs, p, eps)
    assert float(torch.min(d)) >= 0.0           # smoothed phi' must be >= 0


@settings(max_examples=25, deadline=None)
@given(perm_seed=st.integers(min_value=0, max_value=2**31 - 1))
def test_rcut_invariant_under_label_permutation(perm_seed):
    W, truth = ring_of_cliques(4, 6, device=CPU)
    rng = np.random.default_rng(perm_seed)
    perm = rng.permutation(4)
    relabeled = perm[truth]
    a = float(metrics.rcut(W, truth, 4))
    b = float(metrics.rcut(W, relabeled, 4))
    np.testing.assert_allclose(a, b, rtol=1e-6)
    Wr, _ = ref_ring_of_cliques(4, 6)
    np.testing.assert_allclose(b, float(ref_metrics.rcut(Wr, relabeled, 4)),
                               rtol=1e-6)


@settings(max_examples=20, deadline=None)
@given(seed=st.integers(min_value=0, max_value=2**31 - 1))
def test_spmv_linearity(seed):
    rng = np.random.default_rng(seed)
    A = sp.random(24, 24, density=0.2,
                  random_state=np.random.RandomState(seed % 1000))
    M = SparseMatrix.from_scipy(A, dtype=torch.float64, device=CPU)
    x = rng.standard_normal(24)
    y = rng.standard_normal(24)
    a, b = rng.standard_normal(2)
    lhs = convert.to_numpy(mxv(M, _t(a * x + b * y)))
    rhs = a * convert.to_numpy(mxv(M, _t(x))) \
        + b * convert.to_numpy(mxv(M, _t(y)))
    np.testing.assert_allclose(lhs, rhs, rtol=1e-9, atol=1e-9)
    ref = RefSparseMatrix.from_scipy(A, dtype=jnp.float64)
    np.testing.assert_allclose(
        convert.to_numpy(mxv(M, _t(x))),
        np.asarray(ref_mxv(ref, jnp.asarray(x))), rtol=1e-12, atol=1e-12)


@settings(max_examples=15, deadline=None)
@given(seed=st.integers(min_value=0, max_value=2**31 - 1))
def test_boolean_ring_is_reachability(seed):
    A = sp.random(16, 16, density=0.15,
                  random_state=np.random.RandomState(seed % 997))
    M = SparseMatrix.from_scipy(A, dtype=torch.float64, device=CPU)
    x = np.zeros(16, bool)
    x[seed % 16] = True
    got = convert.to_numpy(mxv(M, torch.as_tensor(x), boolean_ring))
    want = (A.toarray() != 0) @ x
    np.testing.assert_array_equal(got, want.astype(bool))
    ref = RefSparseMatrix.from_scipy(A, dtype=jnp.float64)
    np.testing.assert_array_equal(
        got, np.asarray(ref_mxv(ref, jnp.asarray(x), ref_boolean_ring)))


@settings(max_examples=20, deadline=None)
@given(seed=st.integers(min_value=0, max_value=2**31 - 1),
       p=st.sampled_from([1.2, 1.5, 2.0]),
       C=st.sampled_from([4, 8, 16]),
       sigma=st.sampled_from([8, 32, None]))
def test_sellcs_equals_coo_across_rings(seed, p, C, sigma):
    """The sliced layout is a pure execution detail: sellcs == coo for
    the reals ring (1-D and multivector), the p-Laplacian apply, and the
    Newton-HVP pair ring, on arbitrary symmetric patterns x (C, σ)."""
    A = sp.random(48, 48, density=0.12,
                  random_state=np.random.RandomState(seed % 9973))
    A = A + A.T
    M = SparseMatrix.from_scipy(A, build_sellcs=True, sell_c=C,
                                sell_sigma=sigma, device=CPU)
    rng = np.random.default_rng(seed)
    X = _t(rng.standard_normal((48, 3)), torch.float32)
    coo, sell = Descriptor(backend="coo"), Descriptor(backend="sellcs")

    def close(a, b):
        np.testing.assert_allclose(convert.to_numpy(a), convert.to_numpy(b),
                                   rtol=1e-4, atol=1e-5)

    close(mxm(M, X, desc=sell), mxm(M, X, desc=coo))
    close(mxm(M, X[:, 0], desc=sell), mxm(M, X[:, 0], desc=coo))
    ring = plap_edge_semiring(p, eps=1e-6)
    close(mxm(M, X, ring, desc=sell), mxm(M, X, ring, desc=coo))
    Eta = _t(rng.standard_normal((48, 3)) * 0.1, torch.float32)
    hring = plap_hvp_edge_semiring(p, eps=1e-6)
    close(mxm(M, (X, Eta), hring, desc=sell),
          mxm(M, (X, Eta), hring, desc=coo))


@settings(max_examples=15, deadline=None)
@given(seed=st.integers(min_value=0, max_value=2**31 - 1),
       method=st.sampled_from(["rcm", "degree"]))
def test_reorder_leaves_cut_metrics_invariant(seed, method):
    """Graph relabeling under graphs.reorder must not move RCut/NCut:
    metrics on (W2, labels[perm]) equal metrics on (W, labels)."""
    from repro_torch.graphs import reorder

    W, truth = ring_of_cliques(4, 6, device=CPU)
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 4, W.n_rows)
    W2, perm, _ = reorder(W, method)
    a = float(metrics.rcut(W, labels, 4))
    b = float(metrics.rcut(W2, labels[perm], 4))
    np.testing.assert_allclose(a, b, rtol=1e-5)
    an = float(metrics.ncut(W, labels, 4))
    bn = float(metrics.ncut(W2, labels[perm], 4))
    np.testing.assert_allclose(an, bn, rtol=1e-5)


def test_kmeans_inertia_decreases():
    from repro_torch.core.kmeans import lloyd

    rng = np.random.default_rng(0)
    X = _t(rng.standard_normal((120, 3)), torch.float32)
    C0 = X[:4]
    i_prev = None
    for iters in (1, 3, 10, 30):
        _, C, inertia = lloyd(X, C0, iters=iters)
        if i_prev is not None:
            assert float(inertia) <= i_prev + 1e-5
        i_prev = float(inertia)
