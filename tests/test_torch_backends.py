"""Port api.mxm under coo / ell / sellcs equals the reference api.mxm, for
the reals ring (scalar and multivalue), the p-Laplacian apply and the
pair-edge HVP, on symmetric and asymmetric inputs; plus mask, accum,
transpose and the loud-failure contract of named backends."""
import numpy as np
import pytest
import scipy.sparse as sp

torch = pytest.importorskip("torch")  # the reference-only CI has no torch

import jax.numpy as jnp
from repro.grblas import Descriptor as RefDesc
from repro.grblas import SparseMatrix as RefMatrix
from repro.grblas import mxm as ref_mxm
from repro.grblas.semiring import plap_edge_semiring as ref_plap
from repro.grblas.semiring import plap_hvp_edge_semiring as ref_hvp
from repro_torch import convert
from repro_torch.grblas import (BackendUnavailableError, Descriptor, mxm,
                                plap_edge_semiring, plap_hvp_edge_semiring,
                                vxm)

# Small CPU problems: intra-op threads only contend with the other test
# workers.
torch.set_num_threads(1)

TOL = dict(rtol=1e-11, atol=1e-11)   # fp64; sums differ in order only
BACKENDS = ["coo", "ell", "sellcs"]


def _pair(symmetric, n=90):
    A = sp.random(n, n, density=0.06, random_state=np.random.RandomState(4),
                  format="coo")
    if symmetric:
        A = A + A.T
    A = A.tocoo()
    coo, shape = (A.row, A.col, A.data), A.shape
    layout = dict(build_ell=True, build_sellcs=True, sell_c=8)
    ref = RefMatrix.from_coo(*coo, shape, dtype=jnp.float64, **layout)
    port = convert.sparse_matrix(coo, shape, device="cpu", dtype=np.float64,
                                 **layout)
    return ref, port


def _mv(n, k, seed):
    return np.random.default_rng(seed).standard_normal((n, k))


def _check(got, want):
    np.testing.assert_allclose(convert.to_numpy(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("symmetric", [True, False])
@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("k", [None, 1, 4])
def test_reals_ring_matches_reference(symmetric, backend, k):
    ref, port = _pair(symmetric)
    X = _mv(port.n_rows, k or 1, 0)
    X = X[:, 0] if k is None else X
    want = ref_mxm(ref, jnp.asarray(X), desc=RefDesc(backend="coo"))
    _check(mxm(port, convert.tensor(X, device="cpu"),
               desc=Descriptor(backend=backend)), want)


@pytest.mark.parametrize("symmetric", [True, False])
@pytest.mark.parametrize("backend", ["coo", "sellcs"])
def test_multivalue_reals_matches_reference(symmetric, backend):
    ref, port = _pair(symmetric)
    mv = _mv(port.nnz, 3, 1)
    X = _mv(port.n_rows, 3, 2)
    want = ref_mxm(ref.with_vals(jnp.asarray(mv)), jnp.asarray(X),
                   desc=RefDesc(backend="sellcs"))
    got = mxm(port.with_vals(convert.tensor(mv, device="cpu")),
              convert.tensor(X, device="cpu"),
              desc=Descriptor(backend=backend))
    _check(got, want)


@pytest.mark.parametrize("symmetric", [True, False])
@pytest.mark.parametrize("backend", ["coo", "sellcs"])
@pytest.mark.parametrize("p", [1.2, 1.5, 2.0])
def test_plap_apply_matches_reference(symmetric, backend, p):
    ref, port = _pair(symmetric)
    X = _mv(port.n_rows, 3, 3)
    want = ref_mxm(ref, jnp.asarray(X), ref_plap(p, 1e-8),
                   desc=RefDesc(backend="coo"))
    got = mxm(port, convert.tensor(X, device="cpu"), plap_edge_semiring(p, 1e-8),
              desc=Descriptor(backend=backend))
    _check(got, want)


@pytest.mark.parametrize("symmetric", [True, False])
@pytest.mark.parametrize("backend", ["coo", "sellcs"])
@pytest.mark.parametrize("p", [1.2, 1.5, 2.0])
def test_plap_hvp_matches_reference(symmetric, backend, p):
    ref, port = _pair(symmetric)
    U, E = _mv(port.n_rows, 3, 5), 0.1 * _mv(port.n_rows, 3, 6)
    want = ref_mxm(ref, (jnp.asarray(U), jnp.asarray(E)), ref_hvp(p, 1e-8),
                   desc=RefDesc(backend="coo"))
    got = mxm(port, (convert.tensor(U, device="cpu"),
                     convert.tensor(E, device="cpu")),
              plap_hvp_edge_semiring(p, 1e-8),
              desc=Descriptor(backend=backend))
    _check(got, want)


def test_mask_accum_transpose_match_reference():
    ref, port = _pair(False)
    n = port.n_rows
    X, C = _mv(n, 2, 7), _mv(n, 2, 8)
    mask = np.arange(n) % 3 != 0
    t = lambda a: convert.tensor(a, device="cpu")
    _check(mxm(port, t(X), mask=t(mask)),
           ref_mxm(ref, jnp.asarray(X), mask=jnp.asarray(mask)))
    _check(mxm(port, t(X), mask=t(mask), accum=(torch.add, t(C))),
           ref_mxm(ref, jnp.asarray(X), mask=jnp.asarray(mask),
                   accum=(jnp.add, jnp.asarray(C))))
    _check(vxm(t(X), port), ref_mxm(ref, jnp.asarray(X),
                                    desc=RefDesc(transpose=True)))


def test_auto_picks_sellcs_when_built():
    from repro_torch.grblas import available_backends

    _, port = _pair(True)
    X = torch.zeros((port.n_rows, 2), dtype=torch.float64)
    assert available_backends(port, X)[0] == "sellcs"
    assert available_backends(port, X, desc=Descriptor(transpose=True)) \
        == ["coo"]


def test_named_backend_that_cannot_execute_raises():
    ref, port = _pair(False)
    X = torch.zeros((port.n_rows, 2), dtype=torch.float64)
    with pytest.raises(BackendUnavailableError):      # non-square edge ring
        bare = convert.sparse_matrix(port.host_coo(), (port.n_rows, 100),
                                     device="cpu", build_ell=False)
        mxm(bare, torch.zeros((100, 2), dtype=torch.float64),
            plap_edge_semiring(1.5), desc=Descriptor(backend="sellcs"))
    with pytest.raises(BackendUnavailableError):      # ELL has no edge rings
        mxm(port, X, plap_edge_semiring(1.5), desc=Descriptor(backend="ell"))
    with pytest.raises(BackendUnavailableError):
        mxm(port, X, desc=Descriptor(backend="bsr_pallas"))
