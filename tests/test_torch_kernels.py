"""The SELL-C-σ kernel twins against the reference's Pallas kernels (in
interpret mode) and its ref.py oracles, run by run.

Tolerances: fp64 to 1e-12; fp32 to rtol 2e-4 / atol 2e-5, the bounds of
tests/test_kernels_sparse.py (sums run in another order, and pow may
differ by an ulp between libraries)."""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the reference-only CI has no torch

import jax.numpy as jnp
from repro.grblas import SparseMatrix as RefMatrix
from repro.kernels import sellcs_spmm as RK
from repro_torch import convert

# Small CPU problems: intra-op threads only contend with the other test
# workers.
torch.set_num_threads(1)

K = importlib.import_module("repro_torch.kernels.sellcs_spmm.sellcs_spmm")

TOL = {np.float32: dict(rtol=2e-4, atol=2e-5),
       np.float64: dict(rtol=1e-12, atol=1e-12)}
K_COLS = 3


def _graph(seed=0, n=160):
    """Background degree ~4 plus two hubs, so runs of several widths."""
    rng = np.random.default_rng(seed)
    r = rng.integers(0, n, 2 * n)
    c = rng.integers(0, n, 2 * n)
    hub_r = np.repeat([0, 1], 30)
    hub_c = rng.integers(2, n, hub_r.size)
    rows = np.concatenate([r, c, hub_r, hub_c])
    cols = np.concatenate([c, r, hub_c, hub_r])
    keep = rows != cols
    key = rows[keep] * n + cols[keep]
    _, idx = np.unique(key, return_index=True)
    rows, cols = rows[keep][idx], cols[keep][idx]
    vals = rng.uniform(0.5, 1.5, rows.size)
    return (rows, cols, vals), (n, n)


def _runs(dtype, C=8):
    coo, shape = _graph()
    ref = RefMatrix.from_coo(*coo, shape, dtype=dtype, build_sellcs=True,
                             sell_c=C, sell_w_align=4)
    rng = np.random.default_rng(1)
    Xp = rng.standard_normal((ref.sell_n_pad, K_COLS)).astype(dtype)
    Ep = (0.1 * rng.standard_normal((ref.sell_n_pad, K_COLS))).astype(dtype)
    for r, (cols, vals) in enumerate(zip(ref.sell_cols, ref.sell_vals)):
        yield (ref.sell_row0[r], C, np.asarray(cols), np.asarray(vals), Xp,
               Ep)


def _t(a):
    return convert.tensor(a, device="cpu")


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_reals_twin_matches_pallas_and_ref(dtype):
    for row0, C, cols, vals, Xp, _ in _runs(dtype):
        got = convert.to_numpy(K.sellcs_spmm_ref(_t(cols), _t(vals), _t(Xp)))
        pallas = RK.sellcs_spmm_pallas(jnp.asarray(cols), jnp.asarray(vals),
                                       jnp.asarray(Xp), C, slice0=row0 // C,
                                       interpret=True)
        ref = RK.sellcs_spmm_ref(jnp.asarray(cols), jnp.asarray(vals),
                                 jnp.asarray(Xp))
        np.testing.assert_allclose(got, np.asarray(pallas), **TOL[dtype])
        np.testing.assert_allclose(got, np.asarray(ref), **TOL[dtype])


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_reals_twin_multivalues_match_ref(dtype):
    rng = np.random.default_rng(2)
    for _, _, cols, vals, Xp, _ in _runs(dtype):
        mv = (vals[..., None]
              * rng.uniform(0.5, 2.0, vals.shape + (K_COLS,))).astype(dtype)
        got = convert.to_numpy(K.sellcs_spmm_ref(_t(cols), _t(mv), _t(Xp)))
        ref = RK.sellcs_spmm_ref(jnp.asarray(cols), jnp.asarray(mv),
                                 jnp.asarray(Xp))
        np.testing.assert_allclose(got, np.asarray(ref), **TOL[dtype])


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("p", [1.2, 1.5, 2.0])
@pytest.mark.parametrize("eps", [1e-8, 0.0])
def test_plap_apply_twin_matches_pallas_and_ref(dtype, p, eps):
    for row0, C, cols, vals, Xp, _ in _runs(dtype):
        got = convert.to_numpy(K.sellcs_plap_apply_ref(
            _t(cols), _t(vals), _t(Xp), row0, p, eps))
        pallas = RK.sellcs_plap_apply_pallas(
            jnp.asarray(cols), jnp.asarray(vals), jnp.asarray(Xp), C,
            slice0=row0 // C, p=p, eps=eps, interpret=True)
        ref = RK.sellcs_plap_apply_ref(jnp.asarray(cols), jnp.asarray(vals),
                                       jnp.asarray(Xp), row0, p, eps)
        np.testing.assert_allclose(got, np.asarray(pallas), **TOL[dtype])
        np.testing.assert_allclose(got, np.asarray(ref), **TOL[dtype])


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("p", [1.2, 1.5, 2.0])
def test_plap_hvp_twin_matches_pallas_and_ref(dtype, p):
    eps = 1e-8
    for row0, C, cols, vals, Up, Ep in _runs(dtype):
        got = convert.to_numpy(K.sellcs_plap_hvp_ref(
            _t(cols), _t(vals), _t(Up), _t(Ep), row0, p, eps))
        pallas = RK.sellcs_plap_hvp_pallas(
            jnp.asarray(cols), jnp.asarray(vals), jnp.asarray(Up),
            jnp.asarray(Ep), C, slice0=row0 // C, p=p, eps=eps,
            interpret=True)
        ref = RK.sellcs_plap_hvp_ref(jnp.asarray(cols), jnp.asarray(vals),
                                     jnp.asarray(Up), jnp.asarray(Ep), row0,
                                     p, eps)
        np.testing.assert_allclose(got, np.asarray(pallas), **TOL[dtype])
        np.testing.assert_allclose(got, np.asarray(ref), **TOL[dtype])


def test_pads_contribute_exactly_zero():
    """A row whose every slot is a pad (an isolated vertex) gets exactly 0
    from all three twins, even where phi'(0) = eps^((p-2)/2) is large."""
    n = 40
    rows = np.arange(1, n - 1)
    coo = (np.concatenate([rows, rows + 1]), np.concatenate([rows + 1, rows]),
           np.ones(2 * rows.size))
    W = convert.sparse_matrix(coo, (n, n), device="cpu", dtype=np.float32,
                              build_sellcs=True, sell_c=8)
    U = torch.randn((n, 2), dtype=torch.float32)
    E = torch.randn((n, 2), dtype=torch.float32)
    for Y in (K.sellcs_spmm(W, U), K.sellcs_plap_apply(W, U, 1.2, 1e-8),
              K.sellcs_plap_hvp(W, U, E, 1.2, 1e-8)):
        assert torch.isfinite(Y).all()
        assert float(Y[0].abs().max()) == 0.0


@pytest.mark.parametrize("bad", ["dtype", "shape", "contiguity", "mismatch"])
def test_wrappers_reject_what_the_kernel_does_not_take(bad):
    coo, shape = _graph()
    W = convert.sparse_matrix(coo, shape, device="cpu", dtype=np.float32,
                              build_sellcs=True, sell_c=8)
    X = torch.randn((shape[0], 2), dtype=torch.float32)
    X = {"dtype": X.to(torch.float16), "shape": X[:-1],
         "contiguity": torch.randn((2, shape[0])).T,
         "mismatch": X.double()}[bad]
    with pytest.raises((TypeError, ValueError)):
        K.sellcs_spmm(W, X)
