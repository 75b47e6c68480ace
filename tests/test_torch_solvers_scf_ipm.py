"""The solver-driver registry of the port with its three drivers (newton,
scf, inverse_power) against the reference, from identical inputs: the
dispatch and p-range rules, the report contract, one scf level and one
inverse_power level held to the reference's own outputs, the warm entry,
and the drivers threaded through the pipeline, the V-cycle and
``partition``.

Tolerances: scf's subspace by principal angles, its largest sine
<= 1e-8 in float64 (n <= 1024: both sides take the dense eigh path);
inverse_power's U and F_p within 1e-8 relative in float64 at p = 1.5 and
1.2 (its accept/reject branch compares values, so a value that rounds
differently can flip a step: the comparison stays away from p = 1, where
the smoothed functional is nearly flat).  The reference's
``test_property_scf_driver_well_posed`` fails in the reference itself, so
the port is held to the reference's outputs, not to that property."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the reference-only CI has no torch

import jax.numpy as jnp
from repro.core import PSCConfig as RefConfig
from repro.core import solvers as ref_solvers
from repro.graphs import ring_of_cliques as ref_ring_of_cliques
from repro.graphs import sbm_graph as ref_sbm_graph
from repro_torch import convert
from repro_torch.core import metrics, solvers
from repro_torch.core.psc import PSCConfig, p_spectral_cluster
from repro_torch.core.solvers import (SolverReport, SolverUnavailableError)
from repro_torch.graphs import gaussian_blobs_knn, ring_of_cliques, sbm_graph

torch.set_num_threads(1)

SOLVERS = ("newton", "scf", "inverse_power")


def _cfg(solver, **kw):
    base = dict(k=4, p_target=1.4, newton_iters=15, tcg_iters=10,
                kmeans_restarts=4, seed=0, scf_sweeps=10, ipm_iters=100)
    base.update(kw)
    return PSCConfig(solver=solver, **base)


def _sin_theta(A, B):
    """Largest principal sine between the column spaces of A and B."""
    Qa = np.linalg.qr(A)[0]
    Qb = np.linalg.qr(B)[0]
    return float(np.linalg.norm(Qb - Qa @ (Qa.T @ Qb), 2))


@pytest.fixture(scope="module")
def sbm64():
    """A float64 planted partition (n = 60) and a seeded orthonormal start
    block, the same numbers on both sides."""
    W, _ = ref_sbm_graph([20, 20, 20], 0.5, 0.05, seed=3, dtype=jnp.float64)
    port = convert.sparse_matrix(W.host_coo(), (W.n_rows, W.n_cols),
                                 device="cpu")
    U0 = np.linalg.qr(np.random.default_rng(0).standard_normal(
        (W.n_rows, 3)))[0]
    return W, port, U0


# ----------------------------------------------------------- dispatch rules

def test_registry_has_all_three_drivers():
    reg = solvers.registered_solvers()
    assert set(SOLVERS) | {"guarded"} <= set(reg)
    for name in SOLVERS:
        s = solvers.resolve_solver(name)
        assert s.name == name and callable(s.minimize_at_p)
    for name in SOLVERS + ("guarded",):
        ref = ref_solvers.resolve_solver(name)
        assert solvers.resolve_solver(name).p_range_str() == ref.p_range_str()


def test_unknown_solver_raises_loudly():
    with pytest.raises(SolverUnavailableError, match="registered"):
        solvers.resolve_solver("does_not_exist")
    assert issubclass(SolverUnavailableError, ValueError)
    with pytest.raises(SolverUnavailableError):
        PSCConfig(solver="does_not_exist")


def test_p_range_validation_at_config_time():
    with pytest.raises(ValueError, match="supported range"):
        PSCConfig(p_target=2.5)
    with pytest.raises(ValueError, match="supported range"):
        PSCConfig(p_target=1.0)            # newton's range is open at 1
    with pytest.raises(ValueError, match="supported range"):
        PSCConfig(p_target=0.5, solver="inverse_power")
    with pytest.raises(ValueError, match="p_factor"):
        PSCConfig(p_factor=1.0)
    assert PSCConfig(p_target=1.0, solver="inverse_power").p_target == 1.0
    ipm = solvers.resolve_solver("inverse_power")
    newton = solvers.resolve_solver("newton")
    assert ipm.supports_p(1.0) and not newton.supports_p(1.0)
    assert all(solvers.resolve_solver(s).supports_p(1.4) for s in SOLVERS)


@pytest.mark.parametrize("name", SOLVERS)
def test_driver_contract_report_fields(name):
    """Every driver answers with a SolverReport of the reference's shape
    and accounting: the same n_apply and iters from the same start."""
    W, _ = ref_ring_of_cliques(3, 8, dtype=jnp.float64)
    port = convert.sparse_matrix(W.host_coo(), (W.n_rows, W.n_cols),
                                 device="cpu")
    U0 = np.linalg.qr(np.ones((W.n_rows, 3))
                      + np.arange(W.n_rows * 3.).reshape(W.n_rows, 3))[0]
    kw = dict(k=3, ipm_iters=30, scf_sweeps=4, p_target=1.4)
    rep = solvers.minimize_at_p(port, convert.tensor(U0, device="cpu"), 1.5,
                                _cfg(name, **kw))
    ref = ref_solvers.minimize_at_p(W, jnp.asarray(U0), 1.5,
                                    RefConfig(solver=name, **kw))
    assert isinstance(rep, SolverReport)
    assert rep.U.shape == (W.n_rows, 3) and rep.U.device.type == "cpu"
    assert np.isfinite(rep.fval)
    assert rep.n_apply > 0 and rep.iters > 0
    assert rep.n_hvp == rep.n_apply
    if name != "newton":       # newton's counts are held in test_torch_solvers
        assert (rep.n_apply, rep.iters, rep.converged) == \
            (ref.n_apply, ref.iters, ref.converged)


# ------------------------------------------- one level against the reference

@pytest.mark.parametrize("p", [1.8, 1.4, 1.1])
def test_scf_level_matches_reference(sbm64, p):
    W, port, U0 = sbm64
    kw = dict(k=3, p_target=1.1, scf_sweeps=3)
    ref = ref_solvers.minimize_at_p(W, jnp.asarray(U0), p,
                                    RefConfig(solver="scf", **kw))
    rep = solvers.minimize_at_p(port, convert.tensor(U0, device="cpu"), p,
                                _cfg("scf", **kw))
    assert _sin_theta(convert.to_numpy(rep.U), np.asarray(ref.U)) <= 1e-8
    assert rep.fval == pytest.approx(ref.fval, rel=1e-8)
    assert (rep.n_apply, rep.iters, rep.converged) == \
        (ref.n_apply, ref.iters, ref.converged)
    U = convert.to_numpy(rep.U)
    np.testing.assert_allclose(U.T @ U, np.eye(3), atol=1e-12)


@pytest.mark.parametrize("p,iters", [(1.5, 30), (1.5, 100), (1.2, 60)])
def test_inverse_power_level_matches_reference(sbm64, p, iters):
    W, port, U0 = sbm64
    kw = dict(k=3, p_target=1.0, ipm_iters=iters)
    ref = ref_solvers.minimize_at_p(W, jnp.asarray(U0), p,
                                    RefConfig(solver="inverse_power", **kw))
    rep = solvers.minimize_at_p(port, convert.tensor(U0, device="cpu"), p,
                                _cfg("inverse_power", **kw))
    U, rU = convert.to_numpy(rep.U), np.asarray(ref.U)
    assert np.abs(U - rU).max() <= 1e-8 * np.abs(rU).max()
    assert rep.fval == pytest.approx(ref.fval, rel=1e-8)
    assert rep.n_apply == ref.n_apply == 2 * 3 * iters


def test_warm_start_runs_the_schedule_tail(sbm64):
    """The warm entry replays only the last ``steps`` schedule values,
    ending at p_target, with the reference's p path and, under scf, its
    subspace."""
    W, port, U0 = sbm64
    kw = dict(k=3, p_target=1.2, scf_sweeps=2)
    U, p_path, fvals, applies, reports = solvers.warm_start(
        port, convert.tensor(U0, device="cpu"), _cfg("scf", **kw), steps=2)
    rU, rp, rf, ra, _ = ref_solvers.warm_start(
        W, jnp.asarray(U0), RefConfig(solver="scf", **kw), steps=2)
    assert p_path == rp and p_path[-1] == 1.2 and len(p_path) == 2
    assert applies == ra and len(reports) == 2
    np.testing.assert_allclose(fvals, rf, rtol=1e-8)
    assert _sin_theta(convert.to_numpy(U), np.asarray(rU)) <= 1e-8
    with pytest.raises(ValueError, match="supported range"):
        solvers.warm_start(port, convert.tensor(U0, device="cpu"),
                           _cfg("scf", **kw), p_final=1.0)


# ------------------------------------------------------ pipeline threading

@pytest.fixture(scope="module")
def planted():
    return sbm_graph([30, 30, 30, 30], p_in=0.5, p_out=0.03, seed=5,
                     device="cpu")


@pytest.mark.parametrize("name", SOLVERS)
def test_every_driver_recovers_the_planted_partition(planted, name):
    W, truth = planted
    res = p_spectral_cluster(W, _cfg(name))
    assert metrics.clustering_accuracy(res.labels, truth, 4) == 1.0
    assert len(res.p_path) == len(res.hvp_counts) == len(res.reports)


def test_inverse_power_reaches_p_one():
    W, truth = ring_of_cliques(4, 10, device="cpu")
    res = p_spectral_cluster(W, _cfg("inverse_power", p_target=1.0,
                                     ipm_iters=80))
    assert res.p_path[-1] == 1.0
    assert metrics.clustering_accuracy(res.labels, truth, 4) == 1.0
    assert all(np.isfinite(v) for v in res.fvals)


def test_vcycle_per_level_solver_choice():
    """Cheap scf sweeps on the coarse level, newton refinement on top;
    then scf on both."""
    from repro_torch.multilevel import MultilevelConfig

    W, truth = gaussian_blobs_knn(120, 4, seed=1, device="cpu")
    ml = MultilevelConfig(coarse_size=64, max_levels=6, coarse_solver="scf")
    res = p_spectral_cluster(W, _cfg("newton", newton_iters=10, tcg_iters=8,
                                     multilevel=ml, scf_sweeps=8))
    assert metrics.clustering_accuracy(res.labels, truth, 4) >= 0.95
    assert res.levels and all(r["solver"] == "newton" for r in res.levels)
    ml2 = MultilevelConfig(coarse_size=64, max_levels=6,
                           coarse_solver="scf", refine_solver="scf")
    res2 = p_spectral_cluster(W, _cfg("newton", multilevel=ml2,
                                      scf_sweeps=8))
    assert metrics.clustering_accuracy(res2.labels, truth, 4) >= 0.95
    assert res2.levels and all(r["solver"] == "scf" for r in res2.levels)


def test_partition_threads_solver():
    from repro_torch.graphs.partition import partition

    W, _ = gaussian_blobs_knn(40, 2, seed=3, device="cpu")
    labels, info = partition(W, 2, solver="scf", multilevel=False)
    sizes = info["sizes"]
    assert sum(sizes) == W.n_rows and min(sizes) > 0
    assert np.isfinite(info["rcut"]) and labels.shape == (W.n_rows,)
