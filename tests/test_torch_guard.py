"""The port's guarded continuation and its recovery ladder
(``repro_torch.core.solvers.guard``), driven by the port's fault
injectors (``repro_torch.testing``): every rung fires, stall and rank
collapse are caught, a graph that is itself NaN ends in a structured
error, recovery is deterministic, and a healthy guarded run equals the
unguarded one.  Mirrors ``tests/test_chaos.py`` (its solver, backend and
warm-start cases) and the guard cases of
``tests/test_degenerate_graphs.py``; each injected fault also runs on
the reference, and both must walk the same rungs.  The guarded warm
start (``resilient_warm_start``, reached through ``PSCConfig.init_U``)
is held to the reference's on the same U0: the same p path and a
subspace within a largest principal sine of 1e-8, in float64.

A recovered solve is held as the reference holds it: finite U and RCut
within 1.10 x the clean guarded run's."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the reference-only CI has no torch

import jax.numpy as jnp
from repro.core import solvers as ref_solvers
from repro.core.psc import PSCConfig as RefConfig
from repro.core.psc import p_spectral_cluster as ref_cluster
from repro.core.solvers import GuardConfig as RefGuardConfig
from repro.graphs import sbm_graph as ref_sbm_graph
from repro.grblas.containers import SparseMatrix as RefSparseMatrix
from repro.testing import backend_fault as ref_backend_fault
from repro.testing import nan_in_multivector as ref_nan
from repro.testing import rank_collapse as ref_rank_collapse
from repro.testing import solver_stall as ref_stall
from repro_torch import convert
from repro_torch.core.psc import PSCConfig, p_spectral_cluster
from repro_torch.core import solvers
from repro_torch.core.solvers import GuardConfig, SolverDivergence
from repro_torch.grblas import SparseMatrix, backends
from repro_torch.testing import (backend_fault, chaos_seed,
                                 nan_in_multivector, rank_collapse,
                                 solver_stall)

torch.set_num_threads(1)

SEED = chaos_seed()
# a 2-level schedule ([1.7, 1.5]) so mid-continuation faults have a
# last-good level to restart from
_KW = dict(k=4, newton_iters=8, tcg_iters=5, p_target=1.5, p_factor=0.85)


@pytest.fixture(scope="module")
def ref_sbm():
    return ref_sbm_graph([30] * 4, 0.92, 0.03, seed=SEED)


@pytest.fixture(scope="module")
def sbm(ref_sbm):
    W, truth = ref_sbm
    return convert.sparse_matrix(W.host_coo(), (W.n_rows, W.n_cols),
                                 device="cpu"), truth


@pytest.fixture(scope="module")
def clean(sbm):
    W, _ = sbm
    return p_spectral_cluster(W, PSCConfig(guard=True, **_KW))


def _within_10pct(res, clean):
    assert bool(torch.isfinite(res.U).all())
    assert np.isfinite(res.rcut)
    assert res.rcut <= clean.rcut * 1.10 + 1e-9


def _walk(recovery):
    return ([(r.rung, r.driver, r.backend, r.ok) for r in recovery.rungs],
            recovery.diverged_reason, recovery.diverged_level,
            recovery.degraded)


# ---------------------------------------------------------------- the ladder

def test_clean_guarded_run_reports_no_rungs(clean):
    assert clean.recovery is not None
    assert clean.recovery.clean
    assert clean.recovery.rungs == []
    assert clean.recovery.final_rung is None


def test_rung1_warm_restart(sbm, clean):
    W, _ = sbm
    with nan_in_multivector("newton", at_call=2, max_calls=1) as log:
        res = p_spectral_cluster(W, PSCConfig(guard=True, **_KW))
    assert log.count("nan_in_multivector") == 1
    assert res.recovery.diverged_reason == "nonfinite"
    assert res.recovery.diverged_level == 1
    assert res.recovery.final_rung == "warm_restart"
    assert res.recovery.rungs[-1].driver == "newton"
    assert not res.recovery.degraded
    _within_10pct(res, clean)


def test_rung2_driver_switch(sbm, clean):
    W, _ = sbm
    with nan_in_multivector("newton", at_call=1, max_calls=None) as log:
        res = p_spectral_cluster(W, PSCConfig(guard=True, **_KW))
    assert log.count() >= 2
    assert res.recovery.final_rung == "driver_switch"
    assert res.recovery.rungs[-1].driver == "scf"
    assert res.recovery.rungs[0].rung == "warm_restart"
    assert not res.recovery.rungs[0].ok
    _within_10pct(res, clean)


def test_rung3_backend_fallback(sbm, clean):
    W0, _ = sbm
    W = SparseMatrix.from_coo(*W0.host_coo(), (W0.n_rows, W0.n_rows),
                              build_sellcs=True, device="cpu")
    cfg = PSCConfig(guard=True, backend="sellcs", **_KW)
    orig = backends.registered_backends()["sellcs"]
    with backend_fault("sellcs") as log:
        res = p_spectral_cluster(W, cfg)
    assert log.count("backend_fault") >= 1
    assert res.recovery.final_rung == "backend_fallback"
    assert res.recovery.rungs[-1].backend == "coo"
    assert not res.recovery.degraded
    _within_10pct(res, clean)
    # the injector restored the registry: the same config runs clean now
    assert backends.registered_backends()["sellcs"] is orig
    assert p_spectral_cluster(W, cfg).recovery.clean


def test_backend_fault_restores_the_registry_when_the_block_raises():
    orig = backends.registered_backends()["coo"]
    with pytest.raises(RuntimeError, match="inside"):
        with backend_fault("coo"):
            assert backends.registered_backends()["coo"] is not orig
            raise RuntimeError("inside")
    assert backends.registered_backends()["coo"] is orig


def test_kernel_failure_reaches_the_caller(sbm, monkeypatch):
    """A fault the ladder does not model, such as a kernel that fails
    to build or launch, is not recovered on the coo backend: it reaches
    the caller and no rung fires."""
    W0, _ = sbm
    W = SparseMatrix.from_coo(*W0.host_coo(), (W0.n_rows, W0.n_rows),
                              build_sellcs=True, device="cpu")
    orig = backends.registered_backends()["sellcs"]

    def execute(A, X, ring, desc):
        raise RuntimeError("sellcs kernel failed to launch")

    monkeypatch.setitem(backends._REGISTRY, "sellcs",
                        dataclasses.replace(orig, execute=execute))
    with pytest.raises(RuntimeError, match="failed to launch"):
        p_spectral_cluster(W, PSCConfig(guard=True, backend="sellcs", **_KW))


def test_rung4_p2_fallback(sbm, clean):
    W, _ = sbm
    with nan_in_multivector(["newton", "scf", "inverse_power"],
                            at_call=1, max_calls=None) as log:
        res = p_spectral_cluster(W, PSCConfig(guard=True, **_KW))
    assert log.count() >= 3
    assert res.recovery.final_rung == "p2_fallback"
    assert res.recovery.degraded
    rungs = [r.rung for r in res.recovery.rungs]
    assert rungs.count("warm_restart") == 1 and "driver_switch" in rungs
    _within_10pct(res, clean)


def test_stall_detected(sbm, clean):
    W, _ = sbm
    cfg = PSCConfig(guard=GuardConfig(stall_levels=2), **_KW)
    with solver_stall("newton") as log:
        res = p_spectral_cluster(W, cfg)
    assert log.count("solver_stall") >= 2
    assert res.recovery.diverged_reason == "stall"
    assert res.recovery.final_rung is not None
    _within_10pct(res, clean)


def test_rank_collapse_detected(sbm, clean):
    W, _ = sbm
    with rank_collapse("newton", at_call=1, max_calls=1) as log:
        res = p_spectral_cluster(W, PSCConfig(guard=True, **_KW))
    assert log.count("rank_collapse") == 1
    assert res.recovery.diverged_reason == "rank_collapse"
    assert res.recovery.final_rung == "warm_restart"
    _within_10pct(res, clean)


def test_unguarded_vs_guarded_equal_when_healthy(sbm):
    """The guard only observes a healthy run: same labels, HVP counts,
    continuation path and RCut as the raw driver, also as
    ``solver="guarded"``."""
    W, _ = sbm
    raw = p_spectral_cluster(W, PSCConfig(**_KW))
    for cfg in (PSCConfig(guard=True, **_KW),
                PSCConfig(solver="guarded", **_KW)):
        guarded = p_spectral_cluster(W, cfg)
        np.testing.assert_array_equal(raw.labels, guarded.labels)
        assert raw.p_path == guarded.p_path
        assert raw.hvp_counts == guarded.hvp_counts
        assert raw.rcut == guarded.rcut


def test_unrecoverable_graph_raises_structured(sbm):
    W0, _ = sbm
    r, c, v = W0.host_coo()
    W = SparseMatrix.from_coo(r, c, np.full_like(v, np.nan),
                              (W0.n_rows, W0.n_rows), device="cpu")
    with pytest.raises(SolverDivergence, match="unrecoverable"):
        p_spectral_cluster(W, PSCConfig(guard=True, **_KW))


def test_chaos_determinism(sbm):
    W, _ = sbm
    runs = []
    for _ in range(2):
        with nan_in_multivector("newton", at_call=1, max_calls=None):
            runs.append(p_spectral_cluster(W, PSCConfig(guard=True, **_KW)))
    np.testing.assert_array_equal(runs[0].labels, runs[1].labels)
    assert _walk(runs[0].recovery) == _walk(runs[1].recovery)


def test_guard_config_validation():
    with pytest.raises(ValueError, match="restart_p_factor"):
        PSCConfig(guard=GuardConfig(restart_p_factor=1.5))
    with pytest.raises(ValueError, match="stall_levels"):
        PSCConfig(guard=GuardConfig(stall_levels=0))
    with pytest.raises(ValueError, match="registered"):
        PSCConfig(guard=GuardConfig(driver_ladder=("newton", "nope")))
    with pytest.raises(TypeError):
        PSCConfig(guard="yes")
    with pytest.raises(ValueError, match="inner driver"):
        PSCConfig(guard=GuardConfig(inner="newton"), solver="inverse_power",
                  p_target=1.0)


# ---------------------------------------- the same faults on the reference

# fault -> (port injector, reference injector, config fields given the
# package's GuardConfig)
_FAULTS = {
    "nan_level2": (lambda: nan_in_multivector("newton", at_call=2),
                   lambda: ref_nan("newton", at_call=2), lambda G: {}),
    "nan_always": (lambda: nan_in_multivector("newton", at_call=1,
                                              max_calls=None),
                   lambda: ref_nan("newton", at_call=1, max_calls=None),
                   lambda G: {}),
    "stall": (lambda: solver_stall("newton"), lambda: ref_stall("newton"),
              lambda G: dict(guard=G(stall_levels=2))),
    "rank_collapse": (lambda: rank_collapse("newton"),
                      lambda: ref_rank_collapse("newton"), lambda G: {}),
    "backend_sellcs": (lambda: backend_fault("sellcs"),
                       lambda: ref_backend_fault("sellcs"),
                       lambda G: dict(backend="sellcs")),
}


@pytest.mark.parametrize("fault", sorted(_FAULTS))
def test_ladder_walks_the_references_rungs(ref_sbm, fault):
    """The same fault on both packages: the same divergence and the same
    rungs, with the same drivers and backends, each succeeding or
    failing alike."""
    inject, ref_inject, extra = _FAULTS[fault]
    W, _ = ref_sbm
    r, c, v = W.host_coo()
    Wr = RefSparseMatrix.from_coo(r, c, v, (W.n_rows, W.n_rows),
                                  build_sellcs=True)
    Wp = SparseMatrix.from_coo(r, c, v, (W.n_rows, W.n_rows),
                               build_sellcs=True, device="cpu")
    with inject():
        res = p_spectral_cluster(Wp, PSCConfig(**{
            **_KW, "guard": True, **extra(GuardConfig)}))
    with ref_inject():
        ref = ref_cluster(Wr, RefConfig(**{
            **_KW, "guard": True, **extra(RefGuardConfig)}))
    assert _walk(res.recovery) == _walk(ref.recovery)


# ------------------------------------------------ degenerate graphs, guarded

def _sym(pairs, n, w=1.0):
    r = [a for a, b in pairs] + [b for a, b in pairs]
    c = [b for a, b in pairs] + [a for a, b in pairs]
    return SparseMatrix.from_coo(np.array(r), np.array(c),
                                 np.full(len(r), w), (n, n), device="cpu")


def test_star_graph_flat_and_guarded():
    n = 9
    W = _sym([(0, i) for i in range(1, n)], n)
    for guard in (None, True):
        res = p_spectral_cluster(W, PSCConfig(
            k=2, guard=guard, newton_iters=6, tcg_iters=4))
        assert np.isfinite(res.rcut)
        assert len(set(res.labels.tolist())) == 2
        if guard:
            assert res.recovery.clean


def test_guarded_validated_disconnected_cliques():
    """guard and validate together: each component's solve is guarded
    and the two cliques come back as the two clusters."""
    pairs = [(i, j) for i in range(10) for j in range(i + 1, 10)]
    pairs += [(i, j) for i in range(10, 24) for j in range(i + 1, 24)]
    W = _sym(pairs, 24)
    res = p_spectral_cluster(W, PSCConfig(k=2, guard=True, validate=True))
    assert res.rcut == 0.0 and len(res.components) == 2
    assert len(set(res.labels[:10].tolist())) == 1
    assert res.labels[0] != res.labels[10]


# ------------------------------------------------------- guarded warm start

def _sin_theta(A, B):
    """Largest principal sine between the column spaces of A and B."""
    Qa = np.linalg.qr(np.asarray(A))[0]
    Qb = np.linalg.qr(np.asarray(B))[0]
    return float(np.linalg.norm(Qb - Qa @ (Qa.T @ Qb), 2))


@pytest.fixture(scope="module")
def sbm64():
    ref, _ = ref_sbm_graph([20, 20, 20], 0.5, 0.05, seed=3,
                           dtype=jnp.float64)
    port = convert.sparse_matrix(ref.host_coo(), (ref.n_rows, ref.n_cols),
                                 device="cpu")
    U0 = np.linalg.qr(np.random.default_rng(0).standard_normal(
        (ref.n_rows, 3)))[0]
    return ref, port, U0


_WARM = dict(k=3, p_target=1.2, solver="scf", scf_sweeps=2, warm_p_steps=2,
             kmeans_restarts=2)


def test_resilient_warm_start_equals_the_reference(sbm64):
    """``resilient_warm_start`` reads ``cfg.warm_p_steps``: the guarded
    schedule tail from U0, with the reference's p path and subspace."""
    ref, W, U0 = sbm64
    U, p_path, fvals, applies, reports, rec = solvers.resilient_warm_start(
        W, convert.tensor(U0, device="cpu"), PSCConfig(guard=True, **_WARM))
    rU, rp, rf, ra, _, rrec = ref_solvers.resilient_warm_start(
        ref, jnp.asarray(U0), RefConfig(guard=True, reorder="none", **_WARM))
    assert p_path == rp and len(p_path) == 2 and p_path[-1] == 1.2
    assert applies == list(ra) and len(reports) == 2
    np.testing.assert_allclose(fvals, rf, rtol=1e-8)
    assert rec.clean and rrec.clean
    assert _sin_theta(convert.to_numpy(U), rU) <= 1e-8


def test_guarded_warm_solve_through_init_U_equals_the_reference(sbm64):
    ref, W, U0 = sbm64
    res = p_spectral_cluster(W, PSCConfig(init_U=U0, guard=True, **_WARM))
    want = ref_cluster(ref, RefConfig(init_U=jnp.asarray(U0), guard=True,
                                      reorder="none", **_WARM))
    assert res.p_path == want.p_path
    assert res.recovery is not None and res.recovery.clean
    assert res.init_labels is None and np.isnan(res.init_rcut)
    assert _sin_theta(convert.to_numpy(res.U), want.U) <= 1e-8
    # solver="guarded" takes the same path
    res2 = p_spectral_cluster(W, PSCConfig(
        init_U=U0, guard=GuardConfig(inner="scf"),
        **dict(_WARM, solver="guarded")))
    assert res2.p_path == res.p_path
    assert _sin_theta(convert.to_numpy(res2.U), want.U) <= 1e-8


def test_guarded_warm_start_survives_poisoned_init(sbm, clean):
    """A NaN warm-start embedding (a poisoned cache entry) falls onto the
    ladder and re-derives the solve from a fresh p=2 start."""
    W, _ = sbm
    bad = np.full((W.n_rows, 4), np.nan, np.float32)
    res = p_spectral_cluster(W, PSCConfig(guard=True, init_U=bad, **_KW))
    assert res.recovery.diverged_reason == "nonfinite"
    assert res.recovery.recovered
    _within_10pct(res, clean)
