"""Deterministic fault injection for the resilience layer (port of the
solver and backend injectors of ``repro.testing.faultinject``).

Every injector is a context manager that patches ONE well-defined seam —
a registered solver driver or a registered grblas backend — and restores
it on exit, also when the block raises.  Faults are counted, not random:
``at_call`` / ``max_calls`` select exactly which invocations fail, so a
chaos test asserts that a specific recovery-ladder rung fires.
``CHAOS_SEED`` (env var, see ``chaos_seed``) seeds whatever randomness a
test adds on top.

Solver injectors patch ``registry._REGISTRY`` entries, which every
execution path resolves by name at call time (``p_continuation``,
``warm_start``, the guard's ``_run_levels``), so flat, guarded and
multilevel paths all see the injected driver.  ``backend_fault`` swaps
``grblas.backends._REGISTRY[name]``; the port runs eagerly and has no
trace cache that could replay around the dispatch.  The serve injectors
set the clustering serve engine's ``_SOLVE_FAULT`` / ``_CHURN_FAULT``
seams (``serve.psc_engine``).  ``halo_corruption`` sets the distributed
SpMM's halo seam (``grblas.dist.set_halo_fault_hook``) in the process it
runs in: each rank enters it for itself.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
from typing import Iterable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.solvers import registry
from repro_torch.core.solvers.registry import SolverReport, SolverState
from repro_torch.grblas import backends as _backends
from repro_torch.grblas.backends import BackendUnavailableError
from repro_torch.grblas.semiring import EdgeSemiring, PairEdgeSemiring
from repro_torch.obs import metrics as _obs_metrics
from repro_torch.obs import trace as _obs_trace


def chaos_seed(default: int = 0) -> int:
    """The suite-wide seed: ``CHAOS_SEED`` env var, else ``default``.
    Chaos tests derive every random draw from it so a failing run
    reproduces with ``CHAOS_SEED=<n>``."""
    return int(os.environ.get("CHAOS_SEED", default))


@dataclasses.dataclass
class InjectionLog:
    """What actually fired: (site, detail) per injected fault.  Tests
    assert on it so a chaos test that silently injected nothing fails
    loudly instead of vacuously passing.

    Each ``record`` also draws a fresh injection id from
    ``obs.trace.begin_injection`` (stamping a ``fault.<site>`` instant
    on any active tracer) and bumps ``fault_injections_total{site=}`` on
    the DEFAULT metrics registry; the recovery ladder's trace events
    carry the same id (``obs.trace.current_injection``), so a chaos-run
    timeline reads fault → divergence → rungs as one correlated story."""

    events: List[Tuple[str, str]] = dataclasses.field(default_factory=list)
    ids: List[int] = dataclasses.field(default_factory=list)

    def record(self, site: str, detail: str = "") -> None:
        self.ids.append(_obs_trace.begin_injection(site, detail))
        _obs_metrics.DEFAULT.counter("fault_injections_total",
                                     site=site).inc()
        self.events.append((site, detail))

    def count(self, site: Optional[str] = None) -> int:
        if site is None:
            return len(self.events)
        return sum(1 for s, _ in self.events if s == site)


# ------------------------------------------------------------- solver seams

def _names(solvers) -> List[str]:
    if isinstance(solvers, str):
        return [solvers]
    return list(solvers)


@contextlib.contextmanager
def _patched_solvers(names: Iterable[str], wrap):
    """Swap each named registry entry for ``wrap(original_entry)`` —
    a (SolverState, call_index) -> SolverReport hook with a per-entry
    call counter — restoring the originals on exit."""
    saved = {}
    counters = {}
    try:
        for name in names:
            orig = registry.resolve_solver(name)
            saved[name] = orig
            counters[name] = 0

            def make(orig):
                def minimize(state: SolverState) -> SolverReport:
                    counters[orig.name] += 1
                    return wrap(orig, state, counters[orig.name])

                return minimize

            registry._REGISTRY[name] = dataclasses.replace(
                orig, minimize_at_p=make(orig))
        yield
    finally:
        for name, orig in saved.items():
            registry._REGISTRY[name] = orig


@contextlib.contextmanager
def nan_in_multivector(solvers="newton", *, at_call: int = 1,
                       max_calls: Optional[int] = 1,
                       log: Optional[InjectionLog] = None):
    """The named driver(s) return a NaN-poisoned multivector (and NaN
    fval) starting at their ``at_call``-th invocation, for ``max_calls``
    invocations (None = forever) — the blown-up-iterate failure mode.
    Calls outside the window run the real driver."""
    log = log if log is not None else InjectionLog()

    def wrap(orig, state, call):
        if call >= at_call and (max_calls is None
                                or call < at_call + max_calls):
            log.record("nan_in_multivector", f"{orig.name}@call{call}")
            U = torch.full_like(state.U, float("nan"))
            return SolverReport(U=U, fval=float("nan"), n_apply=0,
                                iters=0, converged=False)
        return orig.minimize_at_p(state)

    with _patched_solvers(_names(solvers), wrap):
        yield log


@contextlib.contextmanager
def solver_stall(solvers="newton", *, at_call: int = 1,
                 max_calls: Optional[int] = None,
                 log: Optional[InjectionLog] = None):
    """The named driver(s) return their input unchanged, unconverged —
    zero functional progress, the stall failure mode the guard's
    ``stall_levels`` counter exists for."""
    from repro_torch.core import plap

    log = log if log is not None else InjectionLog()

    def wrap(orig, state, call):
        if call >= at_call and (max_calls is None
                                or call < at_call + max_calls):
            log.record("solver_stall", f"{orig.name}@call{call}")
            f = float(plap.value(state.W, state.U, float(state.p),
                                 state.cfg.eps, desc=state.cfg.descriptor()))
            return SolverReport(U=state.U, fval=f, n_apply=0,
                                iters=0, converged=False)
        return orig.minimize_at_p(state)

    with _patched_solvers(_names(solvers), wrap):
        yield log


@contextlib.contextmanager
def rank_collapse(solvers="newton", *, at_call: int = 1,
                  max_calls: Optional[int] = 1,
                  log: Optional[InjectionLog] = None):
    """The named driver(s) return an embedding whose last column
    duplicates the first — numerically rank-deficient, the
    left-the-Grassmann-chart failure mode."""
    log = log if log is not None else InjectionLog()

    def wrap(orig, state, call):
        rep = orig.minimize_at_p(state)
        if call >= at_call and (max_calls is None
                                or call < at_call + max_calls):
            log.record("rank_collapse", f"{orig.name}@call{call}")
            U = rep.U.clone()
            U[:, -1] = U[:, 0]
            return dataclasses.replace(rep, U=U)
        return rep

    with _patched_solvers(_names(solvers), wrap):
        yield log


# ------------------------------------------------------------ backend seams

@contextlib.contextmanager
def backend_fault(backend: str = "sellcs", *, edge_rings_only: bool = True,
                  log: Optional[InjectionLog] = None):
    """The named grblas backend raises ``BackendUnavailableError`` from
    its execute hook — the kernel-went-down failure mode.  With
    ``edge_rings_only`` (default) plain-semiring ops (the p=2 stage-1
    matvecs) still work and only the hot loop's edge-semiring ops fail,
    mirroring a broken kernel rather than a missing layout.  The
    original backend record is restored on exit."""
    log = log if log is not None else InjectionLog()
    # pscheck: disable=api-boundary (fault injection swaps a backend's execute hook in place; the public registry API is read-only by design)
    orig = _backends._REGISTRY[backend]

    def execute(A, X, ring, desc):
        if not edge_rings_only or isinstance(ring, (EdgeSemiring,
                                                    PairEdgeSemiring)):
            log.record("backend_fault", f"{backend}:{ring.name}")
            raise BackendUnavailableError(
                f"injected fault: backend {backend!r} is down "
                f"(repro_torch.testing.faultinject)")
        return orig.execute(A, X, ring, desc)

    # pscheck: disable=api-boundary (install the faulted hook; restored in the finally below)
    _backends._REGISTRY[backend] = dataclasses.replace(orig, execute=execute)
    try:
        yield log
    finally:
        # pscheck: disable=api-boundary (restore the pre-fault backend record)
        _backends._REGISTRY[backend] = orig


# -------------------------------------------------------------- serve seams

@contextlib.contextmanager
def serve_batch_fault(req_ids, *, exc: Optional[Exception] = None,
                      log: Optional[InjectionLog] = None):
    """The serve engine's batched bucket solve raises whenever the batch
    holds any of ``req_ids`` — the thrown-batch failure that drives
    quarantine bisection (a NaN element, by contrast, is caught by the
    per-element finiteness check without a throw)."""
    from repro_torch.serve import psc_engine as _eng

    log = log if log is not None else InjectionLog()
    bad = set(int(r) for r in np.atleast_1d(req_ids))

    def fault(pends):
        hit = [p.req_id for p in pends if p.req_id in bad]
        if hit:
            log.record("serve_batch_fault", f"req{hit}")
            raise (exc if exc is not None else
                   RuntimeError(f"injected batch fault (requests {hit})"))

    prev = _eng._SOLVE_FAULT
    _eng._SOLVE_FAULT = fault
    try:
        yield log
    finally:
        _eng._SOLVE_FAULT = prev


@contextlib.contextmanager
def serve_churn_fault(*, fail_attempts: int = 1,
                      exc: Optional[Exception] = None,
                      log: Optional[InjectionLog] = None):
    """The churn re-solve raises on its first ``fail_attempts`` attempts
    of each request — the transient fault the retry with backoff is for
    (``fail_attempts > churn_retries`` forces the cold fallback)."""
    from repro_torch.serve import psc_engine as _eng

    log = log if log is not None else InjectionLog()

    def fault(pend, attempt):
        if attempt < fail_attempts:
            log.record("serve_churn_fault",
                       f"req{pend.req_id}@attempt{attempt}")
            raise (exc if exc is not None else
                   RuntimeError(f"injected churn fault (attempt {attempt})"))

    prev = _eng._CHURN_FAULT
    _eng._CHURN_FAULT = fault
    try:
        yield log
    finally:
        _eng._CHURN_FAULT = prev


# --------------------------------------------------------------- dist seams

@contextlib.contextmanager
def halo_corruption(mode: str = "nan", *, shard: int = 0,
                    log: Optional[InjectionLog] = None):
    """Corrupt the received halo block of the distributed SpMM in this
    process (this rank): ``mode="nan"`` poisons the rows received from
    ``shard`` (a corrupted wire payload), ``mode="drop"`` zeroes them (a
    dropped shard: the peer never answered).  Each rank that should see
    the fault enters the context itself."""
    from repro_torch.grblas import dist as _dist

    if mode not in ("nan", "drop"):
        raise ValueError(f"mode must be 'nan' or 'drop', got {mode!r}")
    log = log if log is not None else InjectionLog()
    fill = float("nan") if mode == "nan" else 0.0

    def hook(recv, Ap):
        log.record("halo_corruption", f"{mode}@shard{shard}")
        H = Ap.halo_width
        block = torch.arange(recv.shape[0], device=recv.device) // max(H, 1)
        mask = (block == shard).reshape((-1,) + (1,) * (recv.ndim - 1))
        return torch.where(mask, torch.full_like(recv, fill), recv)

    _dist.set_halo_fault_hook(hook)
    try:
        yield log
    finally:
        _dist.set_halo_fault_hook(None)
