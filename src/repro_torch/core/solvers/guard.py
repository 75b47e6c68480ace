"""Guarded solver execution and the recovery ladder (port of
``repro.core.solvers.guard``).

The continuation runs in the delicate p -> 1 regime where iterates can
stall, lose rank or blow up.  This module wraps any registered driver
with per-level health checks and, on divergence, walks a recovery ladder
instead of returning garbage:

  checks (``check_report``, after every continuation level):
    * nonfinite     — NaN/Inf anywhere in the returned U or in F_p(U)
    * f_increase    — F_p(U_out) > F_p(U_in) beyond ``f_increase_tol``
                      (same-p comparison: F_p is re-evaluated at the
                      level's own p on the incoming iterate)
    * rank_collapse — a QR diagonal of U below ``rank_tol``
    * stall         — ``stall_levels`` consecutive unconverged levels
                      with no functional progress
    * exception     — the driver raised a modelled fault: a backend
                      that cannot serve the operands
                      (BackendUnavailableError) or a linear solve that
                      broke down on the iterate (LinAlgError)

  ladder (``resilient_continuation``; each rung recorded in a
  :class:`RecoveryReport`, threaded into ``PSCResult.recovery``):
    1. warm_restart     — the SAME driver from the last-good U on a
                          denser p schedule (sqrt of p_factor by default)
    2. driver_switch    — the next drivers of ``driver_ladder`` (newton
                          -> scf -> inverse_power) from the last-good U
    3. backend_fallback — the remaining schedule on the reference ``coo``
                          backend (a kernel or layout fault cannot follow)
    4. p2_fallback      — the p=2 linear eigensolve: always defined,
                          classical spectral clustering

Only those faults go down the ladder (``RECOVERABLE``).  Any other
exception, such as a kernel that does not build or launch, reaches the
caller: on the card nothing gives way to a plain version.

Every rung that fires shows in three places: ``RecoveryReport.rungs``,
the ``recovery_rungs_total{rung=}`` counter of ``obs.metrics.DEFAULT``
and a ``recovery.<rung>`` span (plus a ``recovery.rung`` instant); a
clean run records none.  The checks cost one extra F_p evaluation, a
finiteness test and a thin QR of U per level, each read back once.

The wrapper is itself a registry entry (``solver="guarded"``), so the
flat pipeline and the V-cycle's coarse solve can opt in without new
plumbing.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional

import torch

from repro_torch.core import plap
from repro_torch.core.solvers import registry
from repro_torch.core.solvers.registry import (SolverReport, SolverState,
                                               register_solver)
from repro_torch.grblas.api import Descriptor
from repro_torch.grblas.backends import BackendUnavailableError
from repro_torch.obs import metrics as _obs_metrics
from repro_torch.obs import trace as _obs_trace


@dataclasses.dataclass(frozen=True)
class GuardConfig:
    """Thresholds of the per-level health checks and the ladder shape.

    ``PSCConfig.guard`` accepts True (defaults), a GuardConfig, or None
    (guard off unless ``solver="guarded"``)."""

    inner: Optional[str] = None       # guarded driver; None = cfg.solver
    f_increase_tol: float = 0.1       # relative F_p increase tolerated
    rank_tol: float = 1e-6            # min |QR diag| of a healthy U
    stall_levels: int = 3             # consecutive no-progress levels
    stall_tol: float = 1e-12          # relative progress below = none
    restart_p_factor: Optional[float] = None   # rung-1 densified ratio;
                                               # None = sqrt(cfg.p_factor)
    driver_ladder: tuple = ("newton", "scf", "inverse_power")
    fallback_backend: str = "coo"     # rung-3 reference backend


class SolverDivergence(RuntimeError):
    """A guarded continuation level failed a health check.  Carries the
    last state known good so recovery can resume instead of restart."""

    def __init__(self, reason: str, *, p: float, level: int,
                 last_good_U=None, last_good_p: Optional[float] = None,
                 report: Optional[SolverReport] = None, detail: str = ""):
        self.reason = reason
        self.p = float(p)
        self.level = int(level)
        self.last_good_U = last_good_U
        self.last_good_p = last_good_p
        self.report = report
        self.detail = detail
        msg = f"solver diverged at p={self.p:.4g} (level {level}): {reason}"
        if detail:
            msg += f" [{detail}]"
        super().__init__(msg)


@dataclasses.dataclass
class RungRecord:
    """One recovery attempt: which rung, with what driver/backend,
    resuming from which p, and whether it brought the solve home."""

    rung: str                   # warm_restart | driver_switch |
                                # backend_fallback | p2_fallback
    driver: str
    backend: str
    p_resume: float
    ok: bool
    detail: str = ""


@dataclasses.dataclass
class RecoveryReport:
    """What the guard saw and what it did about it — threaded into
    ``PSCResult.recovery`` so serve stats and tests can audit recovery
    without log scraping."""

    diverged_reason: Optional[str] = None
    diverged_p: Optional[float] = None
    diverged_level: Optional[int] = None
    rungs: List[RungRecord] = dataclasses.field(default_factory=list)
    recovered: bool = False
    degraded: bool = False      # True when rung 4 (p=2) produced the
                                # final embedding: labels are classical
                                # spectral, not p-spectral

    @property
    def clean(self) -> bool:
        """No divergence was ever observed (the common case)."""
        return self.recovered and self.diverged_reason is None

    @property
    def final_rung(self) -> Optional[str]:
        for rec in reversed(self.rungs):
            if rec.ok:
                return rec.rung
        return None


# The faults the ladder recovers from.  Everything else propagates.
RECOVERABLE = (SolverDivergence, BackendUnavailableError,
               torch.linalg.LinAlgError)


# ------------------------------------------------------------- health checks

def coerce_guard(guard) -> GuardConfig:
    if guard is None or guard is True:
        return GuardConfig()
    if isinstance(guard, GuardConfig):
        return guard
    raise TypeError(f"PSCConfig.guard must be None, True or a GuardConfig, "
                    f"got {type(guard).__name__}")


def _inner_name(cfg, gcfg: GuardConfig) -> str:
    if gcfg.inner is not None:
        return gcfg.inner
    return cfg.solver if cfg.solver != "guarded" else "newton"


def validate_guard(cfg) -> GuardConfig:
    """Config-time applicability of the guarded wrapper: the inner
    driver must exist and support the whole schedule; every ladder name
    must resolve (an unknown driver in the ladder is a config bug, not
    a runtime surprise)."""
    gcfg = coerce_guard(getattr(cfg, "guard", None))
    inner = registry.resolve_solver(_inner_name(cfg, gcfg))
    for p in registry.p_schedule(cfg):
        if not inner.supports_p(p):
            raise ValueError(
                f"guarded inner driver {inner.name!r} does not support "
                f"schedule value p={p} (range {inner.p_range_str()})")
    for name in gcfg.driver_ladder:
        registry.resolve_solver(name)
    if gcfg.restart_p_factor is not None \
            and not (0.0 < gcfg.restart_p_factor < 1.0):
        raise ValueError(f"restart_p_factor={gcfg.restart_p_factor} must "
                         f"lie in (0, 1)")
    if gcfg.stall_levels < 1:
        raise ValueError("stall_levels must be >= 1")
    return gcfg


def _finite(U) -> bool:
    return bool(torch.isfinite(U).all())


def _f_at(W, U, p: float, cfg) -> float:
    return float(plap.value(W, U, p, cfg.eps, desc=cfg.descriptor()))


def check_report(f_in: float, rep: SolverReport,
                 gcfg: GuardConfig) -> Optional[str]:
    """The per-level health check.  Returns the failure reason, or None
    for a healthy report.  ``f_in`` is F_p at the level's own p on the
    INCOMING iterate (same-p comparison — F changes with p, so
    cross-level functional values are not comparable)."""
    if not math.isfinite(rep.fval) or not _finite(rep.U):
        return "nonfinite"
    if math.isfinite(f_in) \
            and rep.fval > f_in + gcfg.f_increase_tol * (abs(f_in) + 1e-12):
        return "f_increase"
    diag = torch.abs(torch.diagonal(torch.linalg.qr(rep.U)[1]))
    if bool(torch.min(diag) < gcfg.rank_tol):
        return "rank_collapse"
    return None


def checked_minimize(state: SolverState,
                     gcfg: Optional[GuardConfig] = None) -> SolverReport:
    """One guarded continuation level: run the inner driver, apply
    ``check_report``, raise :class:`SolverDivergence` on failure."""
    cfg = state.cfg
    gcfg = gcfg if gcfg is not None else coerce_guard(
        getattr(cfg, "guard", None))
    inner = registry.resolve_solver(_inner_name(cfg, gcfg))
    p = float(state.p)
    try:
        f_in = _f_at(state.W, state.U, p, cfg)
        rep = inner.minimize_at_p(state)
    except SolverDivergence:
        raise
    except RECOVERABLE as exc:
        raise SolverDivergence(
            "exception", p=p, level=0, last_good_U=state.U,
            detail=f"{type(exc).__name__}: {exc}") from exc
    reason = check_report(f_in, rep, gcfg)
    if reason is not None:
        raise SolverDivergence(reason, p=p, level=0, last_good_U=state.U,
                               report=rep)
    return rep


@register_solver("guarded", p_min=1.0, p_max=2.0, p_min_open=False,
                 description="health-checked wrapper around any driver "
                             "(GuardConfig.inner); raises SolverDivergence "
                             "instead of returning NaN/garbage")
def guarded_minimize_at_p(state: SolverState) -> SolverReport:
    return checked_minimize(state)


# ------------------------------------------------------------- continuation

class _Records:
    """The (p_path, fvals, applies, reports) accumulator of the pipeline
    contract, mergeable across rungs."""

    def __init__(self):
        self.p_path: List[float] = []
        self.fvals: List[float] = []
        self.applies: List[int] = []
        self.reports: List[SolverReport] = []

    def append(self, p: float, rep: SolverReport):
        self.p_path.append(float(p))
        self.fvals.append(float(rep.fval))
        self.applies.append(int(rep.n_apply))
        self.reports.append(rep)

    def merge(self, other: "_Records"):
        self.p_path += other.p_path
        self.fvals += other.fvals
        self.applies += other.applies
        self.reports += other.reports

    def tuple(self, U):
        return U, self.p_path, self.fvals, self.applies, self.reports


def _run_levels(W, U0, ps, cfg, gcfg: GuardConfig, out: _Records):
    """Run schedule ``ps`` under ``cfg.solver`` with the per-level guard
    + stall tracking.  Appends healthy levels to ``out`` and returns the
    final U; raises SolverDivergence carrying the last-good state."""
    solver = registry.resolve_solver(cfg.solver)
    U = U0
    last_good_p: Optional[float] = None
    stall = 0
    for i, p in enumerate(ps):
        p = float(p)
        try:
            with _obs_trace.ACTIVE.span("solver.level", cat="solver",
                                        solver=solver.name, p=p,
                                        guarded=True) as sp:
                f_in = _f_at(W, U, p, cfg)
                rep = solver.minimize_at_p(
                    SolverState(W=W, U=U, p=p, cfg=cfg))
                sp.fence(rep.U)
                sp.set(fval=float(rep.fval), n_apply=int(rep.n_apply),
                       iters=int(rep.iters), converged=bool(rep.converged))
        except SolverDivergence as exc:
            raise SolverDivergence(
                exc.reason, p=p, level=i, last_good_U=U,
                last_good_p=last_good_p, report=exc.report,
                detail=exc.detail) from exc
        except RECOVERABLE as exc:
            raise SolverDivergence(
                "exception", p=p, level=i, last_good_U=U,
                last_good_p=last_good_p,
                detail=f"{type(exc).__name__}: {exc}") from exc
        reason = check_report(f_in, rep, gcfg)
        if reason is not None:
            raise SolverDivergence(reason, p=p, level=i, last_good_U=U,
                                   last_good_p=last_good_p, report=rep)
        no_progress = (not rep.converged
                       and f_in - rep.fval
                       <= gcfg.stall_tol * (abs(f_in) + 1e-12))
        stall = stall + 1 if no_progress else 0
        U = rep.U
        out.append(p, rep)
        last_good_p = p
        if stall >= gcfg.stall_levels:
            raise SolverDivergence("stall", p=p, level=i, last_good_U=U,
                                   last_good_p=last_good_p, report=rep)
    return U


def _densified_schedule(p_from: float, p_target: float,
                        factor: float) -> List[float]:
    """A geometric schedule from ``p_from`` down to ``p_target`` with
    ratio ``factor`` — rung 1's smaller continuation steps."""
    ps, p = [], p_from
    while True:
        p = max(p_target, p * factor)
        ps.append(p)
        if p <= p_target:
            return ps


def _qr(U) -> torch.Tensor:
    return torch.linalg.qr(U)[0].contiguous()


def _emit_rung(rec: RungRecord) -> None:
    """One recovery-rung firing = exactly one counter increment + one
    trace instant, stamped with the active injection id so chaos-suite
    timelines correlate the fault with the recovery it triggered
    (tests/test_torch_obs.py pins the exactly-once contract)."""
    _obs_metrics.DEFAULT.counter("recovery_rungs_total", rung=rec.rung).inc()
    _obs_trace.ACTIVE.instant(
        "recovery.rung", rung=rec.rung, driver=rec.driver,
        backend=rec.backend, ok=rec.ok, p_resume=rec.p_resume,
        injection_id=_obs_trace.current_injection())


def _emit_divergence(recovery: RecoveryReport) -> None:
    _obs_metrics.DEFAULT.counter(
        "solver_divergence_total",
        reason=str(recovery.diverged_reason)).inc()
    _obs_trace.ACTIVE.instant(
        "solver.divergence", reason=recovery.diverged_reason,
        p=recovery.diverged_p, level=recovery.diverged_level,
        injection_id=_obs_trace.current_injection())


def _ladder(W, U_lg, p_from: float, remaining: List[float], cfg,
            gcfg: GuardConfig, out: _Records, recovery: RecoveryReport):
    """Walk the recovery rungs from the last-good embedding ``U_lg``.
    ``remaining`` is the part of the schedule the primary run never
    finished (possibly the whole schedule).  On success the winning
    rung's records are merged into ``out`` and the final U returned;
    if every rung fails, raises SolverDivergence("unrecoverable")."""
    inner = _inner_name(cfg, gcfg)
    U_lg = _qr(U_lg)
    if not remaining:
        remaining = [float(cfg.p_target)]
    p_target = float(remaining[-1])

    def attempt(rung: str, driver: str, backend: str, fn):
        rec = RungRecord(rung=rung, driver=driver, backend=backend,
                         p_resume=p_from, ok=False)
        try:
            with _obs_trace.ACTIVE.span(f"recovery.{rung}", cat="recovery",
                                        driver=driver, backend=backend,
                                        p_resume=p_from):
                U, recs = fn()
            if not _finite(U):
                raise SolverDivergence("nonfinite", p=p_target, level=0,
                                       last_good_U=U_lg)
            rec.ok = True
            recovery.rungs.append(rec)
            _emit_rung(rec)
            out.merge(recs)
            return U
        except RECOVERABLE as exc:
            rec.detail = f"{type(exc).__name__}: {exc}"
            recovery.rungs.append(rec)
            _emit_rung(rec)
            return None

    # -- rung 1: same driver, warm restart on a densified schedule
    def rung_warm_restart():
        factor = (gcfg.restart_p_factor if gcfg.restart_p_factor is not None
                  else round(math.sqrt(cfg.p_factor), 6))
        sched = _densified_schedule(p_from, p_target, factor)
        base = dataclasses.replace(cfg, solver=inner, p_factor=factor,
                                   init_U=None, multilevel=None)
        recs = _Records()
        U = _run_levels(W, U_lg, sched, base, gcfg, recs)
        return U, recs

    U = attempt("warm_restart", inner, cfg.backend, rung_warm_restart)
    if U is not None:
        recovery.recovered = True
        return U

    # -- rung 2: switch driver, warm-started at the remaining tail
    for cand in gcfg.driver_ladder:
        if cand == inner:
            continue
        solver = registry.resolve_solver(cand)
        if not all(solver.supports_p(float(p)) for p in remaining):
            continue

        def rung_switch(cand=cand):
            base = dataclasses.replace(cfg, solver=cand, init_U=None,
                                       multilevel=None)
            recs = _Records()
            U = _run_levels(W, U_lg, remaining, base, gcfg, recs)
            return U, recs

        U = attempt("driver_switch", cand, cfg.backend, rung_switch)
        if U is not None:
            recovery.recovered = True
            return U

    # -- rung 3: reference backend (a kernel/layout fault cannot follow)
    if cfg.backend != gcfg.fallback_backend:
        def rung_backend():
            base = dataclasses.replace(cfg, solver=inner,
                                       backend=gcfg.fallback_backend,
                                       init_U=None, multilevel=None)
            recs = _Records()
            U = _run_levels(W, U_lg, remaining, base, gcfg, recs)
            return U, recs

        U = attempt("backend_fallback", inner, gcfg.fallback_backend,
                    rung_backend)
        if U is not None:
            recovery.recovered = True
            return U

    # -- rung 4: the p=2 linear solve — classical spectral clustering,
    # always defined; degraded but finite
    def rung_p2():
        from repro_torch.core import lobpcg

        desc = Descriptor(backend=gcfg.fallback_backend)
        _, U2 = lobpcg.smallest_eigvecs(W, cfg.k,
                                        normalized=cfg.normalized_init,
                                        seed=cfg.seed, desc=desc)
        U2 = _qr(U2)
        recs = _Records()
        recs.append(2.0, SolverReport(U=U2, fval=_f_at(W, U2, 2.0, cfg),
                                      n_apply=0, iters=0, converged=False))
        return U2, recs

    U = attempt("p2_fallback", "lobpcg", gcfg.fallback_backend, rung_p2)
    if U is not None:
        recovery.recovered = True
        recovery.degraded = True
        return U

    raise SolverDivergence(
        "unrecoverable", p=p_target, level=0, last_good_U=U_lg,
        detail="every recovery rung failed — the graph itself is likely "
               "corrupt (run graphs.validate.validate_graph) or every "
               "backend is down")


def resilient_continuation(W, U0, cfg):
    """The guarded replacement of ``solvers.p_continuation``: run the
    full schedule under the inner driver; on :class:`SolverDivergence`
    walk the recovery ladder from the last-good state.

    Returns (U, p_path, fvals, applies, reports, recovery) — the
    pipeline 5-tuple plus the :class:`RecoveryReport`."""
    gcfg = coerce_guard(getattr(cfg, "guard", None))
    inner = _inner_name(cfg, gcfg)
    base = dataclasses.replace(cfg, solver=inner, init_U=None,
                               multilevel=None)
    full = [float(p) for p in registry.p_schedule(cfg)]
    out = _Records()
    recovery = RecoveryReport()
    try:
        U = _run_levels(W, U0, full, base, gcfg, out)
        recovery.recovered = True
        return (*out.tuple(U), recovery)
    except SolverDivergence as exc:
        recovery.diverged_reason = exc.reason
        recovery.diverged_p = exc.p
        recovery.diverged_level = exc.level
        _emit_divergence(recovery)
        U_lg = exc.last_good_U if exc.last_good_U is not None else U0
        p_from = exc.last_good_p if exc.last_good_p is not None else 2.0
        remaining = full[len(out.p_path):]
    U = _ladder(W, U_lg, p_from, remaining, cfg, gcfg, out, recovery)
    return (*out.tuple(U), recovery)


def resilient_warm_start(W, U0, cfg):
    """The guarded replacement of ``solvers.warm_start`` (the serve
    engine's repeat-tenant path): run the schedule tail from ``U0``; a
    poisoned warm start (cached NaN, divergence at the tail) falls onto
    the same ladder, ultimately re-deriving the embedding from scratch
    rather than failing the request."""
    gcfg = coerce_guard(getattr(cfg, "guard", None))
    inner = _inner_name(cfg, gcfg)
    base = dataclasses.replace(cfg, solver=inner, init_U=None,
                               multilevel=None)
    full = [float(p) for p in registry.p_schedule(cfg)]
    tail = full[-max(int(cfg.warm_p_steps), 1):]
    out = _Records()
    recovery = RecoveryReport()
    U_start = U0
    try:
        if not _finite(U_start):
            raise SolverDivergence("nonfinite", p=tail[0], level=0,
                                   last_good_U=None,
                                   detail="warm-start embedding is not "
                                          "finite (poisoned cache entry?)")
        U = _run_levels(W, U_start, tail, base, gcfg, out)
        recovery.recovered = True
        return (*out.tuple(U), recovery)
    except SolverDivergence as exc:
        recovery.diverged_reason = exc.reason
        recovery.diverged_p = exc.p
        recovery.diverged_level = exc.level
        _emit_divergence(recovery)
        if exc.last_good_U is not None:
            U_lg, p_from = exc.last_good_U, \
                (exc.last_good_p if exc.last_good_p is not None else 2.0)
        else:
            # the warm start itself was poisoned: restart from a fresh
            # p=2 eigensolve (rung 1 then walks the FULL schedule)
            from repro_torch.core import lobpcg

            _, U_lg = lobpcg.smallest_eigvecs(
                W, cfg.k, normalized=cfg.normalized_init, seed=cfg.seed,
                desc=Descriptor(backend=gcfg.fallback_backend))
            p_from = 2.0
        remaining = tail[len(out.p_path):]
    U = _ladder(W, U_lg, p_from, remaining, cfg, gcfg, out, recovery)
    return (*out.tuple(U), recovery)
