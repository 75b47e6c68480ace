"""Solver-driver registry for the nonlinear eigenproblem.

Port of ``repro.core.solvers.registry``: the name-keyed registry
(``register_solver`` / ``resolve_solver``), the driver contract
(``SolverState`` in, ``SolverReport`` out), config-time p-range
validation, the p-continuation loop and its warm entry
(``warm_start``).  Each continuation level is a ``solver.level`` span
(``repro_torch.obs``), fenced on the level's U.

Registered drivers (imported by ``core.solvers.__init__``):

  name           p range    regime
  newton         (1, 2]     trust-region Newton + tCG on Gr(k,n)
  scf            (1, 2]     linear eigenproblems on the IRLS-reweighted
                            graph
  inverse_power  [1, 2]     one deflated column at a time, reaching p = 1
  guarded        [1, 2]     health-checked wrapper around any of them
                            (``guard.py``)

The build memo (``memoized``, ``mark_trace``, ``SOLVER_TRACES``,
``TRACE_LISTENERS``) keeps the reference's names with one meaning in
the port: an entry is a *build*.  PyTorch runs eagerly, so the flat
drivers trace and compile nothing and mark nothing; the one memoized
build is the serve engine's batched solve of a shape bucket
(``serve.psc_engine._bucket_solver``), made once per (bucket key,
solver signature) and read by ``obs.retrace``.  ``mark_trace`` bumps
``compiles_total{site=<key head>}`` on ``obs.metrics.DEFAULT`` and
stamps a ``compile`` instant on the active tracer, as in the
reference.  ``backend_bakes_ring_params`` has no counterpart: p and eps
reach the kernels as runtime arguments.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import torch

from repro_torch.obs import metrics as _obs_metrics
from repro_torch.obs import trace as _obs_trace


class SolverUnavailableError(ValueError):
    """The requested solver is not registered."""


@dataclasses.dataclass(frozen=True)
class SolverState:
    """One per-p minimization: minimize F_p over Gr(k,n) from ``U``."""

    W: object                   # SparseMatrix
    U: torch.Tensor             # (n, k) warm start, orthonormal columns
    p: float
    cfg: object                 # PSCConfig


@dataclasses.dataclass(frozen=True)
class SolverReport:
    """The minimizer plus the paper's accounting units."""

    U: torch.Tensor
    fval: float
    n_apply: int                # Hessian applies (the paper's scaling unit)
    iters: int
    converged: bool

    @property
    def n_hvp(self):
        return self.n_apply


@dataclasses.dataclass(frozen=True)
class Solver:
    name: str
    minimize_at_p: Callable     # (SolverState) -> SolverReport
    p_min: float
    p_max: float
    p_min_open: bool = True
    description: str = ""

    def supports_p(self, p: float) -> bool:
        lo_ok = (p > self.p_min) if self.p_min_open else (p >= self.p_min)
        return lo_ok and p <= self.p_max

    def p_range_str(self) -> str:
        return f"{'(' if self.p_min_open else '['}{self.p_min}, {self.p_max}]"


_REGISTRY: Dict[str, Solver] = {}


def register_solver(name: str, *, p_min: float, p_max: float,
                    p_min_open: bool = True, description: str = ""):
    """Decorator: register ``fn`` as the minimize_at_p hook of ``name``."""

    def deco(fn):
        _REGISTRY[name] = Solver(name=name, minimize_at_p=fn, p_min=p_min,
                                 p_max=p_max, p_min_open=p_min_open,
                                 description=description)
        return fn

    return deco


def registered_solvers() -> Dict[str, Solver]:
    return dict(_REGISTRY)


def resolve_solver(name: str) -> Solver:
    solver = _REGISTRY.get(name)
    if solver is None:
        raise SolverUnavailableError(
            f"unknown solver {name!r}; registered: {sorted(_REGISTRY)}")
    return solver


def validate_config(cfg) -> Solver:
    """Resolve the driver and check p_target and every p of the schedule
    against its supported range."""
    solver = resolve_solver(cfg.solver)
    if not (0.0 < cfg.p_factor < 1.0):
        raise ValueError(
            f"p_factor={cfg.p_factor} must lie in (0, 1): the continuation "
            f"schedule p_t = max(p_target, 2.0 * factor^t) must descend")
    ranges = {s.name: s.p_range_str() for s in _REGISTRY.values()}
    if not solver.supports_p(cfg.p_target):
        raise ValueError(
            f"p_target={cfg.p_target} outside solver {solver.name!r} "
            f"supported range {solver.p_range_str()}; per-driver ranges: "
            f"{ranges}")
    for p in p_schedule(cfg):
        if not solver.supports_p(p):
            raise ValueError(
                f"continuation schedule visits p={p} outside solver "
                f"{solver.name!r} supported range {solver.p_range_str()}; "
                f"per-driver ranges: {ranges}")
    return solver


def p_schedule(cfg) -> list:
    """p_t = max(p_target, 2.0 * factor^t), t >= 1."""
    ps, p = [], 2.0
    while True:
        p = max(cfg.p_target, p * cfg.p_factor)
        ps.append(p)
        if p <= cfg.p_target:
            return ps


def minimize_at_p(W, U0, p, cfg) -> SolverReport:
    """One continuation level under the driver ``cfg.solver`` names."""
    return resolve_solver(cfg.solver).minimize_at_p(
        SolverState(W=W, U=U0, p=p, cfg=cfg))


def _run_schedule(W, U0, cfg, ps, **span_attrs):
    """Run the levels ``ps`` under ``cfg.solver``, each warm-started from
    the last and each a ``solver.level`` span."""
    solver = resolve_solver(cfg.solver)
    U = U0
    p_path: List[float] = []
    fvals: List[float] = []
    applies: List[int] = []
    reports: List[SolverReport] = []
    for p in ps:
        with _obs_trace.ACTIVE.span("solver.level", cat="solver",
                                    solver=solver.name, p=float(p),
                                    **span_attrs) as sp:
            rep = solver.minimize_at_p(SolverState(W=W, U=U, p=p, cfg=cfg))
            sp.fence(rep.U)
            sp.set(fval=float(rep.fval), n_apply=int(rep.n_apply),
                   iters=int(rep.iters), converged=bool(rep.converged))
        U = rep.U
        p_path.append(p)
        fvals.append(float(rep.fval))
        applies.append(int(rep.n_apply))
        reports.append(rep)
    return U, p_path, fvals, applies, reports


def p_continuation(W, U0, cfg):
    """Run the whole p schedule, warm-starting each level from the last.
    Returns (U, p_path, fvals, applies, reports)."""
    return _run_schedule(W, U0, cfg, p_schedule(cfg))


def warm_start(W, U0, cfg, p_final: Optional[float] = None,
               steps: int = 1):
    """Enter the continuation at its END instead of replaying the whole
    p schedule: from a previous solve's embedding ``U0`` (any orthonormal
    (n, k) is a feasible Grassmann point), run only the last ``steps``
    schedule values, ending at ``p_final`` (default ``cfg.p_target``);
    ``PSCConfig.init_U`` feeds this entry.  Returns the same
    (U, p_path, fvals, applies, reports) as ``p_continuation``."""
    solver = resolve_solver(cfg.solver)
    p_end = cfg.p_target if p_final is None else float(p_final)
    if not solver.supports_p(p_end):
        raise ValueError(
            f"warm start at p={p_end} outside solver {solver.name!r} "
            f"supported range {solver.p_range_str()}")
    tail = [p for p in p_schedule(cfg) if p >= p_end][-max(int(steps), 1):]
    if not tail or tail[-1] != p_end:
        tail = (tail + [p_end])[-max(int(steps), 1):]
    return _run_schedule(W, U0, cfg, tail, warm=True)


# --- the build memo ------------------------------------------------------

_TRACE_CACHE: Dict[tuple, Callable] = {}
SOLVER_TRACES: List[tuple] = []        # one key appended per build
TRACE_LISTENERS: List[Callable] = []   # extra per-build hooks (key) -> None


def memoized(key: tuple, build: Callable) -> Callable:
    """The built callable for ``key``, building it on first use.
    ``build()`` should call ``mark_trace(key)`` once, so every build is
    observable."""
    fn = _TRACE_CACHE.get(key)
    if fn is None:
        fn = build()
        _TRACE_CACHE[key] = fn
    return fn


def mark_trace(key: tuple) -> None:
    """Record one build of ``key``: append it to ``SOLVER_TRACES``, bump
    ``compiles_total{site=<key head>}`` on the DEFAULT metrics registry,
    stamp a ``compile`` instant on the active tracer and call every
    ``TRACE_LISTENERS`` hook."""
    SOLVER_TRACES.append(key)
    site = str(key[0]) if key else "?"
    _obs_metrics.DEFAULT.counter("compiles_total", site=site).inc()
    _obs_trace.ACTIVE.instant("compile", site=site, key=str(key))
    for fn in TRACE_LISTENERS:
        fn(key)
