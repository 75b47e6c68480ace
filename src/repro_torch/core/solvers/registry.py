"""Solver-driver registry for the nonlinear eigenproblem.

Port of ``repro.core.solvers.registry`` as far as the ``newton`` driver
needs it: the name-keyed registry (``register_solver`` /
``resolve_solver``), the driver contract (``SolverState`` in,
``SolverReport`` out), config-time p-range validation, and the
p-continuation loop.  The reference's ``scf``, ``inverse_power`` and
``guarded`` drivers are not ported yet (ROADMAP.md queue 1, item 10); the
jit trace memo has no counterpart (PyTorch runs eagerly, and p and eps
reach the kernels as runtime arguments).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List

import torch

# drivers the reference has and the port does not yet
UNPORTED_SOLVERS = ("scf", "inverse_power", "guarded")


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
        if name in UNPORTED_SOLVERS:
            raise NotImplementedError(
                f"solver {name!r} is not ported yet (ROADMAP.md queue 1, "
                "item 10); the port runs 'newton'")
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
    if not solver.supports_p(cfg.p_target):
        raise ValueError(
            f"p_target={cfg.p_target} outside solver {solver.name!r} "
            f"supported range {solver.p_range_str()}")
    for p in p_schedule(cfg):
        if not solver.supports_p(p):
            raise ValueError(
                f"continuation schedule visits p={p} outside solver "
                f"{solver.name!r} supported range {solver.p_range_str()}")
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


def p_continuation(W, U0, cfg):
    """Run the whole p schedule, warm-starting each level from the last.
    Returns (U, p_path, fvals, applies, reports)."""
    solver = resolve_solver(cfg.solver)
    U = U0
    p_path: List[float] = []
    fvals: List[float] = []
    applies: List[int] = []
    reports: List[SolverReport] = []
    for p in p_schedule(cfg):
        rep = solver.minimize_at_p(SolverState(W=W, U=U, p=p, cfg=cfg))
        U = rep.U
        p_path.append(p)
        fvals.append(float(rep.fval))
        applies.append(int(rep.n_apply))
        reports.append(rep)
    return U, p_path, fvals, applies, reports
