"""repro_torch.core.solvers — the solver-driver registry.  Importing it
registers the three drivers (newton, scf, inverse_power) and the
health-checked wrapper ``guarded``."""
from repro_torch.core.solvers.registry import (
    SOLVER_TRACES,
    Solver,
    SolverReport,
    SolverState,
    SolverUnavailableError,
    mark_trace,
    memoized,
    minimize_at_p,
    p_continuation,
    p_schedule,
    register_solver,
    registered_solvers,
    resolve_solver,
    validate_config,
    warm_start,
)
from repro_torch.core.solvers import newton, scf, inverse_power  # register
from repro_torch.core.solvers import guard  # registers "guarded"
from repro_torch.core.solvers.guard import (
    GuardConfig,
    RecoveryReport,
    RungRecord,
    SolverDivergence,
    resilient_continuation,
    resilient_warm_start,
)

__all__ = [
    "SOLVER_TRACES", "Solver", "SolverReport", "SolverState",
    "SolverUnavailableError", "mark_trace", "memoized", "minimize_at_p",
    "p_continuation", "p_schedule", "register_solver", "registered_solvers",
    "resolve_solver", "validate_config", "warm_start",
    "newton", "scf", "inverse_power", "guard", "GuardConfig",
    "RecoveryReport", "RungRecord", "SolverDivergence",
    "resilient_continuation", "resilient_warm_start",
]
