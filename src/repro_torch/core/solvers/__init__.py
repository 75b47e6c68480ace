"""repro_torch.core.solvers — the solver-driver registry; importing it
registers the ``newton`` driver."""
from repro_torch.core.solvers.registry import (
    Solver,
    SolverReport,
    SolverState,
    SolverUnavailableError,
    minimize_at_p,
    p_continuation,
    p_schedule,
    register_solver,
    registered_solvers,
    resolve_solver,
    validate_config,
)
from repro_torch.core.solvers import newton  # registers the driver

__all__ = [
    "Solver", "SolverReport", "SolverState", "SolverUnavailableError",
    "minimize_at_p", "p_continuation", "p_schedule", "register_solver",
    "registered_solvers", "resolve_solver", "validate_config", "newton",
]
