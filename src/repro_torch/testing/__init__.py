"""repro_torch.testing — deterministic fault injection for the chaos
tests (the solver, backend, serve and halo injectors of ``repro.testing``).
Production code never imports this package."""
from repro_torch.testing.faultinject import (
    InjectionLog,
    backend_fault,
    chaos_seed,
    halo_corruption,
    nan_in_multivector,
    rank_collapse,
    serve_batch_fault,
    serve_churn_fault,
    solver_stall,
)

__all__ = [
    "InjectionLog", "backend_fault", "chaos_seed", "halo_corruption",
    "nan_in_multivector",
    "rank_collapse", "serve_batch_fault", "serve_churn_fault",
    "solver_stall",
]
