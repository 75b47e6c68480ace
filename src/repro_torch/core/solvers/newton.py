"""Newton driver: trust-region Newton + truncated CG on Gr(k,n), the
paper's solver (port of ``repro.core.solvers.newton``).  One Python call
per p level; p and eps reach the SpMM kernels as runtime arguments, so
nothing is rebuilt between levels."""
from __future__ import annotations

from repro_torch.core import plap
from repro_torch.core.grassmann import rtr_minimize
from repro_torch.core.solvers.registry import SolverReport, register_solver


@register_solver("newton", p_min=1.0, p_max=2.0, p_min_open=True,
                 description="trust-region Newton + tCG on Gr(k,n) "
                             "(the paper's driver)")
def newton_minimize_at_p(state) -> SolverReport:
    cfg, W, p = state.cfg, state.W, float(state.p)
    desc, eps = cfg.descriptor(), cfg.eps
    f = lambda U: plap.value(W, U, p, eps, desc=desc)
    g = lambda U: plap.euc_grad(W, U, p, eps, desc=desc)
    if cfg.hvp_mode == "graphblas":
        h = lambda U, eta: plap.hess_eta_graphblas(W, U, eta, p, eps,
                                                   desc=desc)
    else:
        h = lambda U, eta: plap.hess_eta_matrix_free(W, U, eta, p, eps,
                                                     desc=desc)
    res = rtr_minimize(f, g, h, state.U, max_iters=cfg.newton_iters,
                       tcg_iters=cfg.tcg_iters, grad_tol=cfg.grad_tol)
    return SolverReport(U=res.U, fval=float(res.fval), n_apply=res.n_hvp,
                        iters=res.iters,
                        converged=bool(res.gradnorm <= cfg.grad_tol))
