"""SCF driver: self-consistent field iteration for the p-Laplacian
eigenproblem (port of ``repro.core.solvers.scf``; Upadhyaya, Jarlebring &
Tudisco, arXiv:2111.09750).

With the edge response frozen at the secant (IRLS) weights

    w-hat_e = w_e * (||d_e||^2 + eps)^{(p-2)/2},   d_e = U[i] - U[j]

the p-Laplacian apply is the ordinary graph Laplacian of the reweighted
graph W-hat at the linearization point.  Each sweep

    1. builds W-hat on W's pattern (``W.with_vals``: on a SELL-C-σ graph
       the reweighted matrix keeps the layout, so its SpMMs run the
       SELL-C-σ reals kernel; on a graph without it, ``coo``),
    2. takes the smallest-k eigenvectors of L(W-hat) with
       ``lobpcg.smallest_eigvecs``, warm-started from U,
    3. orthonormalizes them (QR) and measures the subspace drift
       k - ||V^T U||_F^2 (the sum of squared principal sines, 0 at a fixed
       point),

until the drift falls below ``scf_tol`` or ``scf_sweeps`` sweeps ran.
Each sweep stamps an ``scf.sweep`` instant (p, sweep, drift) on the
active tracer: a no-op call unless tracing is on.  The reweighting is
eager PyTorch: nothing is traced per level.
"""
from __future__ import annotations

import torch

from repro_torch.core import lobpcg, plap
from repro_torch.core.solvers.registry import SolverReport, register_solver
from repro_torch.grblas import api as grb_api
from repro_torch.grblas.semiring import reals_ring
from repro_torch.obs import trace as _obs_trace


@register_solver("scf", p_min=1.0, p_max=2.0, p_min_open=True,
                 description="self-consistent field: linear eigenproblems "
                             "on the IRLS-reweighted graph")
def scf_minimize_at_p(state) -> SolverReport:
    cfg, W, p = state.cfg, state.W, float(state.p)
    desc = cfg.descriptor()
    U = state.U
    k = U.shape[-1]
    rows, cols = W.rows.long(), W.cols.long()

    sweeps, drift = 0, float("inf")
    for _ in range(max(int(cfg.scf_sweeps), 1)):
        d = U[rows] - U[cols]                       # (nnz, k) edge diffs
        g2 = torch.sum(d * d, dim=-1)               # (nnz,) group norm
        Wh = W.with_vals(W.vals * (g2 + cfg.eps) ** ((p - 2.0) / 2.0))
        # the reweighted eigensolve runs the reals ring: forward the
        # configured descriptor only where that backend can serve it
        st_desc = grb_api.capable_desc(Wh, reals_ring, desc, k=k,
                                       dtype=U.dtype)
        _, V = lobpcg.smallest_eigvecs(Wh, k, seed=cfg.seed, desc=st_desc,
                                       X0=U)
        V = torch.linalg.qr(V)[0].contiguous()
        sweeps += 1
        drift = float(k - torch.sum((V.T @ U) ** 2))
        _obs_trace.ACTIVE.instant("scf.sweep", p=p, sweep=sweeps,
                                  drift=drift)
        U = V
        if drift < cfg.scf_tol:
            break

    fval = float(plap.value(W, U, p, cfg.eps, desc=desc))
    return SolverReport(U=U, fval=fval, n_apply=sweeps, iters=sweeps,
                        converged=drift < cfg.scf_tol)
