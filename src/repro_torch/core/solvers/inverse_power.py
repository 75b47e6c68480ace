"""Inverse-power driver for the p -> 1 end (port of
``repro.core.solvers.inverse_power``; Hein & Bühler, "An inverse power
method for nonlinear eigenproblems", NIPS 2010).

One nonlinear eigenvector at a time: column l minimizes the smoothed
single-column p-Rayleigh quotient by projected-gradient descent with
backtracking step control, kept orthogonal to the l columns already
found (Gram-Schmidt deflation after every step).  The sequential scheme
stays well-posed as p -> 1, where the joint Grassmann trust-region model
degenerates, so this driver registers the closed range [1, 2]: it is the
one that reaches p = 1.

Each column runs ``ipm_iters`` steps of a Python loop in which the
accepted iterate, its value and the step size stay on the device: the
accept/reject branch is a ``torch.where``, never a host read, so the
loop queues its kernels without waiting for them.  Every gradient and
value goes through ``plap`` under the configured descriptor: on a
SELL-C-σ graph, the p-Laplacian apply kernel at k = 1.
"""
from __future__ import annotations

import torch

from repro_torch.core import plap
from repro_torch.core.solvers.registry import SolverReport, register_solver


def _column(W, Ufull, mask, u0, p, eps, iters, lr0, desc):
    """Minimize the one-column quotient from ``u0``, deflated against the
    columns of ``Ufull`` that ``mask`` selects.  Returns (u, f_u), both on
    the device."""

    def fval(u):
        return plap.value(W, u[:, None], p, eps, desc=desc)

    def deflate(x):
        return x - Ufull @ (mask * (Ufull.T @ x))

    def project(u):
        u = deflate(u)
        return u / torch.clamp(torch.linalg.norm(u), min=1e-12)

    u = project(u0)
    lr = torch.full((), lr0, dtype=u.dtype, device=u.device)
    f_u = fval(u)
    for _ in range(iters):
        g = plap.euc_grad(W, u[:, None], p, eps, desc=desc)[:, 0]
        # project to the feasible tangent (deflation + sphere)
        g = deflate(g)
        g = g - u * torch.dot(u, g)
        u_try = project(u - lr * g)
        f_try = fval(u_try)
        better = f_try < f_u
        u = torch.where(better, u_try, u)
        f_u = torch.where(better, f_try, f_u)
        lr = torch.where(better, lr * 1.1, lr * 0.5)
    return u, f_u


@register_solver("inverse_power", p_min=1.0, p_max=2.0, p_min_open=False,
                 description="sequential deflated inverse power method "
                             "(p -> 1 / sparsest-cut end)")
def inverse_power_minimize_at_p(state) -> SolverReport:
    cfg, W, p = state.cfg, state.W, float(state.p)
    desc = cfg.descriptor()
    U = state.U.clone()
    k = U.shape[-1]
    iters = int(cfg.ipm_iters)
    mask = torch.zeros(k, dtype=U.dtype, device=U.device)
    f_cols = []
    for l in range(k):
        u, f_u = _column(W, U, mask, U[:, l], p, cfg.eps, iters,
                         float(cfg.ipm_lr0), desc)
        U[:, l] = u
        mask[l] = 1.0
        f_cols.append(f_u)
    fval = float(torch.sum(torch.stack(f_cols)))    # the level's one sync
    # one gradient and one value SpMM per step per column (the paper's
    # operator-apply accounting unit)
    return SolverReport(U=U, fval=fval, n_apply=2 * k * iters, iters=iters,
                        converged=True)
