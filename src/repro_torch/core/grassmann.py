"""Riemannian trust-region Newton on the Grassmann manifold Gr(k, n).

Port of ``repro.core.grassmann``: Newton with a Steihaug truncated-CG
inner solver under a trust region (Absil, Baker & Gallivan 2007).  A
point is an orthonormal U (n, k); the tangent space is {xi : U^T xi = 0}.

  proj_U(Z)  = Z - U (U^T Z)
  rgrad      = proj_U(egrad)
  rhess(eta) = proj_U( ehess(eta) - eta (U^T egrad) )
  retract    = qf(U + eta)                 (thin-QR retraction)

The reference's ``lax.while_loop``s are Python loops here; each loop test
reads one scalar back from the device.  The HVP accounting is the
reference's: ``used + 1`` per outer iteration.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch


def proj(U, Z):
    return Z - U @ (U.T @ Z)


def retract_qr(U, eta):
    Q, R = torch.linalg.qr(U + eta)
    sgn = torch.sign(torch.diagonal(R))
    sgn = torch.where(sgn == 0, torch.ones_like(sgn), sgn)
    return Q * sgn[None, :]


def inner(a, b):
    return torch.sum(a * b)


class RTRResult(NamedTuple):
    U: torch.Tensor
    fval: torch.Tensor
    gradnorm: torch.Tensor
    iters: int
    n_hvp: int


def _tcg(U, grad, hvp, radius, tcg_iters: int, kappa=0.1, theta=1.0):
    """Steihaug-Toint truncated CG for the trust-region subproblem
    min <grad,eta> + 1/2 <eta, H eta>  s.t. ||eta|| <= radius, eta in T_U.
    Returns (eta, n_hvp_used)."""
    eta = torch.zeros_like(grad)
    r = grad
    d = -r
    rr = inner(r, r)
    norm_g = torch.sqrt(rr)
    stop_tol = norm_g * torch.minimum(torch.as_tensor(kappa, dtype=norm_g.dtype,
                                                      device=norm_g.device),
                                      norm_g ** theta)
    radius = torch.as_tensor(radius, dtype=grad.dtype, device=grad.device)

    def boundary_point(eta, d):
        """tau >= 0 with ||eta + tau d|| = radius."""
        dd = inner(d, d)
        ed = inner(eta, d)
        ee = inner(eta, eta)
        disc = torch.sqrt(torch.clamp(ed * ed + dd * (radius ** 2 - ee), min=0.0))
        tau = (-ed + disc) / torch.clamp(dd, min=1e-30)
        return eta + tau * d

    k = 0
    done = False
    while k < tcg_iters and not done:
        Hd = proj(U, hvp(d))
        dHd = inner(d, Hd)
        alpha = rr / torch.where(dHd == 0, torch.full_like(dHd, 1e-30), dHd)
        eta_next = eta + alpha * d
        hit_boundary = torch.logical_or(
            dHd <= 0, torch.sqrt(inner(eta_next, eta_next)) >= radius)
        eta_b = boundary_point(eta, d)
        r_next = r + alpha * Hd
        rr_next = inner(r_next, r_next)
        small = torch.sqrt(rr_next) <= stop_tol
        beta = rr_next / torch.where(rr == 0, torch.full_like(rr, 1e-30), rr)
        d = -r_next + beta * d
        eta = torch.where(hit_boundary, eta_b, eta_next)
        r, rr = r_next, rr_next
        done = bool(torch.logical_or(hit_boundary, small))
        k += 1
    return eta, k


def rtr_minimize(f: Callable, egrad: Callable, ehvp: Callable,
                 U0: torch.Tensor, max_iters: int = 50, tcg_iters: int = 25,
                 grad_tol: float = 1e-6, radius0: float = 0.5,
                 radius_max: float = 4.0) -> RTRResult:
    """Trust-region Newton on Gr(k,n).  f(U) -> scalar; egrad(U) -> (n,k);
    ehvp(U, eta) -> (n,k) Euclidean HVP."""

    def rhess(U, g_e, eta):
        return proj(U, ehvp(U, eta) - eta @ (U.T @ g_e))

    U = U0
    fval = f(U0)
    g = proj(U0, egrad(U0))
    gradnorm = torch.linalg.norm(g)
    radius = torch.as_tensor(radius0, dtype=U0.dtype, device=U0.device)
    it = 0
    n_hvp = 0
    while it < max_iters and float(gradnorm) > grad_tol:
        g_e = egrad(U)
        g = proj(U, g_e)
        Uc = U
        hvp = lambda eta: rhess(Uc, g_e, eta)
        eta, used = _tcg(U, g, hvp, radius, tcg_iters)
        U_try = retract_qr(U, eta)
        f_try = f(U_try)
        Heta = proj(U, hvp(eta))
        pred = -(inner(g, eta) + 0.5 * inner(eta, Heta))
        ared = fval - f_try
        rho = ared / torch.where(torch.abs(pred) < 1e-30,
                                 torch.full_like(pred, 1e-30), pred)
        accept = rho > 0.05
        U = torch.where(accept, U_try, U)
        fval = torch.where(accept, f_try, fval)
        shrink = rho < 0.25
        grow = torch.logical_and(rho > 0.75,
                                 torch.sqrt(inner(eta, eta)) > 0.9 * radius)
        radius = torch.where(shrink, 0.25 * radius,
                             torch.where(grow, torch.clamp(2.0 * radius,
                                                           max=radius_max),
                                         radius))
        g_new = proj(U, egrad(U))
        gradnorm = torch.linalg.norm(g_new)
        it += 1
        n_hvp += used + 1
    return RTRResult(U=U, fval=fval, gradnorm=gradnorm, iters=it, n_hvp=n_hvp)
