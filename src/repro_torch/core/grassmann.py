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

``rtr_minimize_batched`` is the counterpart of the reference's
``jax.vmap(rtr_minimize)`` (the serve engine's bucket solve): U is
(B, n, k), inner products and norms reduce to (B,), and the outer loop
and the nested tCG run while any element is active, a finished
element's carry frozen by ``torch.where`` — the semantics of a batched
``while_loop``.  Trust radius, HVP count and iteration count are kept
per element; each loop step reads one flag back.
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


# ----------------------------------------------------- batched (B, n, k)

def proj_batched(U, Z):
    return Z - torch.bmm(U, torch.bmm(U.transpose(1, 2), Z))


def retract_qr_batched(U, eta):
    Q, R = torch.linalg.qr(U + eta)
    sgn = torch.sign(torch.diagonal(R, dim1=-2, dim2=-1))
    sgn = torch.where(sgn == 0, torch.ones_like(sgn), sgn)
    return Q * sgn[:, None, :]


def inner_batched(a, b):
    return torch.sum(a * b, dim=(-2, -1))


def _lift(x):
    """(B,) -> (B, 1, 1), to broadcast a per-element scalar or flag."""
    return x[:, None, None]


def _tcg_batched(U, grad, hvp, radius, tcg_iters: int, active,
                 kappa=0.1, theta=1.0):
    """``_tcg`` on a batch: element b iterates while it is ``active``,
    under its iteration budget and not yet stopped.  Returns (eta,
    n_hvp (B,))."""
    eta = torch.zeros_like(grad)
    r = grad
    d = -r
    rr = inner_batched(r, r)
    norm_g = torch.sqrt(rr)
    stop_tol = norm_g * torch.clamp(norm_g ** theta, max=kappa)
    k = torch.zeros_like(rr, dtype=torch.int64)
    done = ~active
    n_hvp = torch.zeros_like(k)

    while True:
        live = (k < tcg_iters) & ~done
        if not bool(live.any()):
            break
        Hd = proj_batched(U, hvp(d))
        dHd = inner_batched(d, Hd)
        alpha = rr / torch.where(dHd == 0, torch.full_like(dHd, 1e-30), dHd)
        eta_next = eta + _lift(alpha) * d
        hit_boundary = (dHd <= 0) | (
            torch.sqrt(inner_batched(eta_next, eta_next)) >= radius)
        dd = inner_batched(d, d)
        ed = inner_batched(eta, d)
        ee = inner_batched(eta, eta)
        disc = torch.sqrt(torch.clamp(ed * ed + dd * (radius ** 2 - ee),
                                      min=0.0))
        tau = (-ed + disc) / torch.clamp(dd, min=1e-30)
        eta_b = eta + _lift(tau) * d
        r_next = r + _lift(alpha) * Hd
        rr_next = inner_batched(r_next, r_next)
        small = torch.sqrt(rr_next) <= stop_tol
        beta = rr_next / torch.where(rr == 0, torch.full_like(rr, 1e-30), rr)
        d_next = -r_next + _lift(beta) * d
        eta_out = torch.where(_lift(hit_boundary), eta_b, eta_next)
        lv = _lift(live)
        eta = torch.where(lv, eta_out, eta)
        r = torch.where(lv, r_next, r)
        d = torch.where(lv, d_next, d)
        rr = torch.where(live, rr_next, rr)
        done = torch.where(live, hit_boundary | small, done)
        k = k + live
        n_hvp = n_hvp + live
    return eta, n_hvp


class RTRBatchResult(NamedTuple):
    U: torch.Tensor          # (B, n, k)
    fval: torch.Tensor       # (B,)
    gradnorm: torch.Tensor   # (B,)
    iters: torch.Tensor      # (B,) int64
    n_hvp: torch.Tensor      # (B,) int64


def rtr_minimize_batched(f: Callable, egrad: Callable, ehvp: Callable,
                         U0: torch.Tensor, max_iters: int = 50,
                         tcg_iters: int = 25, grad_tol: float = 1e-6,
                         radius0: float = 0.5,
                         radius_max: float = 4.0) -> RTRBatchResult:
    """``rtr_minimize`` on B independent problems at once.  f(U) -> (B,);
    egrad(U) -> (B, n, k); ehvp(U, eta) -> (B, n, k).  Element b runs
    while its iteration count is under ``max_iters`` and its gradient
    norm above ``grad_tol``; once it stops, its U, value, gradient norm,
    radius and counts stay as they were."""

    def rhess(U, g_e, eta):
        return proj_batched(
            U, ehvp(U, eta) - torch.bmm(eta, torch.bmm(U.transpose(1, 2),
                                                       g_e)))

    U = U0
    fval = f(U0)
    gradnorm = torch.linalg.vector_norm(proj_batched(U0, egrad(U0)),
                                        dim=(-2, -1))
    radius = torch.full_like(gradnorm, radius0)
    it = torch.zeros_like(gradnorm, dtype=torch.int64)
    n_hvp = torch.zeros_like(it)
    while True:
        active = (it < max_iters) & (gradnorm > grad_tol)
        if not bool(active.any()):
            break
        g_e = egrad(U)
        g = proj_batched(U, g_e)
        Uc = U
        hvp = lambda eta: rhess(Uc, g_e, eta)
        eta, used = _tcg_batched(U, g, hvp, radius, tcg_iters, active)
        U_try = retract_qr_batched(U, eta)
        f_try = f(U_try)
        Heta = proj_batched(U, hvp(eta))
        pred = -(inner_batched(g, eta) + 0.5 * inner_batched(eta, Heta))
        ared = fval - f_try
        rho = ared / torch.where(torch.abs(pred) < 1e-30,
                                 torch.full_like(pred, 1e-30), pred)
        accept = rho > 0.05
        U_new = torch.where(_lift(accept), U_try, U)
        f_new = torch.where(accept, f_try, fval)
        shrink = rho < 0.25
        grow = (rho > 0.75) & (torch.sqrt(inner_batched(eta, eta))
                               > 0.9 * radius)
        radius_new = torch.where(
            shrink, 0.25 * radius,
            torch.where(grow, torch.clamp(2.0 * radius, max=radius_max),
                        radius))
        gn_new = torch.linalg.vector_norm(proj_batched(U_new, egrad(U_new)),
                                          dim=(-2, -1))
        U = torch.where(_lift(active), U_new, U)
        fval = torch.where(active, f_new, fval)
        radius = torch.where(active, radius_new, radius)
        gradnorm = torch.where(active, gn_new, gradnorm)
        n_hvp = n_hvp + torch.where(active, used + 1, torch.zeros_like(used))
        it = it + active
    return RTRBatchResult(U=U, fval=fval, gradnorm=gradnorm, iters=it,
                          n_hvp=n_hvp)
