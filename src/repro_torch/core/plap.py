"""The p-Laplacian functional F_p, its Euclidean gradient and Hessian apply.

Port of ``repro.core.plap``.  For one column u with symmetric weights W:

    A(u) = 1/2 sum_ij w_ij s(u_i - u_j)       s(x) = (x^2+eps)^{p/2}
    B(u) = sum_i s(u_i)
    F(u) = A(u) / B(u)          F_p(U) = sum_l F(u^l)

    grad F   = (p/B) [Delta_p u - F * phi(u)]
    Hess A   = p [diag(W-hat 1) - W-hat]   w-hat_ij = w_ij phi'(u_i-u_j)
    Hess F @ eta = (1/B) Hess A eta - (F/B) Hess B eta
                   - (1/B^2)[gA (gB.eta) + gB (gA.eta)] + (2F/B^2) gB (gB.eta)

Every SpMM-shaped reduction goes through ``grblas.api.mxm``; on the
SELL-C-σ layout those are the CUDA kernels of ``kernels.sellcs_spmm``.

Two HVPs:
  * hess_eta_graphblas  — Algorithm 1: materialize W-hat as (nnz, k)
    multivalues on W's pattern (W.with_vals) and run reals-ring SpMMs.
  * hess_eta_matrix_free — one pair-edge-semiring SpMM, nothing
    materialized.

The ``batched_*`` functions compute the same quantities for B graphs at
once (the serve engine's bucket solve, the reference's ``jax.vmap`` of
value, gradient and HVP): W is one block-diagonal matrix over B·n
vertices whose element b holds entries [b·nnz_b, (b+1)·nnz_b), U is
(B, n, k), and the energies reduce per element.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core import phi as PHI
from repro_torch.grblas import api
from repro_torch.grblas import ops as grb
from repro_torch.grblas.api import Descriptor
from repro_torch.grblas.containers import SparseMatrix
from repro_torch.grblas.semiring import (plap_edge_semiring,
                                         plap_hvp_edge_semiring, reals_ring)

_AUTO = Descriptor()


class PLapParts(NamedTuple):
    A: torch.Tensor      # (k,) numerators
    B: torch.Tensor      # (k,) denominators
    F: torch.Tensor      # (k,) Rayleigh quotients
    dpu: torch.Tensor    # (n,k) Delta_p u per column
    phi_u: torch.Tensor  # (n,k)


def _edge_diffs(W: SparseMatrix, U: torch.Tensor) -> torch.Tensor:
    """d_e = u_i - u_j per stored edge."""
    return U[W.rows.long()] - U[W.cols.long()]


def parts(W: SparseMatrix, U: torch.Tensor, p: float, eps: float,
          desc: Optional[Descriptor] = None) -> PLapParts:
    """The shared quantities of value/grad: one edge pass for the scalar
    energies and one edge-semiring SpMM for Delta_p u."""
    d = _edge_diffs(W, U)                                      # (nnz, k)
    w = W.vals[:, None]
    A = 0.5 * torch.sum(w * PHI.p_power(d, p, eps), dim=0)     # (k,)
    B = torch.sum(PHI.p_power(U, p, eps), dim=0)               # (k,)
    dpu = api.mxm(W, U, plap_edge_semiring(p, eps), desc=desc or _AUTO)
    return PLapParts(A=A, B=B, F=A / B, dpu=dpu, phi_u=PHI.phi(U, p, eps))


def value(W: SparseMatrix, U: torch.Tensor, p: float, eps: float = 1e-9,
          desc: Optional[Descriptor] = None) -> torch.Tensor:
    return torch.sum(parts(W, U, p, eps, desc).F)


def euc_grad(W: SparseMatrix, U: torch.Tensor, p: float, eps: float = 1e-9,
             desc: Optional[Descriptor] = None) -> torch.Tensor:
    """EucGrad: (p/B)[Delta_p u - F phi(u)] columnwise. (n,k)."""
    pr = parts(W, U, p, eps, desc)
    return (p / pr.B) * (pr.dpu - pr.F * pr.phi_u)


def value_and_grad(W: SparseMatrix, U: torch.Tensor, p: float,
                   eps: float = 1e-9, desc: Optional[Descriptor] = None):
    pr = parts(W, U, p, eps, desc)
    return torch.sum(pr.F), (p / pr.B) * (pr.dpu - pr.F * pr.phi_u)


# ---------------------------------------------------------------- HVP paths

def hessian_weights(W: SparseMatrix, U: torch.Tensor, p: float, eps: float):
    """w-hat_e = w_e phi'(u_i - u_j) per edge and column. (nnz,k)."""
    return W.vals[:, None] * PHI.phi_prime(_edge_diffs(W, U), p, eps)


def build_alg1_operands(W: SparseMatrix, U: torch.Tensor, p: float,
                        eps: float, desc: Optional[Descriptor] = None):
    """Algorithm 1's inputs, stacked over columns: D (n,k) = the W-hat
    row sums (mxm with the ones multivector) and the W-hat multivalues
    (nnz,k)."""
    D, Wh = _alg1_matrix(W, U, p, eps, desc)
    return D, Wh.vals


def _alg1_matrix(W: SparseMatrix, U: torch.Tensor, p: float, eps: float,
                 desc: Optional[Descriptor]):
    """(D, W-hat as a matrix), so the HVP reuses W-hat's layout
    instead of rebuilding it from the multivalues."""
    Wh = W.with_vals(hessian_weights(W, U, p, eps))
    D = api.mxm(Wh, torch.ones_like(U), reals_ring,
                desc=_multival_desc(Wh, U, desc))
    return D, Wh


def _multival_desc(Wh: SparseMatrix, U, desc: Optional[Descriptor]):
    """The caller's descriptor for the multivalue SpMMs, degraded to auto
    where the named backend cannot execute (nnz, k) multivalues."""
    return api.capable_desc(Wh, reals_ring, desc, k=U.shape[-1],
                            dtype=U.dtype)


def hess_eta_graphblas(W: SparseMatrix, U: torch.Tensor, eta: torch.Tensor,
                       p: float, eps: float = 1e-9, operands=None,
                       desc: Optional[Descriptor] = None) -> torch.Tensor:
    """Algorithm-1 HVP (materialized W-hat), full quotient rule:
      1. v  = mxm(What[l], eta, reals_ring)        [Alg.1 line 7]
      2. w  = eWiseApply(eta, D[l], mul)           [Alg.1 line 8]
      3. hA = p * (w - v)                          [Alg.1 line 9 + scale]
    then the rank-one quotient corrections."""
    pr = parts(W, U, p, eps, desc)
    if operands is None:
        D, Wh = _alg1_matrix(W, U, p, eps, desc)
    else:
        D, Wh = operands[0], W.with_vals(operands[1])
    v = api.mxm(Wh, eta, reals_ring, desc=_multival_desc(Wh, eta, desc))
    w = grb.e_wise_apply(eta, D, torch.mul)
    hA_eta = p * grb.e_wise_apply(w, v, torch.sub)
    return _quotient_correct(pr, U, eta, hA_eta, p, eps)


def hess_eta_matrix_free(W: SparseMatrix, U: torch.Tensor, eta: torch.Tensor,
                         p: float, eps: float = 1e-9,
                         desc: Optional[Descriptor] = None) -> torch.Tensor:
    """Matrix-free HVP: Hess A @ eta = p * sum_j w-hat_ij (eta_i - eta_j)
    per column, one pair-edge-semiring SpMM."""
    pr = parts(W, U, p, eps, desc)
    hA_eta = p * api.mxm(W, (U, eta), plap_hvp_edge_semiring(p, eps),
                         desc=desc or _AUTO)
    return _quotient_correct(pr, U, eta, hA_eta, p, eps)


def _quotient_correct(pr: PLapParts, U, eta, hA_eta, p, eps):
    """Assemble Hess F @ eta from Hess A @ eta + quotient-rule terms."""
    gA = p * pr.dpu
    gB = p * pr.phi_u
    hB_eta = p * PHI.phi_prime(U, p, eps) * eta
    gB_eta = torch.sum(gB * eta, dim=-2, keepdim=True)
    gA_eta = torch.sum(gA * eta, dim=-2, keepdim=True)
    B, F = pr.B, pr.F
    return (hA_eta / B
            - (F / B) * hB_eta
            - (gA * gB_eta + gB * gA_eta) / (B * B)
            + (2.0 * F / (B * B)) * gB * gB_eta)


# ------------------------------------------------ batched: B graphs at once

def batched_parts(W: SparseMatrix, U: torch.Tensor, p: float, eps: float,
                  desc: Optional[Descriptor] = None) -> PLapParts:
    """``parts`` of B graphs: W block-diagonal over B·n vertices, U
    (B, n, k); A, B and F are (B, 1, k), the edge terms of each element
    summed over its own nnz_b entries."""
    nb, n, k = U.shape
    Uf = U.reshape(nb * n, k)
    d = _edge_diffs(W, Uf)                                     # (B·nnz_b, k)
    A = 0.5 * torch.sum((W.vals[:, None] * PHI.p_power(d, p, eps)
                         ).reshape(nb, -1, k), dim=1, keepdim=True)
    B = torch.sum(PHI.p_power(U, p, eps), dim=1, keepdim=True)
    dpu = api.mxm(W, Uf, plap_edge_semiring(p, eps),
                  desc=desc or _AUTO).reshape(nb, n, k)
    return PLapParts(A=A, B=B, F=A / B, dpu=dpu, phi_u=PHI.phi(U, p, eps))


def batched_value(W: SparseMatrix, U: torch.Tensor, p: float,
                  eps: float = 1e-9,
                  desc: Optional[Descriptor] = None) -> torch.Tensor:
    """F_p of each element, (B,)."""
    return torch.sum(batched_parts(W, U, p, eps, desc).F, dim=(1, 2))


def batched_euc_grad(W: SparseMatrix, U: torch.Tensor, p: float,
                     eps: float = 1e-9,
                     desc: Optional[Descriptor] = None) -> torch.Tensor:
    pr = batched_parts(W, U, p, eps, desc)
    return (p / pr.B) * (pr.dpu - pr.F * pr.phi_u)


def batched_hess_eta_graphblas(W: SparseMatrix, U: torch.Tensor,
                               eta: torch.Tensor, p: float,
                               eps: float = 1e-9,
                               desc: Optional[Descriptor] = None
                               ) -> torch.Tensor:
    """``hess_eta_graphblas`` of B graphs: W-hat as (B·nnz_b, k)
    multivalues on the block-diagonal pattern."""
    nb, n, k = U.shape
    Uf, Ef = U.reshape(nb * n, k), eta.reshape(nb * n, k)
    pr = batched_parts(W, U, p, eps, desc)
    D, Wh = _alg1_matrix(W, Uf, p, eps, desc)
    v = api.mxm(Wh, Ef, reals_ring, desc=_multival_desc(Wh, Ef, desc))
    w = grb.e_wise_apply(Ef, D, torch.mul)
    hA_eta = p * grb.e_wise_apply(w, v, torch.sub)
    return _quotient_correct(pr, U, eta, hA_eta.reshape(nb, n, k), p, eps)


def batched_hess_eta_matrix_free(W: SparseMatrix, U: torch.Tensor,
                                 eta: torch.Tensor, p: float,
                                 eps: float = 1e-9,
                                 desc: Optional[Descriptor] = None
                                 ) -> torch.Tensor:
    """``hess_eta_matrix_free`` of B graphs."""
    nb, n, k = U.shape
    pr = batched_parts(W, U, p, eps, desc)
    hA_eta = p * api.mxm(W, (U.reshape(nb * n, k), eta.reshape(nb * n, k)),
                         plap_hvp_edge_semiring(p, eps), desc=desc or _AUTO)
    return _quotient_correct(pr, U, eta, hA_eta.reshape(nb, n, k), p, eps)


# ------------------------------------------------------------- autodiff oracle

def autodiff_value(W: SparseMatrix, p: float, eps: float):
    """F_p as a closure for torch.func grad / jvp-of-grad oracles."""
    rows, cols = W.rows.long(), W.cols.long()

    def f(U):
        d = U[rows] - U[cols]
        A = 0.5 * torch.sum(W.vals[:, None] * PHI.p_power(d, p, eps), dim=0)
        B = torch.sum(PHI.p_power(U, p, eps), dim=0)
        return torch.sum(A / B)
    return f


def autodiff_hvp(W: SparseMatrix, U, eta, p: float, eps: float = 1e-9):
    from torch.func import grad, jvp

    return jvp(grad(autodiff_value(W, p, eps)), (U,), (eta,))[1]
