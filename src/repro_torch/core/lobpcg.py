"""Blocked LOBPCG for the smallest-k eigenpairs of the graph Laplacian.

Port of ``repro.core.lobpcg``: Rayleigh-Ritz over the [X, R, P] block with
a Jacobi (diagonal) preconditioner and Householder-QR orthonormalization;
dense ``eigh`` for graphs of at most 1024 vertices; ``lobpcg_fixed``, the
fixed-trip variant with no convergence read-back.  The Laplacian SpMM
goes through ``grblas.api.mxm`` (the SELL-C-σ reals kernel on the GPU).
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from repro_torch.grblas import api
from repro_torch.grblas.api import Descriptor
from repro_torch.grblas.containers import SparseMatrix


def laplacian_matvec(W: SparseMatrix, normalized: bool = False,
                     desc: Optional[Descriptor] = None) -> Callable:
    """X -> L X with L = D - W (or I - D^-1/2 W D^-1/2)."""
    deg = W.row_sums()
    if normalized:
        dinv = torch.where(deg > 0, torch.rsqrt(torch.clamp(deg, min=1e-12)),
                           torch.zeros_like(deg))

        def mv(X):
            DX = dinv[:, None] * X if X.ndim == 2 else dinv * X
            WX = api.mxm(W, DX.contiguous(), desc=desc)
            return X - (dinv[:, None] * WX if X.ndim == 2 else dinv * WX)
    else:
        def mv(X):
            WX = api.mxm(W, X.contiguous(), desc=desc)
            return (deg[:, None] * X if X.ndim == 2 else deg * X) - WX
    return mv


def _ortho(X):
    """Householder QR orthonormalization."""
    Q, _ = torch.linalg.qr(X)
    return Q


def _jacobi(precond_diag: Optional[torch.Tensor]):
    """The Jacobi preconditioner's inverse diagonal (1 where it is ~0)."""
    if precond_diag is None:
        return None
    return torch.where(torch.abs(precond_diag) > 1e-12, 1.0 / precond_diag,
                       torch.ones_like(precond_diag))


def _rayleigh_ritz(matvec: Callable, X, P, pinv, with_p: bool):
    """One LOBPCG step: Rayleigh-Ritz over [X, R(, P)].  Returns the new
    (X, P, evals (m,), residual norms of the old X)."""
    m = X.shape[1]
    AX = matvec(X)
    rho = torch.sum(X * AX, dim=0)
    R = AX - X * rho
    resnorm = torch.linalg.norm(R, dim=0)
    if pinv is not None:
        R = pinv[:, None] * R
    blocks = [X, R] + ([P] if with_p else [])
    S = _ortho(torch.cat(blocks, dim=1))
    AS = matvec(S)
    T = S.T @ AS
    T = 0.5 * (T + T.T)
    evals, V = torch.linalg.eigh(T)
    return S @ V[:, :m], S[:, m:] @ V[m:, :m], evals[:m], resnorm


def lobpcg(matvec: Callable, X0: torch.Tensor, k: int,
           precond_diag: Optional[torch.Tensor] = None,
           max_iters: int = 200,
           tol: float = 1e-6) -> Tuple[torch.Tensor, torch.Tensor]:
    """Smallest-k eigenpairs of the SPSD operator ``matvec``.  X0: (n, m)
    initial block with m >= k.  Returns (evals (k,), evecs (n,k))."""
    X = _ortho(X0)
    P = torch.zeros_like(X)
    pinv = _jacobi(precond_diag)
    evals = torch.zeros(X.shape[1], dtype=X.dtype, device=X.device)
    for it in range(max_iters):
        X, P, evals, resnorm = _rayleigh_ritz(matvec, X, P, pinv, it > 0)
        if float(torch.max(resnorm[:k])) < tol:
            break
    return evals[:k], X[:, :k]


def lobpcg_fixed(matvec: Callable, X0: torch.Tensor, k: int,
                 iters: int = 20,
                 precond_diag: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fixed-iteration LOBPCG: :func:`lobpcg` with a static trip count
    and no convergence test, so it reads nothing back from the device.

    Exact-zero rows of ``X0`` stay exactly zero through every step
    (the matvec of an isolated pad row is 0, and Householder reflectors
    never mix exact-zero rows in), which makes the whole eigensolve, not
    only the SpMM, sound under bucket padding.  The first iteration runs
    without the P block (a zero block degrades the Ritz basis), the
    other ``iters - 1`` with it.  Returns (evals (k,), evecs (n, k))."""
    X = _ortho(X0)
    P = torch.zeros_like(X)
    pinv = _jacobi(precond_diag)
    for it in range(max(int(iters), 1)):
        X, P, evals, _ = _rayleigh_ritz(matvec, X, P, pinv, it > 0)
    return evals[:k], X[:, :k]


def smallest_eigvecs(W: SparseMatrix, k: int, normalized: bool = False,
                     seed: int = 0, max_iters: int = 200, tol: float = 1e-6,
                     desc: Optional[Descriptor] = None,
                     X0: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Smallest-k eigenpairs of the graph Laplacian of W, in W's dtype
    and on W's device.

    ``X0`` (n, >=1) warm-starts the LOBPCG block: its columns overwrite
    the leading columns of the random start block (drawn from a
    ``torch.Generator`` seeded with ``seed``; the block width is
    m = min(max(2k, k+4), n)).  The dense path ignores it."""
    n = W.n_rows
    dev, dtype = W.device, W.vals.dtype
    if n <= 1024:  # dense exact path for tiny graphs
        L = torch.diag(W.row_sums()) - W.to_dense()
        if normalized:
            dih = torch.rsqrt(torch.clamp(W.row_sums(), min=1e-12))
            L = dih[:, None] * L * dih[None, :]
        evals, evecs = torch.linalg.eigh(L)
        return evals[:k], evecs[:, :k]
    mv = laplacian_matvec(W, normalized, desc=desc)
    m = min(max(2 * k, k + 4), n)
    gen = torch.Generator(device=dev).manual_seed(seed)
    block = torch.randn((n, m), generator=gen, dtype=torch.float32,
                        device=dev).to(dtype)
    if X0 is not None:
        warm = X0 if X0.ndim == 2 else X0[:, None]
        w = min(warm.shape[1], m)
        block[:, :w] = warm[:, :w].to(dtype)
    block[:, 0] = 1.0      # seed the constant vector (known nullvector)
    deg = W.row_sums()
    return lobpcg(mv, block, k, precond_diag=torch.clamp(deg, min=1e-6),
                  max_iters=max_iters, tol=tol)
