"""SELL-C-σ SpMM kernels: CUDA for GPU tensors, PyTorch twins for CPU.

Three wrappers, one per kernel of ``csrc/sellcs_kernels.cu`` (which
replaces the reference's Pallas ``sellcs_spmm_pallas``,
``sellcs_plap_apply_pallas`` and ``sellcs_plap_hvp_pallas``)::

    sellcs_spmm(A, X)              y_i = sum_j a_ij x_j   (reals ring; A may
                                   carry (nnz, k) multivalues from with_vals)
    sellcs_plap_apply(A, X, p, eps) y_i = sum_j w_ij phi_p(x_i - x_j)
    sellcs_plap_hvp(A, U, E, p, eps) y_i = sum_j w_ij phi'_p(u_i-u_j)(e_i-e_j)

Each takes a SparseMatrix with the SELL-C-σ layout built and (n, k)
multivectors in the caller's row order, and returns (n, k).  For CUDA
tensors it launches its kernel once over every width run (one launch,
counted in ``LAUNCHES``) or raises; it never falls back.  For CPU tensors
it runs the plain version (``*_plain``): the σ-permuted multivector
through the per-run twins ``*_ref`` — the port of the reference's
``kernels/sellcs_spmm/ref.py`` — then un-permuted, exactly the
computation of the reference's ``backends.sellcs_run``.

The extension is built with ``torch.utils.cpp_extension.load`` at first
CUDA use (or by ``build()``) into ``build/torch_ext/`` at the root of the
checkout; importing this module builds nothing.
"""
from __future__ import annotations

import functools
import os
import time
from pathlib import Path

import torch

from repro_torch.core import phi as PHI

from repro_torch.kernels.nvcc import BUILD_DIR, CUDA_FLAGS, SHARED_CSRC

_CSRC = Path(__file__).resolve().parent / "csrc"
_SOURCES = [_CSRC / "binding.cpp", _CSRC / "sellcs_kernels.cu"]

# kernel launches per wrapper: incremented where the kernel is launched
# and nowhere else
LAUNCHES = {"sellcs_spmm": 0, "sellcs_plap_apply": 0, "sellcs_plap_hvp": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


@functools.cache
def _extension():
    from torch.utils.cpp_extension import load

    os.makedirs(BUILD_DIR, exist_ok=True)
    return load(name="repro_torch_sellcs", sources=[str(s) for s in _SOURCES],
                build_directory=str(BUILD_DIR), extra_cflags=["-O2"],
                extra_cuda_cflags=CUDA_FLAGS,
                extra_include_paths=[str(SHARED_CSRC)], verbose=False)


def build() -> float:
    """Build (or load the cached build of) the extension; seconds taken."""
    t0 = time.perf_counter()
    _extension()
    return time.perf_counter() - t0


# ------------------------------------------------------------ plain twins

def sellcs_spmm_ref(cols, vals, Xp):
    """Reals-ring run: y = sum_w vals * Xp[cols].  vals may be (rows, w)
    or (rows, w, k) multivalues."""
    g = Xp[cols.long()]                            # (rows, w, k)
    v = vals[..., None] if vals.ndim == 2 else vals
    return torch.sum(v * g, dim=1)


def sellcs_plap_apply_ref(cols, vals, Xp, row0: int, p: float, eps: float):
    """p-Laplacian apply run: y_i = sum_j w_ij phi_p(x_i - x_j)."""
    g = Xp[cols.long()]                            # x_j  (rows, w, k)
    x_i = Xp[row0:row0 + cols.shape[0]][:, None, :]
    return torch.sum(vals[..., None] * PHI.phi(x_i - g, p, eps), dim=1)


def sellcs_plap_hvp_ref(cols, vals, Up, Ep, row0: int, p: float, eps: float):
    """Newton HVP run: y_i = sum_j w_ij phi'(u_i-u_j)(e_i-e_j)."""
    rows = cols.shape[0]
    idx = cols.long()
    du = Up[row0:row0 + rows][:, None, :] - Up[idx]
    de = Ep[row0:row0 + rows][:, None, :] - Ep[idx]
    return torch.sum(vals[..., None] * PHI.phi_prime(du, p, eps) * de, dim=1)


def _unpermute(A, outs):
    return torch.cat(outs, dim=0)[A.sell_inv.long()]   # drop phantom rows


def sellcs_spmm_plain(A, X):
    Xp = X[A.sell_perm.long()]
    return _unpermute(A, [sellcs_spmm_ref(c, v, Xp)
                          for c, v in zip(A.sell_cols, A.sell_vals)])


def sellcs_plap_apply_plain(A, X, p: float, eps: float):
    Xp = X[A.sell_perm.long()]
    return _unpermute(A, [
        sellcs_plap_apply_ref(c, v, Xp, row0, p, eps)
        for c, v, row0 in zip(A.sell_cols, A.sell_vals, A.sell_row0)])


def sellcs_plap_hvp_plain(A, U, E, p: float, eps: float):
    perm = A.sell_perm.long()
    Up, Ep = U[perm], E[perm]
    return _unpermute(A, [
        sellcs_plap_hvp_ref(c, v, Up, Ep, row0, p, eps)
        for c, v, row0 in zip(A.sell_cols, A.sell_vals, A.sell_row0)])


# --------------------------------------------------------------- wrappers

def _check(A, *Xs) -> bool:
    """Validate the operands; True for the CUDA kernel, False for the CPU
    twin.  Raises on anything the kernel does not take."""
    L = A.sell_kernel
    if L is None:
        raise ValueError("the SELL-C-σ layout is not built on this matrix")
    X = Xs[0]
    for Z in Xs:
        if Z.dtype not in (torch.float32, torch.float64):
            raise TypeError(f"multivector dtype {Z.dtype}: the kernels take "
                            "float32 or float64")
        if Z.dtype != L.vals.dtype:
            raise TypeError(f"multivector dtype {Z.dtype} != matrix dtype "
                            f"{L.vals.dtype}")
        if Z.ndim != 2 or Z.shape != X.shape or Z.shape[0] != A.n_rows:
            raise ValueError(f"multivector shape {tuple(Z.shape)}: expected "
                             f"({A.n_rows}, k), all operands alike")
        if not Z.is_contiguous():
            raise ValueError("multivectors must be contiguous")
        if Z.device != L.vals.device:
            raise ValueError(f"multivector on {Z.device}, matrix on "
                             f"{L.vals.device}")
    if L.vals.ndim == 2 and L.vals.shape[1] != X.shape[1]:
        raise ValueError(f"(nnz, {L.vals.shape[1]}) multivalues against a "
                         f"(n, {X.shape[1]}) multivector")
    if X.device.type == "cpu":
        return False
    if X.device.type != "cuda":
        raise ValueError(f"no SELL-C-σ kernel for device {X.device}")
    return True


def sellcs_spmm(A, X: torch.Tensor) -> torch.Tensor:
    """Reals-ring SpMM over the whole SELL-C-σ layout (one launch)."""
    if not _check(A, X):
        return sellcs_spmm_plain(A, X)
    L = A.sell_kernel
    Y = torch.empty_like(X)
    _extension().spmm(L.slice_ptr, L.slice_w, L.perm, L.cols, L.vals, X, Y,
                      L.C)
    LAUNCHES["sellcs_spmm"] += 1
    return Y


def sellcs_plap_apply(A, X: torch.Tensor, p: float, eps: float) -> torch.Tensor:
    """p-Laplacian apply over the whole SELL-C-σ layout (one launch)."""
    if A.vals.ndim != 1:
        raise ValueError("the p-Laplacian apply takes scalar edge weights")
    if not _check(A, X):
        return sellcs_plap_apply_plain(A, X, p, eps)
    L = A.sell_kernel
    Y = torch.empty_like(X)
    _extension().plap_apply(L.slice_ptr, L.slice_w, L.perm, L.cols, L.vals,
                            X, Y, L.C, float(p), float(eps))
    LAUNCHES["sellcs_plap_apply"] += 1
    return Y


def sellcs_plap_hvp(A, U: torch.Tensor, E: torch.Tensor, p: float,
                    eps: float) -> torch.Tensor:
    """Matrix-free Newton HVP (Hess A part) over the whole layout."""
    if A.vals.ndim != 1:
        raise ValueError("the p-Laplacian HVP takes scalar edge weights")
    if not _check(A, U, E):
        return sellcs_plap_hvp_plain(A, U, E, p, eps)
    L = A.sell_kernel
    Y = torch.empty_like(U)
    _extension().plap_hvp(L.slice_ptr, L.slice_w, L.perm, L.cols, L.vals, U,
                          E, Y, L.C, float(p), float(eps))
    LAUNCHES["sellcs_plap_hvp"] += 1
    return Y
