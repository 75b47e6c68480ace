"""Fused p-Laplacian kernels over BSR tiles: CUDA for GPU tensors,
PyTorch twins for CPU.

Two wrappers, one per kernel of ``csrc/plap_edge.cu`` (which replaces
the reference's Pallas ``plap_apply_pallas`` and ``plap_hvp_pallas``)::

    plap_apply(A, X, p, eps)     y_i = sum_j w_ij phi_p(x_i - x_j)
    plap_hvp(A, U, E, p, eps)    y_i = sum_j w_ij phi'_p(u_i - u_j)(e_i - e_j)

where j runs over every column of A's stored (bs, bs) tiles in row i's
row-block, zero weights included.  Each takes a square SparseMatrix
with the BSR layout built and (n, k) multivectors, and returns (n, k).
For CUDA tensors it launches its kernel (one launch per column window
that fits shared memory, each counted in ``LAUNCHES``) or raises; it
never falls back.  For CPU tensors it runs the plain version
(``*_plain``): the multivectors zero-padded to whole blocks, then the
twins ``plap_apply_ref`` / ``plap_hvp_edge_ref``, the port of the
reference's ``kernels/plap_edge/ref.py``.  The reference's oracle
builds a (n_blocks, bs, bs, k) temporary (18.6 GB for delaunay_graph(20)
at bs = 128); the twins run the same arithmetic over chunks of tiles,
so the plain version can be held against the kernel at full size.
"""
from __future__ import annotations

import time
from pathlib import Path

import torch

from repro_torch.core import phi as PHI
from repro_torch.kernels.bsr_spmm.bsr_spmm import (check_operands,
                                                   column_windows,
                                                   launch_args, pad_rows)
from repro_torch.kernels.nvcc import F64, I32, PTR, NvccLibrary, check

LIBRARY = NvccLibrary(
    "plap_edge", Path(__file__).resolve().parent / "csrc" / "plap_edge.cu",
    {"plap_edge_launch": (I32, [I32, I32, I32, PTR, PTR, PTR, PTR, PTR, PTR,
                                I32, I32, I32, I32, I32, I32, F64, F64,
                                PTR])})

# kernel launches per wrapper: incremented where the kernel is launched
# and nowhere else
LAUNCHES = {"plap_apply": 0, "plap_hvp": 0}

_KIND = {"plap_apply": 1, "plap_hvp": 2}
_BUFFERS = {"plap_apply": 3, "plap_hvp": 5}   # staged (bs, kc) slices

# elements of the largest (tiles, bs, bs, k) temporary a twin builds
CHUNK_ELEMS = 1 << 25


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def start_build() -> None:
    """Start nvcc in the background (returns at once)."""
    LIBRARY.start()


def build() -> float:
    """Build (or open the cached build of) the library; seconds taken."""
    t0 = time.perf_counter()
    LIBRARY.load()
    return time.perf_counter() - t0


# ------------------------------------------------------------ plain twins

def _chunks(n_blocks: int, bs: int, k: int):
    step = max(1, CHUNK_ELEMS // max(bs * bs * k, 1))
    return [slice(s, s + step) for s in range(0, n_blocks, step)]


def plap_apply_ref(blocks, indices, row_ids, X, n_row_blocks,
                   block_size=128, p=1.5, eps=1e-9):
    """(Delta_p X)_i = sum_j w_ij phi_p(x_i - x_j), per column of X (whole
    blocks of rows)."""
    bs, k = block_size, X.shape[1]
    Xb = X.reshape(-1, bs, k)
    out = torch.zeros((n_row_blocks, bs, k), dtype=X.dtype, device=X.device)
    for sl in _chunks(blocks.shape[0], bs, k):
        rid = row_ids[sl].long()
        diff = Xb[rid][:, :, None, :] - Xb[indices[sl].long()][:, None, :, :]
        contrib = blocks[sl][..., None] * PHI.phi(diff, p, eps)
        out.index_add_(0, rid, torch.sum(contrib, dim=2))
    return out.reshape(n_row_blocks * bs, k)


def plap_hvp_edge_ref(blocks, indices, row_ids, U, Eta, n_row_blocks,
                      block_size=128, p=1.5, eps=1e-9):
    """HessA-part apply: sum_j w_ij phi'(u_i-u_j) (eta_i - eta_j)."""
    bs, k = block_size, U.shape[1]
    Ub = U.reshape(-1, bs, k)
    Eb = Eta.reshape(-1, bs, k)
    out = torch.zeros((n_row_blocks, bs, k), dtype=U.dtype, device=U.device)
    for sl in _chunks(blocks.shape[0], bs, k):
        rid, cid = row_ids[sl].long(), indices[sl].long()
        du = Ub[rid][:, :, None, :] - Ub[cid][:, None, :, :]
        de = Eb[rid][:, :, None, :] - Eb[cid][:, None, :, :]
        contrib = blocks[sl][..., None] * PHI.phi_prime(du, p, eps) * de
        out.index_add_(0, rid, torch.sum(contrib, dim=2))
    return out.reshape(n_row_blocks * bs, k)


def plap_apply_plain(A, X, p: float, eps: float):
    (Xp,) = pad_rows(A, X)
    return plap_apply_ref(A.bsr_blocks, A.bsr_indices, A.bsr_row_ids, Xp,
                          len(A.bsr_indptr) - 1, A.block_size, p,
                          eps)[:A.n_rows]


def plap_hvp_plain(A, U, E, p: float, eps: float):
    Up, Ep = pad_rows(A, U, E)
    return plap_hvp_edge_ref(A.bsr_blocks, A.bsr_indices, A.bsr_row_ids, Up,
                             Ep, len(A.bsr_indptr) - 1, A.block_size, p,
                             eps)[:A.n_rows]


# --------------------------------------------------------------- wrappers

def _launch(name: str, A, X, E, p: float, eps: float) -> torch.Tensor:
    lib = LIBRARY.load()
    k = X.shape[1]
    Y = torch.empty_like(X)
    args, stream = launch_args(A, X, E, Y)
    for c0, kc in column_windows(A, k, _BUFFERS[name]):
        code = lib.plap_edge_launch(
            _KIND[name], int(X.dtype == torch.float64), *args,
            len(A.bsr_indptr) - 1, A.n_rows, A.block_size, k, c0, kc,
            float(p), float(eps), stream)
        check(lib, code, name)
        LAUNCHES[name] += 1
    return Y


def _square(A) -> None:
    if A.n_rows != A.n_cols:
        raise ValueError("the p-Laplacian kernels take a square matrix, got "
                         f"({A.n_rows}, {A.n_cols})")


def plap_apply(A, X: torch.Tensor, p: float, eps: float) -> torch.Tensor:
    """p-Laplacian apply over A's BSR tiles."""
    _square(A)
    if not check_operands(A, X):
        return plap_apply_plain(A, X, p, eps)
    return _launch("plap_apply", A, X, X, p, eps)


def plap_hvp(A, U: torch.Tensor, E: torch.Tensor, p: float,
             eps: float) -> torch.Tensor:
    """Matrix-free Newton HVP (Hess A part) over A's BSR tiles."""
    _square(A)
    if not check_operands(A, U, E):
        return plap_hvp_plain(A, U, E, p, eps)
    return _launch("plap_hvp", A, U, E, p, eps)
