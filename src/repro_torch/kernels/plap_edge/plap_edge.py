"""Fused p-Laplacian kernels over BSR tiles: CUDA for GPU tensors,
PyTorch twins for CPU.

Two wrappers, one per kernel of ``csrc/plap_edge.cu`` (which replaces
the reference's Pallas ``plap_apply_pallas`` and ``plap_hvp_pallas``)::

    plap_apply(A, X, p, eps)     y_i = sum_j w_ij phi_p(x_i - x_j)
    plap_hvp(A, U, E, p, eps)    y_i = sum_j w_ij phi'_p(u_i - u_j)(e_i - e_j)

where j runs over every column of A's stored (bs, bs) tiles in row i's
row-block, zero weights included.  Each takes a square SparseMatrix
with the BSR layout built and (n, k) multivectors, and returns (n, k).

For CUDA tensors a wrapper launches its kernel or raises; it never falls
back.  ``launch_plan`` routes the call by its arguments: the mode
(``phi_mode``: ``skip`` evaluates phi only where a weight is non-zero,
exact wherever every zero weight's term is +-0; ``full`` evaluates every
entry, as the reference) and the column windows (``phi_windows``: one
launch per window of a compiled width).  Each launch is counted in
``LAUNCHES`` under the wrapper's name (skip mode) or the name with
``_full``.  Tiles above ``MAX_BLOCK`` raise.

For CPU tensors a wrapper runs the plain version (``*_plain``): the
multivectors zero-padded to whole blocks, then the twins
``plap_apply_ref`` / ``plap_hvp_edge_ref``, the port of the reference's
``kernels/plap_edge/ref.py``.  The reference's oracle builds a
(n_blocks, bs, bs, k) temporary (18.6 GB for delaunay_graph(20) at
bs = 128); the twins run the same arithmetic over chunks of tiles, so the
plain version can be held against the kernel at full size.
"""
from __future__ import annotations

import math
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch.core import phi as PHI
from repro_torch.kernels.bsr_spmm.bsr_spmm import (MAX_BLOCK, check_operands,
                                                   launch_args, pad_rows)
from repro_torch.kernels.nvcc import F64, I32, I64, PTR, NvccLibrary, check

LIBRARY = NvccLibrary(
    "plap_edge", Path(__file__).resolve().parent / "csrc" / "plap_edge.cu",
    {"plap_edge_launch": (I32, [I32, I32, I32, I32, PTR, PTR, PTR, PTR, PTR,
                                PTR, I32, I32, I32, I32, I32, I32, I32, I64,
                                F64, F64, PTR])})

# kernel launches per wrapper and mode (skip mode under the wrapper's
# name): incremented where the kernel is launched and nowhere else
LAUNCHES = {"plap_apply": 0, "plap_apply_full": 0, "plap_hvp": 0,
            "plap_hvp_full": 0, "plap_apply_divergent": 0,
            "plap_hvp_divergent": 0}

_KIND = {"plap_apply": 1, "plap_hvp": 2}
# the kernel's modes; "divergent" (each lane tests its own weights, no
# compaction) exists to be timed against "skip" and is never routed to
_MODE = {"skip": 0, "full": 1, "divergent": 2}
# the window widths the kernels are compiled for; a window of kc columns
# runs on the narrowest width >= kc
PHI_WIDTHS = {torch.float32: (1, 2, 4, 8), torch.float64: (1, 2, 4)}
# |v| from which a difference of two inputs could overflow when squared;
# the kernel evaluates a tile in full where an input reaches it
OVERFLOW_AT = {torch.float32: 2.0 ** 62, torch.float64: 2.0 ** 510}
_NUMPY = {torch.float32: np.float32, torch.float64: np.float64}

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


# ------------------------------------------------------------ launch plan

def phi_mode(name: str, p: float, eps: float, dtype: torch.dtype) -> str:
    """``"skip"`` where every zero weight's term is exactly +-0 for finite
    inputs below ``OVERFLOW_AT`` (then skipping it changes nothing but
    the order of the sum), else ``"full"``.

    Both kernels need 1 <= p <= 2 (|phi(d)| <= max(1, |d|) and phi'
    bounded by its value at d = 0) and eps as the kernel holds it
    (rounded to ``dtype``) either 0 (the apply only: phi_p(0) = 0) or
    positive.  The hvp needs eps > 0, since phi'(0) = inf at eps = 0 for
    p < 2, and (eps)^((p-4)/2), the largest pow its phi' forms, finite in
    ``dtype`` (with a factor of 16 to spare)."""
    if not 1.0 <= p <= 2.0:
        return "full"
    eps_t = float(_NUMPY[dtype](eps))
    if name == "plap_apply":
        return "skip" if eps_t > 0.0 or eps == 0.0 else "full"
    if not eps_t > 0.0:
        return "full"
    log_pow = (p - 4.0) / 2.0 * math.log(eps_t)
    return ("skip" if log_pow < math.log(torch.finfo(dtype).max / 16.0)
            else "full")


def phi_windows(k: int, dtype: torch.dtype) -> list:
    """(c0, kc, width) launches over k columns: windows of the widest
    compiled width, the last one on the narrowest width that holds it."""
    widths = PHI_WIDTHS[dtype]
    out = []
    for c0 in range(0, k, widths[-1]):
        kc = min(widths[-1], k - c0)
        out.append((c0, kc, min(w for w in widths if w >= kc)))
    return out


def launch_plan(name: str, block_size: int, k: int, dtype: torch.dtype,
                p: float, eps: float) -> tuple:
    """(mode, windows) of one call of a phi kernel; raises for tiles the
    kernel does not take."""
    if block_size > MAX_BLOCK:
        raise ValueError(f"block_size={block_size}: the {name} kernel takes "
                         f"tiles of at most {MAX_BLOCK}")
    return phi_mode(name, p, eps, dtype), phi_windows(k, dtype)


def counter(name: str, mode: str) -> str:
    """The ``LAUNCHES`` key of a launch in ``mode``."""
    return name if mode == "skip" else f"{name}_{mode}"


# --------------------------------------------------------------- wrappers

def _launch(name: str, A, X, E, p: float, eps: float,
            mode: str | None = None) -> torch.Tensor:
    k = X.shape[1]
    routed, windows = launch_plan(name, A.block_size, k, X.dtype, p, eps)
    mode = mode or routed
    lib = LIBRARY.load()
    Y = torch.empty_like(X)
    args, stream = launch_args(A, X, E, Y)
    for c0, kc, width in windows:
        code = lib.plap_edge_launch(
            _KIND[name], _MODE[mode], int(X.dtype == torch.float64), *args,
            len(A.bsr_indptr) - 1, A.n_rows, A.block_size, k, c0, kc, width,
            int(A.bsr_blocks.shape[0]), float(p), float(eps), stream)
        check(lib, code, f"{name} ({mode})")
        LAUNCHES[counter(name, mode)] += 1
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


def run_divergent(name: str, A, X: torch.Tensor, E: torch.Tensor, p: float,
                  eps: float) -> torch.Tensor:
    """The kernel's divergent variant (fp32, k = 4, CUDA tensors only),
    for timing against the routed mode; no path calls it.  ``name`` is
    ``"plap_apply"`` (E unused) or ``"plap_hvp"``."""
    _square(A)
    if (not check_operands(A, X, E) or X.dtype != torch.float32
            or X.shape[1] != 4 or phi_mode(name, p, eps, X.dtype) != "skip"):
        raise ValueError("the divergent variant takes fp32 CUDA "
                         "multivectors of 4 columns in skip mode")
    return _launch(name, A, X, E if name == "plap_hvp" else X, p, eps,
                   mode="divergent")
