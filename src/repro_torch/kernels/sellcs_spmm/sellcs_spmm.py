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

``launch_plan`` routes a launch: every wrapper runs the row kernel at a
compiled width (k = 4, 8, 16, 24, with 16-byte loads; ``lanes`` threads
a row, one per 32 bytes of it) or its generic variant (chunks of 4
columns, scalar loads); how many slots a thread takes at once is the
kernel's own choice.  The reals ring visits the blocks in the order
``block_order`` gives (by the original id of their first row, cached on
the layout); the apply and the HVP keep launch order.

The library is built with nvcc (``kernels/nvcc.py``) at first CUDA use
(or by ``build``/``start_build``) into ``build/torch_ext/`` at the root
of the checkout and opened with ctypes; importing this module builds
nothing.
"""
from __future__ import annotations

import time
from pathlib import Path
from typing import Dict, NamedTuple, Tuple

import torch

from repro_torch.core import phi as PHI
from repro_torch.kernels.nvcc import F64, I32, PTR, NvccLibrary, check

LIBRARY = NvccLibrary(
    "sellcs_spmm",
    Path(__file__).resolve().parent / "csrc" / "sellcs_kernels.cu",
    {"sellcs_launch": (I32, [I32, I32, I32, I32, I32, I32, PTR, PTR, PTR,
                             PTR, PTR, PTR, PTR, PTR, PTR, I32, I32, I32,
                             F64, F64, PTR])})

# kernel launches per wrapper: incremented where the kernel is launched
# and nowhere else; sellcs_spmm's launches also by shape ("scalar k=8",
# "multivalue k=4")
LAUNCHES = {"sellcs_spmm": 0, "sellcs_plap_apply": 0, "sellcs_plap_hvp": 0}
LAUNCHES_BY_SHAPE: Dict[str, int] = {}

_KIND = {"sellcs_spmm": 0, "sellcs_plap_apply": 1, "sellcs_plap_hvp": 2}
# the widths the row kernel is compiled for (16-byte loads); any other k
# runs the generic variant on chunks of GENERIC_WIDTH columns
ROW_WIDTHS = (4, 8, 16, 24)
GENERIC_WIDTH = 4
THREADS = 256       # threads per block (kThreads)


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    LAUNCHES_BY_SHAPE.clear()


def start_build() -> None:
    """Start nvcc in the background (returns at once)."""
    LIBRARY.start()


def build() -> float:
    """Build (or open the cached build of) the library; seconds taken."""
    t0 = time.perf_counter()
    LIBRARY.load()
    return time.perf_counter() - t0


class Plan(NamedTuple):
    variant: str        # "row" | "row_generic"
    width: int          # columns a launch covers per row: k, 4 (generic)
    lanes: int          # threads per row
    grid: Tuple[int, int]
    threads: int
    ordered: bool       # blocks visited in ``block_order``


def lanes(row_bytes: int) -> int:
    """Threads that share a row of ``row_bytes``: one per 32 bytes.  The
    kernel compiles each width for these lanes and refuses a launch
    planned for others."""
    return 1 if row_bytes <= 32 else row_bytes // 32


def launch_plan(name: str, n: int, k: int, dtype: torch.dtype,
                aligned: bool = True) -> Plan:
    """The launch of wrapper ``name`` over n rows and k columns: variant,
    columns, threads per row, grid, block size and block order.  ``aligned``: every dense operand starts on a 16-byte boundary
    (the compiled widths read rows with 16-byte loads).  The slice height
    C does not enter: the row kernels take any C."""
    if name not in _KIND:
        raise ValueError(f"unknown SELL-C-σ kernel {name!r}")
    itemsize = torch.empty((), dtype=dtype).element_size()
    ordered = name == "sellcs_spmm"
    if k in ROW_WIDTHS and aligned:
        g = lanes(k * itemsize)
        return Plan("row", k, g, (-(-n * g // THREADS), 1), THREADS,
                    ordered)
    return Plan("row_generic", GENERIC_WIDTH, 1,
                (-(-n // THREADS), -(-k // GENERIC_WIDTH)), THREADS, ordered)


def block_order(L, plan: Plan) -> torch.Tensor:
    """The row kernel's blocks sorted by the original id of their first
    row (int32, on the layout's device), cached on the layout per threads
    per row.  The global degree sort of SELL-C-σ interleaves rows from all
    over X; visiting the blocks in this order keeps the rows they gather
    in L2."""
    order = L.block_orders.get(plan.lanes)
    if order is None:
        blocks = torch.arange(plan.grid[0], device=L.perm.device)
        first = (blocks * plan.threads // plan.lanes).clamp(max=L.n - 1)
        order = torch.argsort(L.perm[first].long(), stable=True).to(
            torch.int32)
        L.block_orders[plan.lanes] = order
    return order


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
    if not L.vals.is_contiguous():
        raise ValueError("the layout's values must be contiguous")
    if L.vals.ndim == 2 and L.vals.shape[1] != X.shape[1]:
        raise ValueError(f"(nnz, {L.vals.shape[1]}) multivalues against a "
                         f"(n, {X.shape[1]}) multivector")
    if X.device.type == "cpu":
        return False
    if X.device.type != "cuda":
        raise ValueError(f"no SELL-C-σ kernel for device {X.device}")
    return True


def _launch(name: str, A, X: torch.Tensor, E: torch.Tensor, p: float = 0.0,
            eps: float = 0.0) -> torch.Tensor:
    """One launch of wrapper ``name``'s kernel over the whole layout."""
    L = A.sell_kernel
    n, k = X.shape
    if n * k >= 2 ** 31 * THREADS:
        raise ValueError("multivector too large for the kernels' grid")
    Y = torch.empty_like(X)
    multivalue = L.vals.ndim == 2
    vector_operands = (X, E, Y, L.vals) if multivalue else (X, E, Y)
    aligned = all(t.data_ptr() % 16 == 0 for t in vector_operands)
    plan = launch_plan(name, n, k, X.dtype, aligned)
    order = block_order(L, plan) if plan.ordered else None
    lib = LIBRARY.load()
    dev = X.device.index if X.device.index is not None \
        else torch.cuda.current_device()
    code = lib.sellcs_launch(
        _KIND[name], int(X.dtype == torch.float64), int(multivalue),
        plan.width if plan.variant == "row" else 0, plan.lanes, dev, L.slice_ptr.data_ptr(), L.slice_w.data_ptr(), L.perm.data_ptr(),
        L.cols.data_ptr(), L.vals.data_ptr(), X.data_ptr(), E.data_ptr(),
        Y.data_ptr(), None if order is None else order.data_ptr(), n, L.C,
        k, float(p), float(eps),
        torch.cuda.current_stream(X.device).cuda_stream)
    check(lib, code, name)
    LAUNCHES[name] += 1
    if name == "sellcs_spmm":
        shape = f"{'multivalue' if multivalue else 'scalar'} k={k}"
        LAUNCHES_BY_SHAPE[shape] = LAUNCHES_BY_SHAPE.get(shape, 0) + 1
    return Y


def sellcs_spmm(A, X: torch.Tensor) -> torch.Tensor:
    """Reals-ring SpMM over the whole SELL-C-σ layout (one launch)."""
    if not _check(A, X):
        return sellcs_spmm_plain(A, X)
    return _launch("sellcs_spmm", A, X, X)


def sellcs_plap_apply(A, X: torch.Tensor, p: float, eps: float) -> torch.Tensor:
    """p-Laplacian apply over the whole SELL-C-σ layout (one launch)."""
    if A.vals.ndim != 1:
        raise ValueError("the p-Laplacian apply takes scalar edge weights")
    if not _check(A, X):
        return sellcs_plap_apply_plain(A, X, p, eps)
    return _launch("sellcs_plap_apply", A, X, X, p, eps)


def sellcs_plap_hvp(A, U: torch.Tensor, E: torch.Tensor, p: float,
                    eps: float) -> torch.Tensor:
    """Matrix-free Newton HVP (Hess A part) over the whole layout."""
    if A.vals.ndim != 1:
        raise ValueError("the p-Laplacian HVP takes scalar edge weights")
    if not _check(A, U, E):
        return sellcs_plap_hvp_plain(A, U, E, p, eps)
    return _launch("sellcs_plap_hvp", A, U, E, p, eps)
