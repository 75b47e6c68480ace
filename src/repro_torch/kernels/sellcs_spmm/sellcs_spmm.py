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

Two more wrappers drive the same kernels over one rank's shard of a
distributed partition (the "dist_sellcs" backend, ``grblas.dist``)::

    sellcs_shard_spmm(sh, x_src)             y = sum vals * x_src[cols]
    sellcs_shard_plap_apply(sh, x_src, p, eps)

``sh`` is a ``ShardLayout`` (``shard_layout``): the shard's width runs
as the slot-major ``SellKernelLayout`` the row kernel reads, with
``perm`` the packed rows' own ids offset by ``row0``, and ``x_src`` the
shard's extended-local vector (its own rows from ``row0``, then the halo
slots; the whole gathered vector under a gather plan).  They return the
shard's (R, k) rows in local order and count their launches in
``SHARD_LAUNCHES`` (by kind and k); the plain versions are the ports of
the reference's ``sellcs_shard_*_ref``.

``launch_plan`` routes a launch: every wrapper runs the row kernel at a
compiled width (k = 4, 8, 16, 24, with 16-byte loads; ``lanes`` threads
a row, one per 32 bytes of it; and k = 1, one value a thread, at any
alignment) or its generic variant (chunks of 4 columns, scalar loads);
how many slots a thread takes at once is the kernel's own choice.  The
generic variant's launches are also counted in ``GENERIC_LAUNCHES``.
The reals ring visits the blocks in the order ``block_order`` gives (by
the original id of their first row, cached on the layout); the apply and
the HVP keep launch order.

The library is built with nvcc (``kernels/nvcc.py``) at first CUDA use
(or by ``build``/``start_build``) into ``build/torch_ext/`` at the root
of the checkout and opened with ctypes; importing this module builds
nothing.
"""
from __future__ import annotations

import dataclasses
import time
from pathlib import Path
from typing import Dict, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import phi as PHI
from repro_torch.grblas.containers import SellKernelLayout
from repro_torch.kernels.nvcc import F64, I32, PTR, NvccLibrary, check

LIBRARY = NvccLibrary(
    "sellcs_spmm",
    Path(__file__).resolve().parent / "csrc" / "sellcs_kernels.cu",
    {"sellcs_launch": (I32, [I32, I32, I32, I32, I32, I32, PTR, PTR, PTR,
                             PTR, PTR, PTR, PTR, PTR, PTR, I32, I32, I32,
                             F64, F64, PTR])})

# kernel launches per wrapper: incremented where the kernel is launched
# and nowhere else; sellcs_spmm's launches also by shape ("scalar k=8",
# "multivalue k=4"), sellcs_plap_apply's also by k
LAUNCHES = {"sellcs_spmm": 0, "sellcs_plap_apply": 0, "sellcs_plap_hvp": 0}
LAUNCHES_BY_SHAPE: Dict[str, int] = {}
APPLY_LAUNCHES_BY_K: Dict[int, int] = {}
# launches of the generic variant, by wrapper (global and shard launches)
GENERIC_LAUNCHES = {"sellcs_spmm": 0, "sellcs_plap_apply": 0,
                    "sellcs_plap_hvp": 0}
# shard launches (the dist_sellcs backend) by kind and k, in this
# process (one rank): "sellcs_shard_spmm k=8", "sellcs_shard_plap_apply
# k=4"
SHARD_LAUNCHES: Dict[str, int] = {}

_KIND = {"sellcs_spmm": 0, "sellcs_plap_apply": 1, "sellcs_plap_hvp": 2}
# the widths the row kernel is compiled for (16-byte loads; width 1 one
# value a thread); any other k runs the generic variant on chunks of
# GENERIC_WIDTH columns
ROW_WIDTHS = (1, 4, 8, 16, 24)
GENERIC_WIDTH = 4
THREADS = 256       # threads per block (kThreads)


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
        GENERIC_LAUNCHES[name] = 0
    LAUNCHES_BY_SHAPE.clear()
    APPLY_LAUNCHES_BY_K.clear()
    SHARD_LAUNCHES.clear()


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
    columns, threads per row, grid, block size and block order.
    ``aligned``: every dense operand starts on a 16-byte boundary (the
    compiled widths 4 to 24 read rows with 16-byte loads; width 1 reads
    one value and takes the row kernel whatever ``aligned`` says).  The
    slice height C does not enter: the row kernels take any C."""
    if name not in _KIND:
        raise ValueError(f"unknown SELL-C-σ kernel {name!r}")
    itemsize = torch.empty((), dtype=dtype).element_size()
    if k in ROW_WIDTHS and (aligned or k == 1):
        g = lanes(k * itemsize)
        return Plan("row", k, g, (-(-n * g // THREADS), 1), THREADS,
                    name == "sellcs_spmm")
    return _generic_plan(name, n, k)


def _generic_plan(name: str, n: int, k: int) -> Plan:
    """The generic variant's launch: one thread a row and chunk of
    GENERIC_WIDTH columns (grid y)."""
    return Plan("row_generic", GENERIC_WIDTH, 1,
                (-(-n // THREADS), -(-k // GENERIC_WIDTH)), THREADS,
                name == "sellcs_spmm")


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


def _enqueue(name: str, L, X: torch.Tensor, E: torch.Tensor, Y: torch.Tensor,
             n: int, p: float, eps: float, generic: bool = False) -> None:
    """Plan and enqueue one launch of ``name``'s kernel over the first n
    permuted rows of layout L (it reads X and E, writes Y at ``perm``);
    ``generic``: the generic variant whatever the plan (for comparing the
    two on the card)."""
    k = X.shape[1]
    if n * k >= 2 ** 31 * THREADS:
        raise ValueError("multivector too large for the kernels' grid")
    multivalue = L.vals.ndim == 2
    vector_operands = (X, E, Y, L.vals) if multivalue else (X, E, Y)
    aligned = all(t.data_ptr() % 16 == 0 for t in vector_operands)
    plan = (_generic_plan(name, n, k) if generic
            else launch_plan(name, n, k, X.dtype, aligned))
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
    if plan.variant == "row_generic":
        GENERIC_LAUNCHES[name] += 1


def _launch(name: str, A, X: torch.Tensor, E: torch.Tensor, p: float = 0.0,
            eps: float = 0.0, generic: bool = False) -> torch.Tensor:
    """One launch of wrapper ``name``'s kernel over the whole layout
    (``generic``: see ``_enqueue``)."""
    L = A.sell_kernel
    Y = torch.empty_like(X)
    _enqueue(name, L, X, E, Y, X.shape[0], p, eps, generic)
    LAUNCHES[name] += 1
    k = X.shape[1]
    if name == "sellcs_spmm":
        shape = f"{'multivalue' if L.vals.ndim == 2 else 'scalar'} k={k}"
        LAUNCHES_BY_SHAPE[shape] = LAUNCHES_BY_SHAPE.get(shape, 0) + 1
    elif name == "sellcs_plap_apply":
        APPLY_LAUNCHES_BY_K[k] = APPLY_LAUNCHES_BY_K.get(k, 0) + 1
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


# ------------------------------------------- shard launches (dist_sellcs)

@dataclasses.dataclass
class ShardLayout:
    """One rank's slice of a ``grblas.dist.DistSellCS`` on a device.

    ``runs`` holds the shard's width runs as the reference stores them,
    (cols (rows_r, w_r) int32, vals (rows_r, w_r), own (rows_r,) int32),
    for the plain versions; ``inv`` (R,) maps a local row to its packed
    position.  ``kernel`` is the same shard slot-major for the row
    kernel: ``n`` = R real rows (the pad rows of the last slice are not
    launched: they hold own = 0 and would write local row 0), ``perm`` =
    own + ``row0`` (x_i is ``x_src[row0 + own]`` and the kernel writes
    row ``row0 + own`` of its output).  ``x_rows``: the rows ``x_src``
    must have, the largest column id + 1 and at least row0 + R.
    """

    runs: Tuple[Tuple[torch.Tensor, torch.Tensor, torch.Tensor], ...]
    inv: torch.Tensor
    kernel: SellKernelLayout
    row0: int
    x_rows: int

    @property
    def n(self) -> int:
        return self.kernel.n


def shard_layout(run_cols: Sequence[np.ndarray],
                 run_vals: Sequence[np.ndarray],
                 run_own: Sequence[np.ndarray], inv: np.ndarray, C: int,
                 row0: int, device) -> ShardLayout:
    """A ``ShardLayout`` on ``device`` from one shard's host runs
    (``DistSellCS.run_*[i][d]``, run-major (rows_r, w_r)) and
    ``DistSellCS.inv[d]``; ``row0``: where the shard's own rows start in
    ``x_src`` (0 under a halo plan, d*R under a gather plan)."""
    R = int(len(inv))
    k_cols, k_vals, own_all, widths = [], [], [], []
    for c, v, o in zip(run_cols, run_vals, run_own):
        rows_r, w = c.shape
        ns = rows_r // C
        # run-major (slices, C, w) -> slot-major (slices, w, C)
        k_cols.append(c.reshape(ns, C, w).transpose(0, 2, 1).reshape(-1))
        k_vals.append(v.reshape(ns, C, w).transpose(0, 2, 1).reshape(-1))
        own_all.append(o)
        widths += [w] * ns
    slice_w = np.asarray(widths, np.int64)
    slots = slice_w * C
    if int(slots.sum()) >= 2 ** 31:
        raise ValueError("shard layout exceeds 2^31 stored slots; the "
                         "kernels index with int32")
    slice_ptr = np.concatenate([[0], np.cumsum(slots)[:-1]])
    cols = np.concatenate(k_cols)
    perm = np.concatenate(own_all)[:R].astype(np.int64) + int(row0)
    x_rows = max(int(cols.max()) + 1 if cols.size else 0, int(row0) + R)
    to = lambda a, dt=None: torch.as_tensor(
        a if dt is None else a.astype(dt), device=device)
    kernel = SellKernelLayout(
        n=R, C=int(C), slice_ptr=to(slice_ptr, np.int32),
        slice_w=to(slice_w, np.int32), perm=to(perm, np.int32),
        cols=to(cols, np.int32), vals=to(np.concatenate(k_vals)),
        scatter=None)          # no COO behind a shard: with_vals is unused
    runs = tuple((to(c), to(v), to(o)) for c, v, o in
                 zip(run_cols, run_vals, run_own))
    return ShardLayout(runs=runs, inv=to(inv, np.int64), kernel=kernel,
                       row0=int(row0), x_rows=x_rows)


def sellcs_shard_spmm_ref(cols, vals, x_src):
    """Reals-ring run of one shard: y = sum_w vals * x_src[cols]."""
    return torch.sum(vals[..., None] * x_src[cols.long()], dim=1)


def sellcs_shard_plap_apply_ref(cols, vals, x_src, x_own, p: float,
                                eps: float):
    """p-Laplacian apply run of one shard; x_own: (rows, k) the packed
    rows' own entries."""
    g = x_src[cols.long()]                         # x_j  (rows, w, k)
    return torch.sum(vals[..., None] * PHI.phi(x_own[:, None, :] - g, p,
                                               eps), dim=1)


def sellcs_shard_spmm_plain(sh: ShardLayout, x_src):
    return torch.cat([sellcs_shard_spmm_ref(c, v, x_src)
                      for c, v, _ in sh.runs], dim=0)[sh.inv]


def sellcs_shard_plap_apply_plain(sh: ShardLayout, x_src, p: float,
                                  eps: float):
    return torch.cat([
        sellcs_shard_plap_apply_ref(c, v, x_src,
                                    x_src[sh.row0 + o.long()], p, eps)
        for c, v, o in sh.runs], dim=0)[sh.inv]


def _shard_check(sh: ShardLayout, X: torch.Tensor) -> bool:
    """Validate a shard launch's operand; True for the CUDA kernel,
    False for the CPU twin.  X must reach every column id and the
    shard's own rows (the global wrappers' X.shape[0] == n does not
    hold here: X is R + S*H rows, or the gathered vector)."""
    vals = sh.kernel.vals
    if X.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"multivector dtype {X.dtype}: the kernels take "
                        "float32 or float64")
    if X.dtype != vals.dtype:
        raise TypeError(f"multivector dtype {X.dtype} != shard dtype "
                        f"{vals.dtype}")
    if X.ndim != 2 or X.shape[0] < sh.x_rows:
        raise ValueError(f"x_src shape {tuple(X.shape)}: expected "
                         f"(>= {sh.x_rows}, k)")
    if not X.is_contiguous():
        raise ValueError("x_src must be contiguous")
    if X.device != vals.device:
        raise ValueError(f"x_src on {X.device}, shard on {vals.device}")
    if X.device.type == "cpu":
        return False
    if X.device.type != "cuda":
        raise ValueError(f"no SELL-C-σ kernel for device {X.device}")
    return True


def _shard_launch(name: str, sh: ShardLayout, X: torch.Tensor,
                  p: float = 0.0, eps: float = 0.0) -> torch.Tensor:
    """One launch of ``name``'s kernel over the shard's R real rows; the
    kernel writes rows row0 .. row0 + R - 1 of its output."""
    Y = torch.empty((sh.row0 + sh.n, X.shape[1]), dtype=X.dtype,
                    device=X.device)
    _enqueue(name, sh.kernel, X, X, Y, sh.n, p, eps)
    key = f"{name.replace('sellcs_', 'sellcs_shard_')} k={X.shape[1]}"
    SHARD_LAUNCHES[key] = SHARD_LAUNCHES.get(key, 0) + 1
    return Y[sh.row0:]


def sellcs_shard_spmm(sh: ShardLayout, x_src: torch.Tensor) -> torch.Tensor:
    """Reals-ring SpMM of one shard (one launch): (R, k) in local order."""
    if not _shard_check(sh, x_src):
        return sellcs_shard_spmm_plain(sh, x_src)
    return _shard_launch("sellcs_spmm", sh, x_src)


def sellcs_shard_plap_apply(sh: ShardLayout, x_src: torch.Tensor, p: float,
                            eps: float) -> torch.Tensor:
    """p-Laplacian apply of one shard (one launch): (R, k) in local
    order."""
    if not _shard_check(sh, x_src):
        return sellcs_shard_plap_apply_plain(sh, x_src, p, eps)
    return _shard_launch("sellcs_plap_apply", sh, x_src, p, eps)
