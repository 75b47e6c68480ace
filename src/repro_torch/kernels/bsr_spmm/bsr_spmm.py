"""BSR SpMM: a CUDA kernel for GPU tensors, its PyTorch twin for CPU.

    bsr_spmm(A, X)      Y = A X over A's dense (bs, bs) tiles

``csrc/bsr_spmm.cu`` replaces the reference's Pallas
``bsr_spmm_pallas``.  The wrapper takes a SparseMatrix with the BSR
layout built (tiles of at most 128 x 128 for the kernel) and an
(n_cols, k) multivector and returns (n_rows, k).  For CUDA tensors it
launches the kernel, one launch per column window of ``spmm_windows``
(one window for every k the pipeline uses: 4, 8 and 24), each counted
in ``LAUNCHES``, or raises; it never falls back.  For CPU tensors it
runs the plain version ``bsr_spmm_plain``: the multivector zero-padded
to whole blocks, then ``bsr_spmm_ref``, the port of the reference's
``kernels/bsr_spmm/ref.py``.

The operand checks, the tile limit (``MAX_BLOCK``), the padding and the
launch arguments here are shared with ``kernels/plap_edge``.  The
library is built with nvcc at first CUDA use (``build``/
``start_build``) into ``build/torch_ext/``; importing this module builds
nothing.
"""
from __future__ import annotations

import time
from pathlib import Path
from typing import Dict

import torch

from repro_torch.kernels.nvcc import I32, I64, PTR, NvccLibrary, check

LIBRARY = NvccLibrary(
    "bsr_spmm", Path(__file__).resolve().parent / "csrc" / "bsr_spmm.cu",
    {"bsr_spmm_launch": (I32, [I32, I32, PTR, PTR, PTR, PTR, PTR, I32, I32,
                               I32, I32, I32, I32, I32, I32, I64, PTR])})

# kernel launches per wrapper: incremented where the kernel is launched
# and nowhere else; the same launches by the window's column count
LAUNCHES = {"bsr_spmm": 0}
LAUNCHES_BY_WIDTH: Dict[int, int] = {}

# the BSR kernels' tiles: for the SpMM 32 lanes of a warp x at most 4
# rows each; the phi kernels pack a tile's (row, column) in 8 bits each
MAX_BLOCK = 128
# the window widths the SpMM kernel is compiled for (its register tile's
# columns); a window of kc columns runs on the narrowest width >= kc
SPMM_WIDTHS = {torch.float32: (4, 8, 16, 24, 32),
               torch.float64: (2, 4, 8, 16)}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    LAUNCHES_BY_WIDTH.clear()


def start_build() -> None:
    """Start nvcc in the background (returns at once)."""
    LIBRARY.start()


def build() -> float:
    """Build (or open the cached build of) the library; seconds taken."""
    t0 = time.perf_counter()
    LIBRARY.load()
    return time.perf_counter() - t0


# ------------------------------------------------------------ plain twins

def bsr_spmm_ref(blocks, indices, row_ids, X, n_row_blocks: int,
                 block_size: int = 128):
    """Y[rb] = sum_b [row_ids[b] == rb] blocks[b] @ X[indices[b]].  X has
    whole blocks of rows: (n_col_blocks * bs, k)."""
    bs = block_size
    k = X.shape[1]
    Xb = X.reshape(-1, bs, k)
    prod = torch.einsum("bij,bjk->bik", blocks, Xb[indices.long()])
    out = torch.zeros((n_row_blocks, bs, k), dtype=X.dtype, device=X.device)
    out.index_add_(0, row_ids.long(), prod)
    return out.reshape(n_row_blocks * bs, k)


def pad_rows(A, *Xs):
    """Zero-pad multivectors to whole blocks of rows, enough for every
    row- and column-block of A (the reference pads to n_rb * bs, which
    is the same for a square matrix)."""
    bs = A.block_size
    n_pad = bs * max(len(A.bsr_indptr) - 1, -(-A.n_cols // bs))
    return [torch.nn.functional.pad(X, (0, 0, 0, n_pad - X.shape[0]))
            for X in Xs]


def bsr_spmm_plain(A, X):
    (Xp,) = pad_rows(A, X)
    n_rb = len(A.bsr_indptr) - 1
    return bsr_spmm_ref(A.bsr_blocks, A.bsr_indices, A.bsr_row_ids, Xp, n_rb,
                        A.block_size)[:A.n_rows]


# --------------------------------------------------------------- wrappers

def check_operands(A, *Xs) -> bool:
    """Validate the operands of a BSR kernel; True for the CUDA kernel,
    False for the CPU twin.  Raises on anything the kernel does not
    take."""
    if A.bsr_blocks is None:
        raise ValueError("the BSR layout is not built on this matrix")
    blocks = A.bsr_blocks
    X = Xs[0]
    for Z in Xs:
        if Z.dtype not in (torch.float32, torch.float64):
            raise TypeError(f"multivector dtype {Z.dtype}: the kernels take "
                            "float32 or float64")
        if Z.dtype != blocks.dtype:
            raise TypeError(f"multivector dtype {Z.dtype} != matrix dtype "
                            f"{blocks.dtype}")
        if Z.ndim != 2 or Z.shape != X.shape or Z.shape[0] != A.n_cols:
            raise ValueError(f"multivector shape {tuple(Z.shape)}: expected "
                             f"({A.n_cols}, k), all operands alike")
        if not Z.is_contiguous():
            raise ValueError("multivectors must be contiguous")
        if Z.device != blocks.device:
            raise ValueError(f"multivector on {Z.device}, matrix on "
                             f"{blocks.device}")
    if X.device.type == "cpu":
        return False
    if X.device.type != "cuda":
        raise ValueError(f"no BSR kernel for device {X.device}")
    if max(A.n_rows, A.n_cols) >= 2 ** 31:
        raise ValueError("the BSR kernels index rows with int32")
    return True


def spmm_windows(k: int, dtype: torch.dtype) -> list:
    """(c0, kc, width) launches of the SpMM kernel over k columns: windows
    of the widest compiled width, the last one on the narrowest width
    that holds it."""
    widths = SPMM_WIDTHS[dtype]
    out = []
    for c0 in range(0, k, widths[-1]):
        kc = min(widths[-1], k - c0)
        out.append((c0, kc, min(w for w in widths if w >= kc)))
    return out


def launch_args(A, *tensors):
    """(device index, pointers of the layout and the tensors) and the
    current stream, for ctypes."""
    dev = A.bsr_blocks.device
    return ([dev.index if dev.index is not None else torch.cuda.current_device(),
             A.bsr_indptr_dev.data_ptr(), A.bsr_indices.data_ptr(),
             A.bsr_blocks.data_ptr()] + [t.data_ptr() for t in tensors],
            torch.cuda.current_stream(dev).cuda_stream)


def bsr_spmm(A, X: torch.Tensor) -> torch.Tensor:
    """Reals-ring SpMM over A's BSR tiles."""
    if not check_operands(A, X):
        return bsr_spmm_plain(A, X)
    if A.block_size > MAX_BLOCK:
        raise ValueError(f"block_size={A.block_size}: the bsr_spmm kernel "
                         f"takes tiles of at most {MAX_BLOCK}")
    lib = LIBRARY.load()
    k = X.shape[1]
    Y = torch.empty((A.n_rows, k), dtype=X.dtype, device=X.device)
    args, stream = launch_args(A, X, Y)
    for c0, kc, width in spmm_windows(k, X.dtype):
        code = lib.bsr_spmm_launch(
            int(X.dtype == torch.float64), *args, len(A.bsr_indptr) - 1,
            A.n_rows, A.n_cols, A.block_size, k, c0, kc, width,
            int(A.bsr_blocks.shape[0]), stream)
        check(lib, code, "bsr_spmm")
        LAUNCHES["bsr_spmm"] += 1
        LAUNCHES_BY_WIDTH[kc] = LAUNCHES_BY_WIDTH.get(kc, 0) + 1
    return Y
