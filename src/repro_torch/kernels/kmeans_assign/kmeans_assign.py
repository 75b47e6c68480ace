"""Fused kmeans assignment: the CUDA kernel and its wrapper.

    kmeans_assign_cuda(X, C)   (labels int32, min sqdist) on the card

``csrc/kmeans_assign.cu`` replaces the reference's Pallas
``kmeans_assign_pallas``.  X is (n, d) and C is (kc, d) or a batch of
centroid sets (R, kc, d); the outputs are (n,) or (R, n).  The wrapper
takes CUDA tensors only: it checks device, dtype, shape, contiguity and
the kernel's caps, launches, raises on a CUDA error and counts the
launch in ``LAUNCHES``.  ``ops.kmeans_assign`` is the public function;
it sends CPU tensors to the plain version in ``ref.py``.

The library is built with nvcc at first use (``build``/``start_build``)
into ``build/torch_ext/``; importing this module builds nothing.
"""
from __future__ import annotations

import time
from pathlib import Path
from typing import Tuple

import torch

from repro_torch.kernels.nvcc import I32, PTR, NvccLibrary, check

LIBRARY = NvccLibrary(
    "kmeans_assign",
    Path(__file__).resolve().parent / "csrc" / "kmeans_assign.cu",
    {"kmeans_assign_launch": (I32, [I32, I32, PTR, PTR, PTR, PTR, I32, I32,
                                    I32, I32, PTR])})

# kernel launches: incremented where the kernel is launched and nowhere
# else
LAUNCHES = {"kmeans_assign": 0}

MAX_CENTROIDS = 128          # the reference kernel's cap (kc <= 128)
MAX_DIM = 64                 # the widest row the kernel keeps in registers
SMEM_LIMIT = 232448          # shared memory one thread block may use
ROWS_PER_BLOCK = 256         # kRows in the kernel


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


def check_operands(X: torch.Tensor, C: torch.Tensor) -> None:
    """Raise on operands that neither the kernel nor the plain version
    takes."""
    if X.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"X dtype {X.dtype}: kmeans_assign takes float32 "
                        "or float64")
    if C.dtype != X.dtype:
        raise TypeError(f"centroid dtype {C.dtype} != X dtype {X.dtype}")
    if X.ndim != 2 or C.ndim not in (2, 3) or C.shape[-1] != X.shape[1]:
        raise ValueError(f"shapes X {tuple(X.shape)}, C {tuple(C.shape)}: "
                         "expected X (n, d) and C (kc, d) or (R, kc, d)")
    if C.device != X.device:
        raise ValueError(f"X on {X.device}, centroids on {C.device}")


def kmeans_assign_cuda(X: torch.Tensor, C: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch of the kernel over every centroid set of C."""
    check_operands(X, C)
    if X.device.type != "cuda":
        raise ValueError(f"the kmeans_assign kernel takes CUDA tensors, "
                         f"not {X.device}")
    if not (X.is_contiguous() and C.is_contiguous()):
        raise ValueError("X and C must be contiguous")
    n, d = X.shape
    kc = C.shape[-2]
    R = C.shape[0] if C.ndim == 3 else 1
    if n < 1 or kc < 1 or R < 1:
        raise ValueError(f"empty operand: n={n}, kc={kc}, R={R}")
    if kc > MAX_CENTROIDS:
        raise ValueError(f"kc={kc} centroids: the kernel takes at most "
                         f"{MAX_CENTROIDS}")
    if d > MAX_DIM:
        raise ValueError(f"d={d}: the kernel takes rows of at most "
                         f"{MAX_DIM} values")
    smem = X.element_size() * (R * kc * (d + 1) + ROWS_PER_BLOCK * (d | 1))
    if smem > SMEM_LIMIT:
        raise ValueError(f"{R} x {kc} centroids of width {d} need {smem} "
                         "bytes of shared memory, more than one block has")
    if n >= 2 ** 31:
        raise ValueError("the kernel indexes rows with int32")
    lib = LIBRARY.load()
    labels = torch.empty((R, n), dtype=torch.int32, device=X.device)
    dist = torch.empty((R, n), dtype=X.dtype, device=X.device)
    dev = X.device.index if X.device.index is not None \
        else torch.cuda.current_device()
    code = lib.kmeans_assign_launch(
        int(X.dtype == torch.float64), dev, X.data_ptr(), C.data_ptr(),
        labels.data_ptr(), dist.data_ptr(), n, d, kc, R,
        torch.cuda.current_stream(X.device).cuda_stream)
    check(lib, code, "kmeans_assign")
    LAUNCHES["kmeans_assign"] += 1
    if C.ndim == 2:
        return labels[0], dist[0]
    return labels, dist
