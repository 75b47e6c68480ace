"""Fused kmeans assignment: the CUDA kernels and their wrappers.

    kmeans_assign_cuda(X, C)        the narrow variant, one launch
    kmeans_assign_wide_cuda(X, C)   the wide variant, one launch
    kmeans_assign_planned(X, C)     every launch of ``launch_plan``

``csrc/kmeans_assign.cu`` replaces the reference's Pallas
``kmeans_assign_pallas``.  X is (n, d) and C is (kc, d) or a batch of
centroid sets (R, kc, d); the outputs (labels int32, min sqdist) are
(n,) or (R, n).  The narrow variant keeps a row in registers and every
centroid set of the launch in shared memory, so it takes d <= 64,
kc <= 128 and what fits ``SMEM_LIMIT``; the wide variant tiles rows and
centroids through shared memory and takes any d and kc.
``launch_plan(R, kc, d, itemsize)`` routes a call: the narrow variant
with the restarts split into groups that fit, or the wide variant for
d > 64 or kc > 128.  The wrappers take CUDA tensors only: they check
device, dtype, shape, contiguity and the variant's caps, launch, raise
on a CUDA error and count each launch in ``LAUNCHES`` under the
variant's name.  ``ops.kmeans_assign`` is the public function; it sends
CPU tensors to the plain version in ``ref.py`` and CUDA tensors to
``kmeans_assign_planned``, never to the plain version.

The library is built with nvcc at first use (``build``/``start_build``)
into ``build/torch_ext/``; importing this module builds nothing.
"""
from __future__ import annotations

import time
from pathlib import Path
from typing import List, Tuple

import torch

from repro_torch.kernels.nvcc import I32, PTR, NvccLibrary, check

LIBRARY = NvccLibrary(
    "kmeans_assign",
    Path(__file__).resolve().parent / "csrc" / "kmeans_assign.cu",
    {name: (I32, [I32, I32, PTR, PTR, PTR, PTR, I32, I32, I32, I32, PTR])
     for name in ("kmeans_assign_launch", "kmeans_assign_wide_launch")})

# kernel launches per variant: incremented where the kernel is launched
# and nowhere else
LAUNCHES = {"kmeans_assign": 0, "kmeans_assign_wide": 0}

MAX_CENTROIDS = 128          # the narrow variant's cap (the reference's)
MAX_DIM = 64                 # the widest row it keeps in registers
SMEM_LIMIT = 232448          # shared memory one thread block may use
ROWS_PER_BLOCK = 256         # kRows in the narrow kernel
WIDE_ROWS_PER_BLOCK = 128    # kWRows in the wide kernel
MAX_SETS = 65535             # centroid sets of one wide launch (grid y)


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


def narrow_smem(R: int, kc: int, d: int, itemsize: int) -> int:
    """Shared memory of one narrow launch over R centroid sets: the
    centroids and their norms, and the block's rows of X."""
    return itemsize * (R * kc * (d + 1) + ROWS_PER_BLOCK * (d | 1))


def launch_plan(R: int, kc: int, d: int, itemsize: int
                ) -> List[Tuple[str, int, int]]:
    """The launches of one assignment over R centroid sets of kc
    centroids of width d: [(variant, r0, r1)], each over sets
    [r0, r1).  The narrow variant where d <= 64 and kc <= 128, with the
    sets split into the fewest groups whose centroids fit
    ``SMEM_LIMIT``; else the wide variant, whose shared memory does not
    depend on the shapes, in groups of at most ``MAX_SETS``."""
    if d > MAX_DIM or kc > MAX_CENTROIDS:
        variant, per = "wide", MAX_SETS
    else:
        variant = "narrow"
        per = ((SMEM_LIMIT - narrow_smem(0, kc, d, itemsize))
               // (itemsize * kc * (d + 1)))
    return [(variant, r0, min(R, r0 + per)) for r0 in range(0, R, per)]


def _operands(X, C, name):
    """Check a launch's operands; (C as (R, kc, d), n, d, kc, R)."""
    check_operands(X, C)
    if X.device.type != "cuda":
        raise ValueError(f"the {name} kernel takes CUDA tensors, not "
                         f"{X.device}")
    if not (X.is_contiguous() and C.is_contiguous()):
        raise ValueError("X and C must be contiguous")
    n, d = X.shape
    C3 = C if C.ndim == 3 else C[None]
    R, kc = C3.shape[0], C3.shape[1]
    if n < 1 or kc < 1 or R < 1 or d < 1:
        raise ValueError(f"empty operand: n={n}, d={d}, kc={kc}, R={R}")
    if n >= 2 ** 31:
        raise ValueError("the kernels index rows with int32")
    return C3, n, d, kc, R


def _launch(fn: str, name: str, X, C3, labels, dist) -> None:
    """One launch over the sets of C3 into the (R, n) outputs."""
    lib = LIBRARY.load()
    n, d = X.shape
    R, kc = C3.shape[0], C3.shape[1]
    dev = X.device.index if X.device.index is not None \
        else torch.cuda.current_device()
    code = getattr(lib, fn)(
        int(X.dtype == torch.float64), dev, X.data_ptr(), C3.data_ptr(),
        labels.data_ptr(), dist.data_ptr(), n, d, kc, R,
        torch.cuda.current_stream(X.device).cuda_stream)
    check(lib, code, name)
    LAUNCHES[name] += 1


def _outputs(X, R, n):
    return (torch.empty((R, n), dtype=torch.int32, device=X.device),
            torch.empty((R, n), dtype=X.dtype, device=X.device))


def _shaped(C, labels, dist):
    return (labels[0], dist[0]) if C.ndim == 2 else (labels, dist)


def kmeans_assign_cuda(X: torch.Tensor, C: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch of the narrow kernel over every centroid set of C;
    raises where the narrow kernel cannot take them."""
    C3, n, d, kc, R = _operands(X, C, "kmeans_assign")
    if kc > MAX_CENTROIDS:
        raise ValueError(f"kc={kc} centroids: the kernel takes at most "
                         f"{MAX_CENTROIDS}")
    if d > MAX_DIM:
        raise ValueError(f"d={d}: the kernel takes rows of at most "
                         f"{MAX_DIM} values")
    smem = narrow_smem(R, kc, d, X.element_size())
    if smem > SMEM_LIMIT:
        raise ValueError(f"{R} x {kc} centroids of width {d} need {smem} "
                         "bytes of shared memory, more than one block has")
    labels, dist = _outputs(X, R, n)
    _launch("kmeans_assign_launch", "kmeans_assign", X, C3, labels, dist)
    return _shaped(C, labels, dist)


def kmeans_assign_wide_cuda(X: torch.Tensor, C: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch of the wide kernel over every centroid set of C (any d
    and kc; at most ``MAX_SETS`` sets)."""
    C3, n, d, kc, R = _operands(X, C, "kmeans_assign_wide")
    if R > MAX_SETS:
        raise ValueError(f"{R} centroid sets: one wide launch takes at "
                         f"most {MAX_SETS}")
    labels, dist = _outputs(X, R, n)
    _launch("kmeans_assign_wide_launch", "kmeans_assign_wide", X, C3, labels,
            dist)
    return _shaped(C, labels, dist)


def kmeans_assign_planned(X: torch.Tensor, C: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every launch of ``launch_plan`` for this call, each into its sets'
    rows of the outputs."""
    C3, n, d, kc, R = _operands(X, C, "kmeans_assign")
    labels, dist = _outputs(X, R, n)
    for variant, r0, r1 in launch_plan(R, kc, d, X.element_size()):
        fn, name = {"narrow": ("kmeans_assign_launch", "kmeans_assign"),
                    "wide": ("kmeans_assign_wide_launch",
                             "kmeans_assign_wide")}[variant]
        _launch(fn, name, X, C3[r0:r1], labels[r0:r1], dist[r0:r1])
    return _shaped(C, labels, dist)
