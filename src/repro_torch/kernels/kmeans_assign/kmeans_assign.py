"""Fused kmeans assignment: the CUDA kernels and their wrappers.

    kmeans_assign_cuda(X, C)        the narrow variant, one launch
    kmeans_assign_tiled_cuda(X, C)  the tiled variant, one call
    kmeans_assign_planned(X, C)     every launch of ``launch_plan``

``csrc/kmeans_assign.cu`` replaces the reference's Pallas
``kmeans_assign_pallas``.  X is (n, d) and C is (kc, d) or a batch of
centroid sets (R, kc, d); the outputs (labels int32, min sqdist) are
(n,) or (R, n).  The narrow variant keeps rows in registers and every
centroid set of the launch in shared memory, so it takes d <= 16,
kc <= 128 and what fits ``SMEM_LIMIT``; the tiled variant stages tiles
of rows and centroids through shared memory and takes any d and kc, all
sets in one launch, fp32 products on FMAs and fp64 products on the
tensor cores (DMMA).  ``launch_plan(R, kc, d, itemsize)`` routes a call:
the narrow variant with the restarts split into groups that fit, or the
tiled variant for d > 16 or kc > 128.  A set's result does not depend
on R or on the grouping: the variant depends on d and kc only, and a
batch of a narrow shape whose centroids do not fit is split, not sent to
the tiled variant (whose fp64 products round differently).  The narrow
variant and the fp32 tiled one give each (row, centroid) pair the
same arithmetic; the fp64 tiled one sums the products four dimensions at
a time.  The wrappers take CUDA tensors only: they check device, dtype,
shape, contiguity and the variant's caps, launch, raise on a CUDA error
and count each call in ``LAUNCHES`` under the variant's name.  A narrow
call is one kernel launch; a tiled call is two, a pass that computes the
centroid norms into a scratch tensor and then the tiled kernel, counted
once.  ``ops.kmeans_assign`` is the public function; it sends
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

_OPERANDS = [I32, PTR, PTR, PTR, PTR, I32, I32, I32, I32, PTR]
LIBRARY = NvccLibrary(
    "kmeans_assign",
    Path(__file__).resolve().parent / "csrc" / "kmeans_assign.cu",
    {"kmeans_assign_launch": (I32, [I32] + _OPERANDS),
     "kmeans_assign_tiled_launch": (I32, [I32] + _OPERANDS + [PTR])})

# calls per variant: incremented where its kernel is launched and nowhere
# else (a tiled call launches the norms pass and the tiled kernel)
LAUNCHES = {"kmeans_assign": 0, "kmeans_assign_tiled": 0}

MAX_CENTROIDS = 128          # the narrow variant's cap (the reference's)
MAX_DIM = 16                 # the widest row it keeps in registers
SMEM_LIMIT = 232448          # shared memory one thread block may use


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


def narrow_width(d: int) -> int:
    """The row width (MAXD) of the narrow instance that takes d: 4 or
    16; centroids are stored in shared memory at that stride."""
    return 4 if d <= 4 else MAX_DIM


def narrow_smem(R: int, kc: int, d: int, itemsize: int) -> int:
    """Shared memory of one narrow launch over R centroid sets: the
    centroids at the instance's stride and their norms."""
    return itemsize * R * kc * (narrow_width(d) + 1)


def launch_plan(R: int, kc: int, d: int, itemsize: int
                ) -> List[Tuple[str, int, int]]:
    """The launches of one assignment over R centroid sets of kc
    centroids of width d: [(variant, r0, r1)], each over sets
    [r0, r1).  The narrow variant where d <= 16 and kc <= 128, with the
    sets split into the fewest groups whose centroids fit
    ``SMEM_LIMIT``; else one launch of the tiled variant over every set
    (its shared memory does not depend on the shapes)."""
    if d > MAX_DIM or kc > MAX_CENTROIDS:
        return [("tiled", 0, R)]
    per = SMEM_LIMIT // narrow_smem(1, kc, d, itemsize)
    return [("narrow", r0, min(R, r0 + per)) for r0 in range(0, R, per)]


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
    if n >= 2 ** 31 or R * kc >= 2 ** 31:
        raise ValueError("the kernels index rows and centroids with int32")
    return C3, n, d, kc, R


def _launch(variant: str, X, C3, labels, dist) -> None:
    """One call of ``variant`` ("narrow" or "tiled") over the sets of C3
    into the (R, n) outputs."""
    lib = LIBRARY.load()
    n, d = X.shape
    R, kc = C3.shape[0], C3.shape[1]
    dev = X.device.index if X.device.index is not None \
        else torch.cuda.current_device()
    operands = (dev, X.data_ptr(), C3.data_ptr(), labels.data_ptr(),
                dist.data_ptr(), n, d, kc, R,
                torch.cuda.current_stream(X.device).cuda_stream)
    f64 = int(X.dtype == torch.float64)
    if variant == "narrow":
        name = "kmeans_assign"
        code = lib.kmeans_assign_launch(f64, *operands)
    else:
        name = "kmeans_assign_tiled"
        norms = torch.empty(R * kc, dtype=X.dtype, device=X.device)
        code = lib.kmeans_assign_tiled_launch(f64, *operands,
                                              norms.data_ptr())
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
    _launch("narrow", X, C3, labels, dist)
    return _shaped(C, labels, dist)


def kmeans_assign_tiled_cuda(X: torch.Tensor, C: torch.Tensor
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One call of the tiled variant over every centroid set of C (any d
    and kc): fp32 products on FMAs, fp64 on the tensor cores (DMMA)."""
    C3, n, d, kc, R = _operands(X, C, "kmeans_assign_tiled")
    labels, dist = _outputs(X, R, n)
    _launch("tiled", X, C3, labels, dist)
    return _shaped(C, labels, dist)


def kmeans_assign_planned(X: torch.Tensor, C: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every launch of ``launch_plan`` for this call, each into its sets'
    rows of the outputs."""
    C3, n, d, kc, R = _operands(X, C, "kmeans_assign")
    labels, dist = _outputs(X, R, n)
    for variant, r0, r1 in launch_plan(R, kc, d, X.element_size()):
        _launch(variant, X, C3[r0:r1], labels[r0:r1], dist[r0:r1])
    return _shaped(C, labels, dist)
