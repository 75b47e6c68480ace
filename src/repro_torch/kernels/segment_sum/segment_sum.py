"""Fixed-order segmented sum: a CUDA kernel for float GPU tensors, the
sequential ``index_add_`` for CPU tensors.

    segment_sum(values, ids, n, ptr=None)
        out[s] = sum of values[e] over the entries e with ids[e] == s,
                 added in entry order

The COO backend's reals-ring reduction (registered in
``grblas/semiring.py``) and ``SparseMatrix.row_sums`` run through it.
On the card, a float ``index_add_`` adds with atomics in an order that
varies from run to run; ``csrc/segment_sum.cu`` gives each output to one
thread, which adds its segment's entries in entry order, so the sum is
the same bit for bit on every run (and equal to the CPU's ``index_add_``,
which adds sequentially in entry order too).  It is a helper of the
port, not the port of a TPU kernel.

For CUDA tensors the wrapper groups the entries by segment and launches
the kernel once, counted in ``LAUNCHES``, or raises.  The caller whose
ids are already grouped passes their CSR pointers (``ptr``: a
SparseMatrix's ``row_ptr`` where the segments are its rows); otherwise
``segment_pointers`` sorts the ids stably and takes the segment offsets
by ``searchsorted``.  Integer and boolean sums stay on ``index_add_``
(exact in any order).  For CPU tensors it runs the plain version,
``segment_sum_plain``.  The library is built with nvcc at first use
into ``build/torch_ext/``; importing this module builds nothing.
"""
from __future__ import annotations

import math
import time
from pathlib import Path
from typing import Optional, Tuple

import torch

from repro_torch.kernels.nvcc import I32, I64, PTR, NvccLibrary, check

LIBRARY = NvccLibrary(
    "segment_sum", Path(__file__).resolve().parent / "csrc" / "segment_sum.cu",
    {"segment_sum_launch": (I32, [I32, I32, PTR, PTR, PTR, PTR, I64, I64,
                                  PTR])})

# kernel launches: incremented where the kernel is launched and nowhere
# else
LAUNCHES = {"segment_sum": 0}


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


def segment_sum_plain(values: torch.Tensor, ids: torch.Tensor,
                      num_segments: int) -> torch.Tensor:
    """The plain version: ``index_add_``, sequential in entry order on the
    CPU."""
    out = torch.zeros((num_segments,) + tuple(values.shape[1:]),
                      dtype=values.dtype, device=values.device)
    return out.index_add_(0, ids.long(), values)


def csr_pointers(ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """CSR pointers of non-decreasing ``ids``: segment s holds the entries
    [ptr[s], ptr[s+1]).  int64, on the ids' device; no host sync."""
    return torch.searchsorted(ids.long(), torch.arange(num_segments + 1,
                                                       device=ids.device))


def segment_pointers(ids: torch.Tensor, num_segments: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ptr, order) for ids in any order: the entries of segment s are
    ``order[ptr[s]:ptr[s+1]]``, in their original order (a stable sort)."""
    srt, order = torch.sort(ids.long(), stable=True)
    return csr_pointers(srt, num_segments), order


def segment_sum(values: torch.Tensor, ids: torch.Tensor, num_segments: int,
                ptr: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sum ``values`` (entries, ...) per segment in entry order.  ``ptr``:
    the (num_segments + 1,) int64 CSR pointers of ``ids`` where the
    entries are grouped by segment already (``SparseMatrix.row_ptr``);
    without it they are grouped by a stable sort of the ids."""
    if values.shape[0] != ids.shape[0] or ids.ndim != 1:
        raise ValueError(f"values {tuple(values.shape)} against ids "
                         f"{tuple(ids.shape)}: one id per entry")
    if ids.device != values.device:
        raise ValueError(f"ids on {ids.device}, values on {values.device}")
    if ptr is not None and (ptr.shape != (num_segments + 1,)
                            or ptr.dtype != torch.int64
                            or ptr.device != values.device):
        raise ValueError(f"ptr {tuple(ptr.shape)} {ptr.dtype} on "
                         f"{ptr.device}: expected ({num_segments + 1},) "
                         f"int64 on {values.device}")
    if values.device.type == "cpu" or not values.dtype.is_floating_point:
        return segment_sum_plain(values, ids, num_segments)
    if values.device.type != "cuda":
        raise ValueError(f"no segment_sum kernel for device {values.device}")
    if values.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"values dtype {values.dtype}: the kernel takes "
                        "float32 or float64")
    order = None
    if ptr is None:
        ptr, order = segment_pointers(ids, num_segments)
    values = values.contiguous()
    m = math.prod(values.shape[1:])
    out = torch.empty((num_segments,) + tuple(values.shape[1:]),
                      dtype=values.dtype, device=values.device)
    lib = LIBRARY.load()
    dev = values.device.index if values.device.index is not None \
        else torch.cuda.current_device()
    code = lib.segment_sum_launch(
        int(values.dtype == torch.float64), dev, values.data_ptr(),
        ptr.data_ptr(), None if order is None else order.data_ptr(),
        out.data_ptr(), num_segments, m,
        torch.cuda.current_stream(values.device).cuda_stream)
    check(lib, code, "segment_sum")
    LAUNCHES["segment_sum"] += 1
    return out
