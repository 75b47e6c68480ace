"""Flash attention, forward: the CUDA kernel and its wrapper.

    flash_attention_cuda(q, k, v, causal, window)   (B, Hq, Sq, D) on the card

``csrc/flash_attention.cu`` replaces the reference's Pallas
``flash_attention_pallas``: causal or sliding-window GQA attention with
an online softmax, fully masked K tiles skipped, q head h reading kv
head h // (Hq / Hkv).  q is (B, Hq, Sq, D) and k, v are (B, Hkv, Sk, D),
all bfloat16 (tensor cores) or all float32 (CUDA cores), with D at most
256 (a multiple of 8 in bfloat16).  Unlike the TPU kernel it masks a
ragged sequence itself, so any Sq and Sk are right.

The wrapper takes CUDA tensors only: it checks device, dtype, shape,
contiguity and alignment, launches, raises on a CUDA error and counts
the launch in ``LAUNCHES``.  ``ops.flash_attention`` is the public,
differentiable function; it sends CPU tensors to the plain version in
``ref.py``.  The library is built with nvcc at first use
(``build``/``start_build``) into ``build/torch_ext/``; importing this
module builds nothing.
"""
from __future__ import annotations

import ctypes
import time
from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels.nvcc import I32, PTR, NvccLibrary, check

F32 = ctypes.c_float

LIBRARY = NvccLibrary(
    "flash_attention",
    Path(__file__).resolve().parent / "csrc" / "flash_attention.cu",
    {"flash_attention_launch": (I32, [I32, I32, PTR, PTR, PTR, PTR, I32, I32,
                                      I32, I32, I32, I32, I32, I32, F32,
                                      PTR])})

# kernel launches: incremented where the kernel is launched and nowhere
# else
LAUNCHES = {"flash_attention": 0}

MAX_HEAD_DIM = 256
MAX_GRID_Y = 65535           # B * Hq blocks along the grid's y axis


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


def check_operands(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   window: Optional[int]) -> None:
    """Raise on operands that neither the kernel nor the plain version
    takes."""
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("q, k and v must be (B, H, S, D)")
    B, Hq, _, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}: expected k and v "
                         f"(B, Hkv, Sk, D) with q's B and D")
    Hkv = k.shape[1]
    if Hkv < 1 or Hq % Hkv != 0:
        raise ValueError(f"{Hq} q heads do not group over {Hkv} kv heads")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"dtypes q {q.dtype}, k {k.dtype}, v {v.dtype} "
                        "differ")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v lie on different devices")
    if window is not None and window < 1:
        raise ValueError(f"window={window}: expected a positive int or None")


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True,
                         window: Optional[int] = None) -> torch.Tensor:
    """One launch of the kernel: (B, Hq, Sq, D) in q's dtype."""
    check_operands(q, k, v, window)
    if q.device.type != "cuda":
        raise ValueError(f"the flash_attention kernel takes CUDA tensors, "
                         f"not {q.device}")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"dtype {q.dtype}: the kernel takes bfloat16 or "
                        "float32")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k and v must be contiguous")
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    bf16 = q.dtype == torch.bfloat16
    if not 1 <= D <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {D}: the kernel takes 1 to "
                         f"{MAX_HEAD_DIM}")
    if bf16 and (D % 8 or any(t.data_ptr() % 16 for t in (q, k, v))):
        raise ValueError(f"head dim {D}: the bfloat16 kernel loads rows in "
                         "16-byte chunks (D % 8 == 0, aligned operands)")
    if B * Hq > MAX_GRID_Y:
        raise ValueError(f"B * Hq = {B * Hq} exceeds the grid's "
                         f"{MAX_GRID_Y} blocks")
    if max(Sq, Sk) >= 2 ** 31:
        raise ValueError("the kernel indexes positions with int32")
    o = torch.empty_like(q)
    if B * Hq * Sq == 0:
        return o
    lib = LIBRARY.load()
    dev = q.device.index if q.device.index is not None \
        else torch.cuda.current_device()
    code = lib.flash_attention_launch(
        int(bf16), dev, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        o.data_ptr(), B, Hq, Hkv, Sq, Sk, D, int(causal),
        0 if window is None else min(int(window), 2 ** 31 - 1),
        1.0 / (D ** 0.5), torch.cuda.current_stream(q.device).cuda_stream)
    check(lib, code, "flash_attention")
    LAUNCHES["flash_attention"] += 1
    return o
