"""Flash attention, forward: the CUDA kernels and their wrapper.

    flash_attention_cuda(q, k, v, causal, window)   (B, Hq, Sq, Dv) on the card

Causal or sliding-window GQA attention with an online softmax, fully
masked K tiles skipped, q head h reading kv head h // (Hq / Hkv); the
kernels replace the reference's Pallas ``flash_attention_pallas``.  q is
(B, Hq, Sq, D), k is (B, Hkv, Sk, D) and v (B, Hkv, Sk, Dv), all
bfloat16 or all float32, with D at most 256 (a multiple of 8 in
bfloat16).  Unlike the TPU kernel they mask a ragged sequence
themselves, so any Sq and Sk are right.  Three kernels, routed by dtype
and shape (``kernel_variant``), never on failure:

  wgmma  bfloat16, D in {64, 128, 192, 256}: ``csrc/flash_attention_wgmma.cu``
         (TMA loads into an mbarrier ring, wgmma products, one producer
         and two consumer warpgroups sharing each K/V tile: two q heads
         of a GQA group, or at group 1 two adjacent 64-row query tiles
         of one head; ``wgmma_blocks``).  It takes v of width Dv as is
         at the compiled (D, Dv) of ``WGMMA_SHAPES``: (D, D) for each D,
         and MLA's (192, 128)
  mma    bfloat16, any other D: ``csrc/flash_attention.cu``, mma.sync
  f32    float32: ``csrc/flash_attention.cu``, CUDA cores

The mma and f32 kernels, and wgmma at a (D, Dv) not compiled, take v of
k's shape (``ops.flash_attention`` pads a narrower v to D:
``takes_value_dim``).  The wrapper takes CUDA tensors only: it checks
device, dtype, shape, contiguity and alignment, launches, raises on a
CUDA error and counts the launch in
``LAUNCHES["flash_attention_<variant>"]``.  ``ops.flash_attention`` is
the public, differentiable function; it sends CPU tensors to the plain
version in ``ref.py``.  The two libraries are built with nvcc at first
use (``build``/``start_build``) into ``build/torch_ext/``; importing
this module builds nothing.
"""
from __future__ import annotations

import ctypes
import time
from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels.nvcc import I32, PTR, NvccLibrary, check

F32 = ctypes.c_float

CSRC = Path(__file__).resolve().parent / "csrc"
LIBRARY = NvccLibrary(
    "flash_attention", CSRC / "flash_attention.cu",
    {"flash_attention_launch": (I32, [I32, I32, PTR, PTR, PTR, PTR, I32, I32,
                                      I32, I32, I32, I32, I32, I32, F32,
                                      PTR])})
WGMMA_LIBRARY = NvccLibrary(
    "flash_attention_wgmma", CSRC / "flash_attention_wgmma.cu",
    {"flash_attention_wgmma_launch": (I32, [I32, PTR, PTR, PTR, PTR, I32, I32,
                                            I32, I32, I32, I32, I32, I32, I32,
                                            F32, PTR])})

# kernel launches, one count per kernel: incremented where the kernel is
# launched and nowhere else
LAUNCHES = {"flash_attention_wgmma": 0, "flash_attention_mma": 0,
            "flash_attention_f32": 0}

MAX_HEAD_DIM = 256
MAX_GRID = 65535             # blocks along a grid's y axis
# the (q/k head dim, value head dim) pairs the wgmma kernel is compiled
# for; it serves every D among them, on v padded to D where (D, Dv) is
# not compiled
WGMMA_SHAPES = ((64, 64), (128, 128), (192, 192), (192, 128), (256, 256))
WGMMA_HEAD_DIMS = tuple(sorted({d for d, _ in WGMMA_SHAPES}))
ROWS = 64                    # query rows per warpgroup (and keys per tile)


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def start_build() -> None:
    """Start nvcc on both libraries in the background (returns at
    once)."""
    LIBRARY.start()
    WGMMA_LIBRARY.start()


def build() -> float:
    """Build (or open the cached builds of) both libraries; seconds
    taken."""
    t0 = time.perf_counter()
    LIBRARY.load()
    WGMMA_LIBRARY.load()
    return time.perf_counter() - t0


def kernel_variant(dtype: torch.dtype, D: int, Sk: int = 1) -> str:
    """The kernel that serves (dtype, q/k head dim, key length): "wgmma"
    for bfloat16 at D in {64, 128, 192, 256} with at least one key, "mma"
    for any other bfloat16 shape, "f32" for float32."""
    if dtype == torch.float32:
        return "f32"
    if dtype != torch.bfloat16:
        raise TypeError(f"dtype {dtype}: the kernels take bfloat16 or "
                        "float32")
    return "wgmma" if D in WGMMA_HEAD_DIMS and Sk >= 1 else "mma"


def takes_value_dim(dtype: torch.dtype, D: int, Dv: int, Sk: int = 1) -> bool:
    """Whether the kernel that serves (dtype, D, Sk) takes v of width Dv
    as is: any Dv = D, and the wgmma kernel's compiled (D, Dv).  Else the
    op pads v to D."""
    return Dv == D or (kernel_variant(dtype, D, Sk) == "wgmma"
                       and (D, Dv) in WGMMA_SHAPES)


def head_pairs(Hq: int, Hkv: int) -> list:
    """The q heads of each wgmma block, in blockIdx.x order within a
    batch, at a GQA group of 2 or more: (kv head, first q head, second q
    head or None).  Two q heads of one kv head share a block; an odd
    group leaves the second warpgroup of each kv head's last pair idle
    (None).  At group 1 each block has one head (second slot None) whose
    two adjacent query tiles fill both warpgroups (``wgmma_blocks``)."""
    group = Hq // Hkv
    out = []
    for kvh in range(Hkv):
        for pair in range((group + 1) // 2):
            h0 = kvh * group + 2 * pair
            out.append((kvh, h0, h0 + 1 if 2 * pair + 1 < group else None))
    return out


def wgmma_grid(B: int, Hq: int, Hkv: int, Sq: int) -> tuple:
    """(x, y) blocks of a wgmma launch: x over (batch, kv head, pair of q
    heads) at group >= 2 and over (batch, head) at group 1, y over query
    tiles of 64 rows (group >= 2: one tile of two heads) or 128 (group 1:
    two tiles of one head)."""
    rows = 2 * ROWS if Hq == Hkv else ROWS
    return B * len(head_pairs(Hq, Hkv)), -(-Sq // rows)


def wgmma_blocks(Hq: int, Hkv: int, Sq: int) -> list:
    """The work of each wgmma block of one batch, in (blockIdx.x,
    blockIdx.y) order, as the kernel maps it: (x, y, slot 0, slot 1),
    each slot the (q head, first query row) of one consumer warpgroup's
    64 rows, or None for an idle one.  blockIdx.y counts from the last
    (heaviest) query tile down."""
    x_blocks, y_blocks = wgmma_grid(1, Hq, Hkv, Sq)
    pairs = head_pairs(Hq, Hkv)
    out = []
    for x in range(x_blocks):
        for y in range(y_blocks):
            tile = y_blocks - 1 - y
            if Hq == Hkv:
                q0 = tile * 2 * ROWS
                slots = ((x, q0), (x, q0 + ROWS) if q0 + ROWS < Sq else None)
            else:
                _, h0, h1 = pairs[x]
                slots = ((h0, tile * ROWS),
                         None if h1 is None else (h1, tile * ROWS))
            out.append((x, y) + slots)
    return out


def check_operands(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   window: Optional[int]) -> None:
    """Raise on operands that neither the kernel nor the plain version
    takes."""
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("q, k and v must be (B, H, S, D)")
    B, Hq, _, D = q.shape
    if k.shape[0] != B or k.shape[3] != D or v.shape[:3] != k.shape[:3]:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}: expected k (B, Hkv, Sk, D) "
                         f"with q's B and D and v (B, Hkv, Sk, Dv)")
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
    """One launch of the kernel ``kernel_variant`` picks: (B, Hq, Sq, Dv)
    in q's dtype.  v must have k's shape unless the kernel takes its
    width (``takes_value_dim``; ``ops.flash_attention`` pads a narrower
    value head dim for the others)."""
    check_operands(q, k, v, window)
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"dtype {q.dtype}: the kernels take bfloat16 or "
                        "float32")
    if not takes_value_dim(q.dtype, k.shape[3], v.shape[3], k.shape[2]):
        raise ValueError(f"v {tuple(v.shape)}: this kernel takes v of k's "
                         f"shape {tuple(k.shape)}")
    if q.device.type != "cuda":
        raise ValueError(f"the flash_attention kernels take CUDA tensors, "
                         f"not {q.device}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k and v must be contiguous")
    B, Hq, Sq, D = q.shape
    Hkv, Sk, Dv = k.shape[1], k.shape[2], v.shape[3]
    bf16 = q.dtype == torch.bfloat16
    if not 1 <= D <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {D}: the kernels take 1 to "
                         f"{MAX_HEAD_DIM}")
    if bf16 and (D % 8 or any(t.data_ptr() % 16 for t in (q, k, v))):
        raise ValueError(f"head dim {D}: the bfloat16 kernels load rows in "
                         "16-byte chunks (D % 8 == 0, aligned operands)")
    variant = kernel_variant(q.dtype, D, Sk)
    grid = (wgmma_grid(B, Hq, Hkv, Sq)[1] if variant == "wgmma"
            else B * Hq)
    if grid > MAX_GRID:
        raise ValueError(f"{grid} blocks exceed the grid's y axis of "
                         f"{MAX_GRID}")
    if max(Sq, Sk) >= 2 ** 31:
        raise ValueError("the kernels index positions with int32")
    o = q.new_empty((B, Hq, Sq, Dv))
    if B * Hq * Sq == 0:
        return o
    dev = q.device.index if q.device.index is not None \
        else torch.cuda.current_device()
    win = 0 if window is None else min(int(window), 2 ** 31 - 1)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if variant == "wgmma":
        lib = WGMMA_LIBRARY.load()
        code = lib.flash_attention_wgmma_launch(
            dev, q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B,
            Hq, Hkv, Sq, Sk, D, Dv, int(causal), win, 1.0 / (D ** 0.5),
            stream)
    else:
        lib = LIBRARY.load()
        code = lib.flash_attention_launch(
            int(bf16), dev, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            o.data_ptr(), B, Hq, Hkv, Sq, Sk, D, int(causal), win,
            1.0 / (D ** 0.5), stream)
    check(lib, code, f"flash_attention ({variant})")
    LAUNCHES[f"flash_attention_{variant}"] += 1
    return o
