"""The port's ``repro.launch.hlo_parse``: counts of a rank's op stream.

The reference compiles each dry-run cell through XLA and parses the
partitioned HLO: dot FLOPs (2 * prod(out) * contracted), dot bytes
(lhs + rhs + out, its first-order model: every large matmul
round-trips HBM and the elementwise ops ride fused into them), while
bodies multiplied by their trip counts, and ``memory_analysis()`` for
the temporaries.  Torch eager has no HLO, no fusion and no while loop,
so the port counts what it really launches.  ``OpCounter`` is a
``TorchDispatchMode``: every aten op of the block passes through it,
on the meta device (the dry run) as on the card or the CPU, and it
keeps

  * dot FLOPs and dot bytes of ``mm``, ``addmm``, ``bmm``, ``baddbmm``,
    ``mv``, ``addmv`` and ``dot`` (every matmul the port's paths reach:
    ``@``, ``einsum`` and ``linear`` decompose into them before the
    dispatch), by the reference's formulas, an operand's bytes those of
    its distinct elements (a weight ``@`` broadcasts over a batch is read
    once);
  * the flash attention op apart from the dots: its FLOPs 2 * (D + Dv)
    a visible (query, key) pair and its bytes q + k + v + out, reported
    by ``kernels.flash_attention.ops`` on every route (``flash_op``);
    the matmuls of its plain version (the CPU route) are not counted
    as dots, and on the card the kernel launches no aten op;
  * the peak of the storages allocated on the counted device during the
    block and still alive, above what was alive before it (the
    arguments): the counterpart of ``memory_analysis().temp_size``.
    A storage counts from the op that makes it to its release.

Scope, where this differs from the reference's compiled count:

  * there is no fusion, so the port's layer-by-layer stream is what it
    counts: the reference's XLA may fuse, rematerialize or drop ops its
    HLO no longer shows, and the port counts every op it launches;
  * attention: the reference's compiled HLO (its ``use_pallas=False``
    path) holds the attention as dots over every (query, key) pair, the
    masked ones included; the port counts its flash op on the visible
    pairs only, and its score bytes never reach memory;
  * there are no loops to multiply: each layer's ops are launched, and
    counted, once a layer;
  * a train step: the flash op's backward is its plain version's (the
    reference has no backward kernel), recomputed QK^T and PV and their
    four gradients, which with the flash forward apart are the
    reference's six attention dots a layer; and each loss chunk's
    logits are recomputed in the backward (``chunked_xent``'s
    checkpoint), as the reference's ``jax.checkpoint`` asks.  So the
    dot FLOPs of a step equal the reference's compiled count wherever
    the loss has two chunks or more (train_4k has eight); at one chunk
    its compiler folds the recomputed logits into the forward's and
    counts one (B, S, V) product fewer, a difference of 2 B S V D;
  * the peak counts storages as the allocator is asked for them, not as
    the card's caching allocator rounds and caches them, and not the
    workspaces a library allocates inside one op (cuBLAS, a sort).
"""
from __future__ import annotations

import contextlib
import functools
import weakref
from typing import Dict, Optional

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

aten = torch.ops.aten

_ACTIVE: list = []          # the OpCounters entered, innermost last


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


@functools.lru_cache(maxsize=256)
def visible_pairs(Sq: int, Sk: int, causal: bool,
                  window: Optional[int]) -> int:
    """(query, key) pairs the masks leave: key j < Sk, j <= i where
    causal, j > i - window where a window is given (query i < Sq)."""
    i = np.arange(Sq, dtype=np.int64)
    hi = np.minimum(i + 1, Sk) if causal else np.full(Sq, Sk)
    lo = np.maximum(i - window + 1, 0) if window else np.zeros(Sq, np.int64)
    return int(np.sum(np.maximum(hi - lo, 0)))


def flash_counts(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 causal: bool, window: Optional[int]) -> tuple:
    """(FLOPs, bytes) of one flash attention call: 2 (D + Dv) a visible
    (query, key) pair of each of the B Hq heads, and q + k + v + out
    read or written once."""
    B, Hq, Sq, D = q.shape
    Sk, Dv = k.shape[2], v.shape[3]
    flops = 2 * B * Hq * (D + Dv) * visible_pairs(Sq, Sk, causal, window)
    out = B * Hq * Sq * Dv * q.element_size()
    return flops, _nbytes(q) + _nbytes(k) + _nbytes(v) + out


def _distinct_bytes(t: torch.Tensor) -> int:
    """The bytes of ``t``'s distinct elements: an operand broadcast along
    a dim (stride 0, as ``@`` expands a 2-D weight against a batch) is
    read once, as the reference's HLO dot reads it unbroadcast."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride:
            n *= size
    return n * t.element_size()


def _dot(func, args, out) -> Optional[tuple]:
    """(FLOPs, lhs + rhs + out bytes) of a matmul op, else None."""
    if func in (aten.mm.default, aten.bmm.default, aten.mv.default,
                aten.dot.default):
        lhs, rhs = args[0], args[1]
    elif func in (aten.addmm.default, aten.baddbmm.default,
                  aten.addmv.default):
        lhs, rhs = args[1], args[2]
    else:
        return None
    K = lhs.shape[-1]
    return (2 * out.numel() * K,
            _distinct_bytes(lhs) + _distinct_bytes(rhs) + _nbytes(out))


class OpCounter(TorchDispatchMode):
    """Counts of the block's op stream (see the module docstring):
    ``dot_flops``, ``dot_bytes``, ``flash_flops``, ``flash_bytes``,
    ``flash_calls``, ``dots`` (calls by op) and ``peak_bytes`` (the
    storages allocated on ``device``'s type during the block, at their
    most; ``live_bytes`` those still alive)."""

    def __init__(self, device="meta"):
        super().__init__()
        self.device_type = torch.device(device).type
        self.dot_flops = 0
        self.dot_bytes = 0
        self.flash_flops = 0
        self.flash_bytes = 0
        self.flash_calls = 0
        self.dots: Dict[str, int] = {}
        self.live_bytes = 0
        self.peak_bytes = 0
        self._in_flash = 0
        self._seen: Dict[int, int] = {}

    def __enter__(self):
        _ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _ACTIVE.remove(self)
        return super().__exit__(*exc)

    def _track(self, t: torch.Tensor, inputs: set) -> None:
        if t.device.type != self.device_type:
            return
        st = t.untyped_storage()
        key = st._cdata
        if key in inputs or key in self._seen:
            return
        n = st.nbytes()
        self._seen[key] = n
        self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        weakref.finalize(st, self._release, key)

    def _release(self, key: int) -> None:
        self.live_bytes -= self._seen.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        inputs = {a.untyped_storage()._cdata
                  for a in torch.utils._pytree.tree_leaves((args, kwargs))
                  if isinstance(a, torch.Tensor)}
        for t in torch.utils._pytree.tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self._track(t, inputs)
        if not self._in_flash:
            counted = _dot(func, args, out)
            if counted is not None:
                self.dot_flops += counted[0]
                self.dot_bytes += counted[1]
                name = func.overloadpacket.__name__
                self.dots[name] = self.dots.get(name, 0) + 1
        return out

    def counts(self) -> dict:
        return {"dot_flops": self.dot_flops, "dot_bytes": self.dot_bytes,
                "flash_flops": self.flash_flops,
                "flash_bytes": self.flash_bytes,
                "flash_calls": self.flash_calls, "dots": dict(self.dots),
                "peak_bytes": self.peak_bytes}


@contextlib.contextmanager
def flash_op(q, k, v, causal: bool, window: Optional[int]):
    """Report one flash attention call to the innermost ``OpCounter``
    and keep the ops inside the block (the plain version's matmuls on
    the CPU route) out of its dots; a no-op when none is active."""
    counter = _ACTIVE[-1] if _ACTIVE else None
    if counter is None:
        yield
        return
    flops, nbytes = flash_counts(q, k, v, causal, window)
    counter.flash_flops += flops
    counter.flash_bytes += nbytes
    counter.flash_calls += 1
    counter._in_flash += 1
    try:
        yield
    finally:
        counter._in_flash -= 1
