"""Algebraic operators: eWiseApply / apply / reduce (port of
``repro.grblas.ops``).  The SpMM family lives in ``grblas.api``."""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.grblas.semiring import Semiring, fast_paths, reals_ring


def e_wise_apply(a: torch.Tensor, b: torch.Tensor, op: Callable) -> torch.Tensor:
    """grb::eWiseApply — elementwise binary op on dense containers."""
    return op(a, b)


def apply(a: torch.Tensor, op: Callable) -> torch.Tensor:
    """grb::apply — elementwise unary op."""
    return op(a)


def reduce(a: torch.Tensor, ring: Semiring = reals_ring, axis=None) -> torch.Tensor:
    """grb::reduce — fold a dense container under the add-monoid.

    Registered rings use their dense fast path; other monoids fold under
    ``ring.add`` from ``ring.zero`` along ``axis`` (all elements when
    None) by pairwise halving: adjacent pairs in order, the odd tail
    padded with ``ring.zero``, so an associative monoid gives the
    reference's sequential fold in log2(n) vectorized steps."""
    fp = fast_paths(ring)
    if fp.dense is not None:
        return fp.dense(a, axis)
    x = a.reshape(-1) if axis is None else torch.movedim(a, axis, 0)
    if x.shape[0] == 0:
        return torch.full(x.shape[1:], ring.zero, dtype=a.dtype,
                          device=a.device)
    while x.shape[0] > 1:
        if x.shape[0] % 2:
            x = torch.cat([x, torch.full((1,) + tuple(x.shape[1:]),
                                         ring.zero, dtype=x.dtype,
                                         device=x.device)])
        x = ring.add(x[0::2], x[1::2])
    return x[0]
