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
    """grb::reduce — fold a dense container under the ring's add-monoid
    (its registered dense fast path)."""
    fp = fast_paths(ring)
    if fp.dense is None:
        raise NotImplementedError(
            f"ring {ring.name!r} has no dense reducer in the port; generic "
            "monoid folds come with ROADMAP.md queue 1, item 11")
    return fp.dense(a, axis)
