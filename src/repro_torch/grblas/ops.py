"""Algebraic operators: eWiseApply / apply / reduce and the fused
p-Laplacian apply (port of ``repro.grblas.ops``).  The SpMM family
lives in ``grblas.api``."""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.grblas import api
from repro_torch.grblas.containers import SparseMatrix
from repro_torch.grblas.semiring import (Semiring, fast_paths,
                                         plap_edge_semiring, reals_ring)


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


def fused_plap_apply(A: SparseMatrix, U: torch.Tensor, p: float,
                     eps: float = 1e-9, k: int = 1) -> torch.Tensor:
    """(Delta_p U)_i = sum_j w_ij phi_p(u_i - u_j), all k columns fused:
    one ``api.mxm`` under ``plap_edge_semiring(p, eps)``, so on the card
    it launches whichever p-Laplacian apply kernel the backend chosen for
    ``A`` runs.  ``k`` is not read: it exists only to keep the
    reference's signature, whose jit took the column count as static."""
    return api.mxm(A, U, plap_edge_semiring(p, eps))
