"""Unified GraphBLAS execution API: descriptor-driven backend dispatch.

Port of ``repro.grblas.api``::

    mxm(A, X, ring, *, mask=None, accum=None, desc=None)   # (n,k) or (n,)
    mxv(A, x, ring, ...)                                   # alias of mxm
    vxm(x, A, ring, ...)                                   # transposed mxm

``Descriptor.backend`` is "auto" or a registered backend ("sellcs",
"ell", "bsr_pallas", "edge_pallas", "coo", "spgemm"; ``backends.py``);
a named backend that cannot execute the operands raises
BackendUnavailableError instead of silently falling back.  A
PairEdgeSemiring takes X=(U, Eta); a SparseMatrix X makes the product
sparse x sparse (spgemm, returning a SparseMatrix).

Write semantics (GraphBLAS C<M> (.)= T, as pure outputs): ``accum=(op, C)``
returns op(C, T); ``mask`` (row mask or full shape) keeps masked-in
entries and writes the ring's add-identity — or, with accum, C's old
value — elsewhere.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.grblas import backends as _backends
from repro_torch.grblas.semiring import reals_ring

BackendUnavailableError = _backends.BackendUnavailableError


@dataclasses.dataclass(frozen=True)
class Descriptor:
    """How to execute one GraphBLAS operation (not what it computes)."""

    backend: str = "auto"
    transpose: bool = False

    def transposed(self) -> "Descriptor":
        return dataclasses.replace(self, transpose=not self.transpose)


DEFAULT_DESCRIPTOR = Descriptor()


def mxm(A, X, ring=reals_ring, *, mask=None, accum=None,
        desc: Optional[Descriptor] = None):
    """Sparse x dense multivector (SpMM) under ``ring``.  X: (n,) or
    (n, k), a pair (U, Eta) for a PairEdgeSemiring, or a SparseMatrix."""
    desc = DEFAULT_DESCRIPTOR if desc is None else desc
    be = _backends.select_backend(A, X, ring, desc)
    return _finalize(be.execute(A, X, ring, desc), ring, mask, accum)


def mxv(A, x, ring=reals_ring, *, mask=None, accum=None,
        desc: Optional[Descriptor] = None) -> torch.Tensor:
    """y = A (*) x under ring — grb::mxv."""
    return mxm(A, x, ring, mask=mask, accum=accum, desc=desc)


def vxm(x, A, ring=reals_ring, *, mask=None, accum=None,
        desc: Optional[Descriptor] = None) -> torch.Tensor:
    """y = x (*) A under ring — grb::vxm = mxm on A^T."""
    desc = DEFAULT_DESCRIPTOR if desc is None else desc
    return mxm(A, x, ring, mask=mask, accum=accum, desc=desc.transposed())


def available_backends(A, X, ring=reals_ring,
                       desc: Optional[Descriptor] = None) -> list:
    """Which backends could run this op (auto order)."""
    return _backends.available_backends(
        A, X, ring, DEFAULT_DESCRIPTOR if desc is None else desc)


def capable_desc(A, ring=reals_ring, desc: Optional[Descriptor] = None, *,
                 k: int = 1, dtype=torch.float32) -> Optional[Descriptor]:
    """``desc`` if its backend can run an (n, k) multivector under
    ``ring`` on A; None (= auto) otherwise.  Shape-only probe: the
    multivector is a meta tensor."""
    if desc is None:
        return None
    probe = torch.empty((A.n_rows, k), dtype=dtype, device="meta")
    if _backends.can_execute(A, probe, ring, desc):
        return desc
    return None


def _finalize(Y, ring, mask, accum):
    base = getattr(ring, "base", ring)  # edge rings reduce under base
    if mask is not None:
        mask = torch.as_tensor(mask, device=Y.device)
        while mask.ndim < Y.ndim:      # row mask against a multivector
            mask = mask[..., None]
    if accum is not None:
        op, C = accum
        T = op(C, Y)
        return torch.where(mask, T, C) if mask is not None else T
    if mask is not None:
        return torch.where(mask, Y, torch.tensor(base.zero, dtype=Y.dtype,
                                                 device=Y.device))
    return Y
