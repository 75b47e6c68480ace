"""Unified GraphBLAS execution API: descriptor-driven backend dispatch.

Port of ``repro.grblas.api``::

    mxm(A, X, ring, *, mask=None, accum=None, desc=None)   # (n,k) or (n,)
    mxv(A, x, ring, ...)                                   # alias of mxm
    vxm(x, A, ring, ...)                                   # transposed mxm

``Descriptor.backend`` is "auto" or a registered backend ("dist",
"dist_sellcs", "sellcs", "ell", "bsr_pallas", "edge_pallas", "coo",
"spgemm"; ``backends.py``); ``Descriptor.mesh`` (a ``grblas.dist``
mesh) enables the dist backends, which then outrank every other;
a named backend that cannot execute the operands raises
BackendUnavailableError instead of silently falling back.  A
PairEdgeSemiring takes X=(U, Eta); a SparseMatrix X makes the product
sparse x sparse (spgemm, returning a SparseMatrix).

Write semantics (GraphBLAS C<M> (.)= T, as pure outputs): ``accum=(op, C)``
returns op(C, T); ``mask`` (row mask or full shape) keeps masked-in
entries and writes the ring's add-identity — or, with accum, C's old
value — elsewhere.

Telemetry (``repro_torch.obs``): with a tracer active, every dense
product is a fenced ``grblas.mxm`` span carrying the backend, ring kind,
shape, nnz and the minimum-traffic byte model (``roofline_summary``
reads it), and bumps ``grblas_dispatch_total`` / ``grblas_nnz_total``;
a sparse product is a ``grblas.spgemm`` span.  With tracing off (the
default) ``mxm`` pays one attribute lookup and nothing else.  A pinned
descriptor that ``capable_desc`` degrades to auto bumps
``grblas_fallback_total`` and stamps a ``grblas.fallback`` instant.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch.grblas import backends as _backends
from repro_torch.grblas.containers import SparseMatrix
from repro_torch.grblas.semiring import reals_ring
from repro_torch.obs import metrics as _obs_metrics
from repro_torch.obs import trace as _obs_trace

BackendUnavailableError = _backends.BackendUnavailableError


@dataclasses.dataclass(frozen=True)
class Descriptor:
    """How to execute one GraphBLAS operation (not what it computes)."""

    backend: str = "auto"
    transpose: bool = False
    mesh: Any = None            # grblas.dist.Mesh: enables the dist backends
    axis: str = "data"          # mesh axis the rows are sharded over

    def transposed(self) -> "Descriptor":
        return dataclasses.replace(self, transpose=not self.transpose)


DEFAULT_DESCRIPTOR = Descriptor()


def mxm(A, X, ring=reals_ring, *, mask=None, accum=None,
        desc: Optional[Descriptor] = None):
    """Sparse x dense multivector (SpMM) under ``ring``.  X: (n,) or
    (n, k), a pair (U, Eta) for a PairEdgeSemiring, or a SparseMatrix."""
    desc = DEFAULT_DESCRIPTOR if desc is None else desc
    if isinstance(X, SparseMatrix):             # sparse product (spgemm)
        if mask is not None or accum is not None:
            raise NotImplementedError(
                "mask/accum write semantics are defined for dense outputs; "
                "the sparse-sparse product returns a SparseMatrix")
        be = _backends.select_backend(A, X, ring, desc)
        tr = _obs_trace.ACTIVE
        if not tr.enabled:
            return be.execute(A, X, ring, desc)
        with tr.span("grblas.spgemm", cat="grblas", backend=be.name,
                     n=A.n_rows, nnz_a=int(A.nnz), nnz_b=int(X.nnz)):
            return be.execute(A, X, ring, desc)
    be = _backends.select_backend(A, X, ring, desc)
    tr = _obs_trace.ACTIVE
    if not tr.enabled:
        Y = be.execute(A, X, ring, desc)
    else:
        Y = _execute_observed(be, A, X, ring, desc, tr)
    return _finalize(Y, ring, mask, accum)


def _ring_kind(ring) -> str:
    return (getattr(ring, "kind", None) or getattr(ring, "name", None)
            or type(ring).__name__)


def _x_width(X) -> int:
    if isinstance(X, (tuple, list)):
        X = X[0]
    shp = getattr(X, "shape", ())
    return int(shp[1]) if len(shp) > 1 else 1


def _traffic_bytes(A, k: int, itemsize: int = 4) -> int:
    """Minimum-traffic SpMM byte model: stream A once (value and column
    index per nnz), stream the multivector in and the product out once.
    Real gathers re-read X rows, so achieved GB/s against this model is
    a lower bound."""
    nnz = int(getattr(A, "nnz", 0))
    n_rows = int(getattr(A, "n_rows", 0))
    n_cols = int(getattr(A, "n_cols", n_rows))
    return nnz * (itemsize + 4) + (n_rows + n_cols) * k * itemsize


def _execute_observed(be, A, X, ring, desc, tr):
    """Dispatch accounting when tracing is on: a fenced span carrying
    shapes, nnz and the byte model (-> achieved GB/s via
    ``obs.trace.roofline_summary``), and the dispatch counters."""
    kind = _ring_kind(ring)
    k = _x_width(X)
    nnz = int(getattr(A, "nnz", 0))
    with tr.span("grblas.mxm", cat="grblas", backend=be.name, ring=kind,
                 n=int(getattr(A, "n_rows", 0)), k=k, nnz=nnz) as sp:
        Y = be.execute(A, X, ring, desc)
        sp.fence(Y)
        sp.set(bytes=_traffic_bytes(A, k, Y.element_size()))
    _obs_metrics.DEFAULT.counter("grblas_dispatch_total", backend=be.name,
                                 ring=kind).inc()
    _obs_metrics.DEFAULT.counter("grblas_nnz_total", backend=be.name).inc(nnz)
    return Y


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
    if desc.backend != "auto":
        # a pinned backend degrading to auto is a fallback event: count it
        # so a hot loop losing its kernel path is visible
        _obs_metrics.DEFAULT.counter("grblas_fallback_total",
                                     backend=desc.backend,
                                     ring=_ring_kind(ring)).inc()
        _obs_trace.ACTIVE.instant("grblas.fallback", backend=desc.backend,
                                  ring=_ring_kind(ring))
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
