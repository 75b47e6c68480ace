"""Backend registry for the unified GraphBLAS execution API.

Port of ``repro.grblas.backends``.  A ``Backend`` couples a capability
predicate (can it run this container layout, ring kind, multivector
shape and descriptor at all?) with an execute function; ``api.mxm`` runs
the backend the Descriptor names (loud BackendUnavailableError if it
cannot) or, under "auto", the first capable backend in the port's own
order:

  name         layout needed  rings                            auto rank
  sellcs       SELL-C-σ       reals (incl. (nnz,k) multivalues),    0
                              plap_apply, plap_hvp
  ell          padded ELL     rings with a padded reducer          10
  bsr_pallas   BSR tiles*     reals, (n,k) multivector             15
  edge_pallas  BSR tiles*     plap_apply, plap_hvp; square         16
  coo          COO (always)   any ring, transpose, multivalues     20
  spgemm       COO (always)   reals, X a SparseMatrix              25

* CUDA tiles of at most ``MAX_BLOCK`` (128), the kernels' limit
(``bsr_tiles_fit``); above it the two BSR backends decline, so ``auto``
falls through to ``coo`` and a named BSR backend raises
BackendUnavailableError.  CPU tiles, run by the plain versions, have no
limit.

The port's ``auto`` picks ``sellcs`` whenever that layout is built: its
SpMMs run as the hand-written CUDA kernels of ``kernels/sellcs_spmm``.
The two BSR backends (the CUDA kernels of ``kernels/bsr_spmm`` and
``kernels/plap_edge``; the names are the reference's, so one
``PSCConfig`` means the same in both packages) rank after ``sellcs`` and
``ell`` and before ``coo``: every stored tile is dense, and on
``delaunay_graph(20)`` at bs = 128 the tiles are 0.54% full, so a BSR
kernel streams about 53x the bytes of the SELL-C-σ kernel for the same
product.  A graph built with BSR and COO only runs its reals SpMMs on
``bsr_pallas``, as the reference does on the TPU.  (The reference's
TPU order, which puts the Pallas kernels first and defers ``sellcs`` to
ELL on low-fill graphs, is not evidence on this card.)  ``spgemm`` is
the sparse x sparse product, host-side like the reference's; the
``dist`` backends are still to be ported (ROADMAP.md queue 1).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import numpy as np
import torch

from repro_torch.grblas.containers import SparseMatrix
from repro_torch.kernels.bsr_spmm.bsr_spmm import MAX_BLOCK
from repro_torch.kernels.segment_sum import segment_sum
from repro_torch.grblas.semiring import (
    EdgeSemiring,
    PairEdgeSemiring,
    Semiring,
    fast_paths,
)


class BackendUnavailableError(ValueError):
    """The requested backend cannot execute this operand combination."""


@dataclasses.dataclass(frozen=True)
class Backend:
    name: str
    supports: Callable      # (A, X, ring, desc) -> bool
    execute: Callable       # (A, X, ring, desc) -> torch.Tensor
    priority: int           # auto-selection rank (lower wins)


_REGISTRY: Dict[str, Backend] = {}


def register_backend(name: str, *, priority: int, supports: Callable):
    """Decorator: register ``fn`` as the execute hook of backend ``name``."""

    def deco(fn):
        _REGISTRY[name] = Backend(name=name, supports=supports, execute=fn,
                                  priority=priority)
        return fn

    return deco


def registered_backends() -> Dict[str, Backend]:
    return dict(_REGISTRY)


def _ordered():
    return sorted(_REGISTRY.values(), key=lambda b: b.priority)


def available_backends(A, X, ring, desc) -> list:
    """Names of every backend capable of this operand combination."""
    return [b.name for b in _ordered() if b.supports(A, X, ring, desc)]


def can_execute(A, X, ring, desc) -> bool:
    """Would select_backend succeed?  (Shape-only probe; X may be a
    meta tensor.)"""
    if desc.backend == "auto":
        return any(b.supports(A, X, ring, desc) for b in _ordered())
    be = _REGISTRY.get(desc.backend)
    return be is not None and be.supports(A, X, ring, desc)


def select_backend(A, X, ring, desc) -> Backend:
    """Resolve a Descriptor to one executable backend (or raise loudly)."""
    if desc.backend != "auto":
        be = _REGISTRY.get(desc.backend)
        if be is None:
            raise BackendUnavailableError(
                f"unknown backend {desc.backend!r}; registered: "
                f"{sorted(_REGISTRY)}")
        if not be.supports(A, X, ring, desc):
            raise BackendUnavailableError(
                f"backend {desc.backend!r} cannot execute ring "
                f"{getattr(ring, 'name', ring)!r} on this container "
                f"(layout availability / ring kind / shape mismatch); "
                f"capable backends: {available_backends(A, X, ring, desc)}")
        return be
    for be in _ordered():
        if be.supports(A, X, ring, desc):
            return be
    raise BackendUnavailableError(
        f"no registered backend supports ring "
        f"{getattr(ring, 'name', ring)!r} with this container/descriptor")


# ------------------------------------------------------------------ helpers

def _is_pair(X) -> bool:
    return isinstance(X, (tuple, list))


def _is_sparse(X) -> bool:
    return isinstance(X, SparseMatrix)


def _square(A) -> bool:
    return A.n_rows == A.n_cols


def _vals_match(A, X) -> bool:
    """(nnz, k) multivalues only broadcast against an (n, k) multivector."""
    return A.vals.ndim == 1 or getattr(X, "ndim", 0) == 2


def _broadcast_vals(vals, ndim):
    """Lift (nnz,) values to (nnz, 1) against an (n, k) multivector."""
    if ndim == 2 and vals.ndim == 1:
        return vals[:, None]
    return vals


# --------------------------------------------------------------- coo backend

def _coo_supports(A, X, ring, desc):
    if not isinstance(A, SparseMatrix) or _is_sparse(X):
        return False
    if isinstance(ring, PairEdgeSemiring):
        return (_is_pair(X) and len(X) == 2 and _square(A)
                and _vals_match(A, X[0]))
    if isinstance(ring, EdgeSemiring):
        return not _is_pair(X) and _square(A) and _vals_match(A, X)
    return (isinstance(ring, Semiring) and not _is_pair(X)
            and _vals_match(A, X))


@register_backend("coo", priority=20, supports=_coo_supports)
def _coo_execute(A, X, ring, desc):
    """Segment reduction over nnz — the reference path for every ring;
    transpose swaps the gather/scatter index roles."""
    out_idx, src_idx = (A.cols, A.rows) if desc.transpose else (A.rows, A.cols)
    out_idx, src_idx = out_idx.long(), src_idx.long()
    n_out = A.n_cols if desc.transpose else A.n_rows
    # the entries are grouped by row already; by column only after a sort
    ptr = None if desc.transpose else A.row_ptr
    if isinstance(ring, PairEdgeSemiring):
        U, E = X
        vals = _broadcast_vals(A.vals, U.ndim)
        contrib = ring.edge_mul(vals, U[src_idx], U[out_idx],
                                E[src_idx], E[out_idx])
        return _segment_reduce(ring.base, contrib, out_idx, n_out, ptr)
    vals = _broadcast_vals(A.vals, X.ndim)
    if isinstance(ring, EdgeSemiring):
        contrib = ring.edge_mul(vals, X[src_idx], X[out_idx])
        return _segment_reduce(ring.base, contrib, out_idx, n_out, ptr)
    contrib = ring.mul(vals, X[src_idx])
    return _segment_reduce(ring, contrib, out_idx, n_out, ptr)


def _segment_reduce(ring, contrib, out_idx, n_out, ptr):
    """The ring's segment reduction; the reals sum (``segment_sum``, a sum
    in entry order on every device) is handed the row pointers where the
    outputs are the matrix's rows, and skips its sort."""
    if ptr is not None and fast_paths(ring).segment is segment_sum:
        return segment_sum(contrib, out_idx, n_out, ptr)
    return ring.segment_reduce(contrib, out_idx, n_out)


# --------------------------------------------------------------- ell backend

def _ell_supports(A, X, ring, desc):
    """Padded ELL is only sound for rings whose pad entries contribute
    the add-identity — the rings with a registered ``padded`` reducer."""
    return (isinstance(A, SparseMatrix)
            and A.ell_cols is not None
            and A.vals.ndim == 1
            and isinstance(ring, Semiring)
            and not _is_pair(X) and not _is_sparse(X)
            and not desc.transpose
            and fast_paths(ring).padded is not None)


@register_backend("ell", priority=10, supports=_ell_supports)
def _ell_execute(A, X, ring, desc):
    """Padded ELL: gather (n, max_nnz[, k]) then fold along the pad axis."""
    gathered = X[A.ell_cols.long()]
    vals = A.ell_vals if X.ndim == 1 else A.ell_vals[..., None]
    return fast_paths(ring).padded(ring.mul(vals, gathered))


# ------------------------------------------------------------ sellcs backend

def _sellcs_supports(A, X, ring, desc):
    if not (isinstance(A, SparseMatrix) and A.sell_cols is not None
            and not desc.transpose):
        return False
    if isinstance(ring, PairEdgeSemiring):
        return (ring.kind == "plap_hvp" and A.vals.ndim == 1 and _square(A)
                and _is_pair(X) and len(X) == 2
                and getattr(X[0], "ndim", 0) == 2
                and X[0].shape == X[1].shape)
    if isinstance(ring, EdgeSemiring):
        # pads are (col=self, val=0): sound for edge kinds whose multiply
        # annihilates on w=0 — the known plap kind, not generic closures
        return (ring.kind == "plap_apply" and A.vals.ndim == 1 and _square(A)
                and not _is_pair(X) and getattr(X, "ndim", 0) in (1, 2))
    return (isinstance(ring, Semiring) and ring.name == "reals_+x"
            and not _is_pair(X) and getattr(X, "ndim", 0) in (1, 2)
            and _vals_match(A, X))


@register_backend("sellcs", priority=0, supports=_sellcs_supports)
def _sellcs_execute(A, X, ring, desc):
    """SELL-C-σ SpMM through the wrappers of ``kernels.sellcs_spmm``: one
    CUDA kernel launch over every width run for GPU tensors, the plain
    PyTorch twins for CPU tensors."""
    from repro_torch.kernels import sellcs_spmm as K

    if isinstance(ring, PairEdgeSemiring):
        p, eps = ring.params
        return K.sellcs_plap_hvp(A, X[0].contiguous(), X[1].contiguous(),
                                 float(p), float(eps))
    one_d = X.ndim == 1
    X2 = (X[:, None] if one_d else X).contiguous()
    if isinstance(ring, EdgeSemiring):
        p, eps = ring.params
        Y = K.sellcs_plap_apply(A, X2, float(p), float(eps))
    else:
        Y = K.sellcs_spmm(A, X2)
    return Y[:, 0] if one_d else Y


# ----------------------------------------------------- bsr_pallas backend

def bsr_tiles_fit(block_size: int, device) -> bool:
    """Can the BSR kernels take tiles of ``block_size`` on ``device``?
    The CUDA kernels take at most ``MAX_BLOCK`` (128); the plain versions
    that run CPU tiles have no limit.  Decided by the tiles' device, not
    the multivector's: ``can_execute`` probes with meta tensors."""
    return torch.device(device).type != "cuda" or block_size <= MAX_BLOCK


def _bsr_supports(A, X, ring, desc):
    return (isinstance(A, SparseMatrix)
            and A.bsr_blocks is not None
            and bsr_tiles_fit(A.block_size, A.bsr_blocks.device)
            and A.vals.ndim == 1
            and isinstance(ring, Semiring)
            and ring.name == "reals_+x"
            and not _is_pair(X)
            and getattr(X, "ndim", 0) == 2
            and not desc.transpose)


@register_backend("bsr_pallas", priority=15, supports=_bsr_supports)
def _bsr_execute(A, X, ring, desc):
    """Dense-tile SpMM through ``kernels.bsr_spmm``: the CUDA kernel for
    GPU tensors, the plain twin for CPU tensors."""
    from repro_torch.kernels import bsr_spmm as K

    return K.bsr_spmm(A, X.contiguous())


# ---------------------------------------------------- edge_pallas backend

def _edge_pallas_supports(A, X, ring, desc):
    if not (isinstance(A, SparseMatrix) and A.bsr_blocks is not None
            and bsr_tiles_fit(A.block_size, A.bsr_blocks.device)
            and A.vals.ndim == 1 and not desc.transpose and _square(A)):
        return False
    if isinstance(ring, EdgeSemiring) and ring.kind == "plap_apply":
        return not _is_pair(X) and getattr(X, "ndim", 0) == 2
    if isinstance(ring, PairEdgeSemiring) and ring.kind == "plap_hvp":
        return (_is_pair(X) and len(X) == 2
                and getattr(X[0], "ndim", 0) == 2
                and X[0].shape == X[1].shape)
    return False


@register_backend("edge_pallas", priority=16, supports=_edge_pallas_supports)
def _edge_pallas_execute(A, X, ring, desc):
    """Fused p-Laplacian kernels over BSR tiles (``kernels.plap_edge``),
    claiming rings by kind with (p, eps) from ``ring.params``."""
    from repro_torch.kernels import plap_edge as K

    p, eps = ring.params
    if isinstance(ring, PairEdgeSemiring):
        return K.plap_hvp(A, X[0].contiguous(), X[1].contiguous(), float(p),
                          float(eps))
    return K.plap_apply(A, X.contiguous(), float(p), float(eps))


# --------------------------------------------------------- spgemm backend

def _spgemm_supports(A, X, ring, desc):
    """Sparse x sparse under the reals ring.  The output pattern depends
    on the data, so this is a host-side construction op (like every
    layout build), not a kernel."""
    return (isinstance(A, SparseMatrix) and _is_sparse(X)
            and isinstance(ring, Semiring) and ring.name == "reals_+x")


@register_backend("spgemm", priority=25, supports=_spgemm_supports)
def _spgemm_execute(A, B, ring, desc):
    """C = A B (or A^T B under desc.transpose) as a bare-COO SparseMatrix
    on A's device: row-expansion SpGEMM in host numpy, each stored A
    entry (i, j) fanned out over B's row j, duplicate (i, b) pairs summed
    (the reference's algorithm, so the products are equal)."""
    a_rows, a_cols, a_vals = A.host_coo()
    a_rows, a_cols = a_rows.astype(np.int64), a_cols.astype(np.int64)
    if desc.transpose:
        a_rows, a_cols = a_cols, a_rows
    n_out = A.n_cols if desc.transpose else A.n_rows
    b_rows, b_cols, b_vals = B.host_coo()
    b_rows, b_cols = b_rows.astype(np.int64), b_cols.astype(np.int64)

    # CSR-style row pointers of B (from_coo sorts COO by row)
    counts = np.bincount(b_rows, minlength=B.n_rows)
    indptr = np.concatenate([[0], np.cumsum(counts)])
    reps = counts[a_cols]                       # fan-out of each A entry
    total = int(reps.sum())
    out_rows = np.repeat(a_rows, reps)
    av = np.repeat(a_vals, reps)
    offs = np.arange(total, dtype=np.int64) - np.repeat(
        np.cumsum(reps) - reps, reps)
    bpos = np.repeat(indptr[a_cols], reps) + offs
    out_cols = b_cols[bpos]
    prod = av * b_vals[bpos]

    key = out_rows * B.n_cols + out_cols
    uniq, inv = np.unique(key, return_inverse=True)
    vals = np.bincount(inv, weights=prod)
    return SparseMatrix.from_coo(uniq // B.n_cols, uniq % B.n_cols, vals,
                                 (n_out, B.n_cols), dtype=A.dtype,
                                 build_ell=False, build_sellcs=False,
                                 device=A.device)
