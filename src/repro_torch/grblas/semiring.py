"""Algebraic relations: semirings, edge-semirings and per-ring fast paths.

Port of ``repro.grblas.semiring``: the reals (+, x) ring, the
min-plus, max-times and boolean (or, and) rings, the p-Laplacian edge
ring (the gradient op) and the pair-edge ring (the matrix-free Newton
HVP).

A GraphBLAS semiring is (add-monoid, mul-op, zero, one).  The
EdgeSemiring generalizes ``mul`` to an edge function
``edge_mul(w_ij, x_j, x_i)`` so one SpMM expresses the p-Laplacian apply
(Delta_p x)_i = sum_j w_ij phi_p(x_i - x_j); the PairEdgeSemiring sees a
pair of multivectors, which is what the Newton Hessian apply needs:
sum_j w_ij phi'(u_i-u_j) (eta_i-eta_j).  ``kind``/``params`` let a
backend claim a ring by what it computes (e.g. "plap_apply" with
(p, eps)) instead of tracing its closure.

Fast paths: ``register_ring_fast_paths(name, segment=, dense=, padded=)``
attaches the vectorized reducers a ring may use; ``fast_paths(ring)``
looks them up.  ``padded`` is the ELL/SELL pad-axis reducer and is only
registered for rings whose pad entries (col=row, val=0) contribute the
add-identity — true for the reals ring.  Rings without a segment fast
path take a correct generic fold under ``add`` (``generic_segment_fold``:
each segment folded in entry order, as the reference's sequential scan
folds it), never a silent sum.

Every registered segment reducer gives the same bits on every run: the
reals sum adds in entry order (``kernels.segment_sum``), and min, max
and or are order-free, so a scatter of them (int32 for the boolean
ring) is exact whatever order the atomics land in.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.core import phi as PHI
from repro_torch.kernels.segment_sum import segment_sum


@dataclasses.dataclass(frozen=True)
class RingFastPaths:
    """Vectorized reducers a named ring is allowed to use.

    segment(values, segment_ids, num_segments) — COO segment reduction
    dense(a, axis)                             — dense container fold
    padded(contrib)                            — pad-axis (dim=1) fold
    """

    segment: Optional[Callable] = None
    dense: Optional[Callable] = None
    padded: Optional[Callable] = None


_FAST_PATHS: Dict[str, RingFastPaths] = {}
_EMPTY_FAST_PATHS = RingFastPaths()


def register_ring_fast_paths(name: str, *, segment: Callable = None,
                             dense: Callable = None,
                             padded: Callable = None) -> None:
    """Register (or replace) the fast-path reducers for ring ``name``."""
    _FAST_PATHS[name] = RingFastPaths(segment=segment, dense=dense,
                                      padded=padded)


def fast_paths(ring) -> RingFastPaths:
    """The registered fast paths of ``ring`` (empty set if none)."""
    return _FAST_PATHS.get(getattr(ring, "name", None), _EMPTY_FAST_PATHS)


@dataclasses.dataclass(frozen=True)
class Semiring:
    """(add, mul, zero, one) over torch tensors (elementwise)."""

    add: Callable
    mul: Callable
    zero: float
    one: float
    name: str = "semiring"

    def segment_reduce(self, values, segment_ids, num_segments):
        """Reduce ``values`` per segment under the add-monoid: the ring's
        registered segment reducer, else ``generic_segment_fold``."""
        fp = fast_paths(self)
        if fp.segment is not None:
            return fp.segment(values, segment_ids, num_segments)
        return generic_segment_fold(self, values, segment_ids, num_segments)


def generic_segment_fold(ring, values, segment_ids, num_segments):
    """Fold ``values`` into ``num_segments`` segments under ``ring.add``
    from ``ring.zero``, each segment in entry order — the reference's
    sequential scan, in as many vectorized steps as the longest segment
    has entries: step r folds every segment's r-th entry at once (no two
    of them share a segment)."""
    ids = segment_ids.long()
    out = torch.full((num_segments,) + tuple(values.shape[1:]), ring.zero,
                     dtype=values.dtype, device=values.device)
    if ids.numel() == 0:
        return out
    order = torch.argsort(ids, stable=True)
    sorted_ids = ids[order]
    counts = torch.bincount(sorted_ids, minlength=num_segments)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(ids.numel(), device=ids.device) - starts[sorted_ids]
    for r in range(int(counts.max())):
        sel = order[rank == r]
        seg = ids[sel]
        out[seg] = ring.add(out[seg], values[sel])
    return out


@dataclasses.dataclass(frozen=True)
class EdgeSemiring:
    """Semiring whose multiply sees the edge weight AND both endpoints:
    ``edge_mul(w, x_src, x_dst)`` is the contribution of edge
    (dst <- src), folded under ``base``'s add-monoid."""

    base: Semiring
    edge_mul: Callable
    name: str = "edge_semiring"
    kind: str = "generic"
    params: Tuple = ()


@dataclasses.dataclass(frozen=True)
class PairEdgeSemiring:
    """Edge-semiring over a PAIR of multivectors (U, Eta):
    ``edge_mul(w, u_src, u_dst, e_src, e_dst)``."""

    base: Semiring
    edge_mul: Callable
    name: str = "pair_edge_semiring"
    kind: str = "generic"
    params: Tuple = ()


def _add(a, b):
    return a + b


def _mul(a, b):
    return a * b


reals_ring = Semiring(add=_add, mul=_mul, zero=0.0, one=1.0, name="reals_+x")
min_plus_ring = Semiring(add=torch.minimum, mul=_add, zero=float("inf"),
                         one=0.0, name="min_+")
max_times_ring = Semiring(add=torch.maximum, mul=_mul, zero=float("-inf"),
                          one=1.0, name="max_x")
boolean_ring = Semiring(add=torch.logical_or, mul=torch.logical_and,
                        zero=False, one=True, name="bool_|&")


def _scatter_fold(how: str, zero: float):
    """A segment reducer by an order-free scatter (``amin`` / ``amax``)."""

    def segment(values, segment_ids, num_segments):
        out = torch.full((num_segments,) + tuple(values.shape[1:]), zero,
                         dtype=values.dtype, device=values.device)
        idx = segment_ids.long().view(-1, *([1] * (values.ndim - 1)))
        return out.scatter_reduce_(0, idx.expand_as(values), values, how)

    return segment


def _bool_segment(values, segment_ids, num_segments):
    """Or per segment: a scatter-max over int32 {0, 1} (or is order-free,
    so every run gives the same bits)."""
    v = values.to(torch.int32)
    out = torch.zeros((num_segments,) + tuple(v.shape[1:]), dtype=torch.int32,
                      device=v.device)
    idx = segment_ids.long().view(-1, *([1] * (v.ndim - 1)))
    return out.scatter_reduce_(0, idx.expand_as(v), v, "amax").bool()


def _dense(fn):
    """A dense fold ``fn(a, dim)`` that also takes axis=None (all)."""
    return lambda a, axis: fn(a) if axis is None else fn(a, dim=axis)

register_ring_fast_paths(
    "reals_+x",
    # a sum in entry order, the same bit for bit on every run (a float
    # index_add_ on the card would add in atomic order)
    segment=segment_sum,
    dense=_dense(torch.sum),
    padded=lambda contrib: torch.sum(contrib, dim=1),  # pads are exact no-ops
)
register_ring_fast_paths("min_+", segment=_scatter_fold("amin", float("inf")),
                         dense=_dense(torch.amin))
register_ring_fast_paths("max_x",
                         segment=_scatter_fold("amax", float("-inf")),
                         dense=_dense(torch.amax))
register_ring_fast_paths("bool_|&", segment=_bool_segment,
                         dense=_dense(torch.any))


def phi_p(x: torch.Tensor, p: float, eps: float = 0.0) -> torch.Tensor:
    """phi_p(x) = |x|^{p-1} sign(x), optionally eps-smoothed for p<2.

    The smoothed variant (x^2+eps)^{(p-2)/2} * x keeps the p-Laplacian
    differentiable at x=0 (needed by Newton for p<2); the same function
    as ``core.phi.phi``, which the edge rings below evaluate.
    """
    return PHI.phi(x, p, eps)


def plap_edge_semiring(p: float, eps: float = 1e-9) -> EdgeSemiring:
    """Edge-semiring computing  w_ij * phi_p(x_i - x_j)  per edge."""

    def edge_mul(w, x_src, x_dst):
        return w * PHI.phi(x_dst - x_src, p, eps)

    return EdgeSemiring(base=reals_ring, edge_mul=edge_mul,
                        name=f"plap_edge_p{p}", kind="plap_apply",
                        params=(p, eps))


def plap_hvp_edge_semiring(p: float, eps: float = 1e-9) -> PairEdgeSemiring:
    """Pair-edge-semiring for the matrix-free Hessian apply: one SpMM
    computes y_i = sum_j w_ij phi'(u_i - u_j) (eta_i - eta_j) per column
    (the Hess A part of the Newton HVP).  The caller supplies
    X = (U, Eta)."""

    def edge_mul(w, u_src, u_dst, e_src, e_dst):
        return w * PHI.phi_prime(u_dst - u_src, p, eps) * (e_dst - e_src)

    return PairEdgeSemiring(base=reals_ring, edge_mul=edge_mul,
                            name=f"plap_hvp_p{p}", kind="plap_hvp",
                            params=(p, eps))


def plap_hess_edge_semiring(p: float, eps: float = 1e-9) -> EdgeSemiring:
    """Deprecated pre-fused Hessian edge-semiring (kept one release).

    Superseded by ``plap_hvp_edge_semiring``: the pair-edge ring sees
    (U, Eta) directly instead of a caller-prefused w*phi'(du) weight.
    Its kind is generic, so no kernel claims it.
    """

    def edge_mul(w_and_du, eta_src, eta_dst):
        return w_and_du * (eta_dst - eta_src)

    return EdgeSemiring(base=reals_ring, edge_mul=edge_mul,
                        name=f"plap_hess_p{p}")
