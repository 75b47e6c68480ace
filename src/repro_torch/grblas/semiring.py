"""Algebraic relations: semirings, edge-semirings and per-ring fast paths.

Port of ``repro.grblas.semiring`` for the rings the flat pipeline uses:
the reals (+, x) ring, the p-Laplacian edge ring (the gradient op) and
the pair-edge ring (the matrix-free Newton HVP).

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
add-identity — true for the reals ring.  The reference's other rings
(min-plus, max-times, boolean) and its generic sequential fold wait for
the slice that needs them (ROADMAP.md queue 1, item 11).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.core import phi as PHI


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
        """Reduce ``values`` per segment under the add-monoid."""
        fp = fast_paths(self)
        if fp.segment is None:
            raise NotImplementedError(
                f"ring {self.name!r} has no segment reducer in the port; "
                "generic monoid folds come with ROADMAP.md queue 1, item 11")
        return fp.segment(values, segment_ids, num_segments)


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


def _segment_sum(values, segment_ids, num_segments):
    out = torch.zeros((num_segments,) + tuple(values.shape[1:]),
                      dtype=values.dtype, device=values.device)
    return out.index_add_(0, segment_ids.long(), values)


reals_ring = Semiring(add=_add, mul=_mul, zero=0.0, one=1.0, name="reals_+x")

register_ring_fast_paths(
    "reals_+x",
    segment=_segment_sum,
    dense=lambda a, axis: torch.sum(a) if axis is None else torch.sum(a, dim=axis),
    padded=lambda contrib: torch.sum(contrib, dim=1),  # pads are exact no-ops
)


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
