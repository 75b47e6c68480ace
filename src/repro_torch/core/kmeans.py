"""k-means discretization of the spectral coordinates.

Port of ``repro.core.kmeans``: d(x, c) = ||x||^2 + ||c||^2 - 2 x.c,
argmin assignment (ties go to the lowest index), kmeans++ seeding,
fixed-iteration Lloyd with empty clusters re-seeded at the farthest
point, and several restarts keeping the best inertia.  The reference
``vmap``s its restarts; here they are a written-out leading batch
dimension, and ``jax.random`` keys are a ``torch.Generator``.

Every distance-and-argmin goes through the fused ``kmeans_assign`` op:
on the card its kernel takes all restarts' centroids in one launch and
writes only the labels and the min distance, never the (R, n, k)
distances; on the CPU it is the plain version, the arithmetic this
module always had.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.kmeans_assign import kmeans_assign, pairwise_sqdist

__all__ = ["pairwise_sqdist", "assign", "lloyd", "kmeans"]


def assign(X: torch.Tensor, C: torch.Tensor) -> torch.Tensor:
    """Nearest centroid (int32 labels; the lowest index among equal
    minima)."""
    return kmeans_assign(X, C)[0]


def _plusplus_init(gen: torch.Generator, X: torch.Tensor, k: int,
                   restarts: int) -> torch.Tensor:
    """kmeans++ seeding for ``restarts`` independent runs: (R, k, d)."""
    n = X.shape[0]
    first = torch.randint(0, n, (restarts,), generator=gen, device=X.device)
    C = X[first][:, None, :].repeat(1, k, 1)
    for i in range(1, k):
        # distance to the nearest of the first i centroids
        dmin = kmeans_assign(X, C[:, :i])[1]                 # (R, n)
        probs = dmin / torch.clamp(torch.sum(dmin, dim=-1, keepdim=True),
                                   min=1e-30)
        probs = torch.where(torch.sum(probs, dim=-1, keepdim=True) > 0, probs,
                            torch.ones_like(probs))
        nxt = torch.multinomial(probs, 1, generator=gen)[:, 0]
        C[:, i] = X[nxt]
    return C


def lloyd(X: torch.Tensor, C0: torch.Tensor, iters: int = 50
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fixed-iteration Lloyd from C0 (k, d) — or a batch (R, k, d) of
    independent runs.  Returns (labels, centroids, inertia)."""
    k = C0.shape[-2]
    C = C0
    cent = torch.arange(k, device=X.device)
    for _ in range(iters):
        a, dmin = kmeans_assign(X, C)                         # (..., n)
        onehot = (a[..., None] == cent).to(X.dtype)           # (..., n, k)
        counts = torch.sum(onehot, dim=-2)                    # (..., k)
        sums = onehot.transpose(-1, -2) @ X                   # (..., k, d)
        newC = sums / torch.clamp(counts[..., None], min=1.0)
        far = X[torch.argmax(dmin, dim=-1)]                   # (..., d)
        C = torch.where(counts[..., None] > 0, newC, far[..., None, :])
    a, dmin = kmeans_assign(X, C)
    inertia = torch.sum(dmin, dim=-1)
    return a, C, inertia


def kmeans(gen: torch.Generator, X: torch.Tensor, k: int, restarts: int = 8,
           iters: int = 50) -> Tuple[torch.Tensor, torch.Tensor]:
    """Multi-restart kmeans++: (labels (n,) int64, centroids (k,d))."""
    C0 = _plusplus_init(gen, X, k, restarts)
    labels, Cs, inertias = lloyd(X, C0, iters)
    best = int(torch.argmin(inertias))
    return labels[best].long(), Cs[best]
