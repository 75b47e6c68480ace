"""k-means discretization of the spectral coordinates.

Port of ``repro.core.kmeans``: d(x, c) = ||x||^2 + ||c||^2 - 2 x.c as one
matmul, argmin assignment (ties go to the lowest index), kmeans++
seeding, fixed-iteration Lloyd with empty clusters re-seeded at the
farthest point, and several restarts keeping the best inertia.  The
reference ``vmap``s its restarts; here they are a written-out leading
batch dimension, and ``jax.random`` keys are a ``torch.Generator``.
"""
from __future__ import annotations

from typing import Tuple

import torch


def pairwise_sqdist(X: torch.Tensor, C: torch.Tensor) -> torch.Tensor:
    """(..., n, k_cent) squared distances via the matmul identity; C may
    carry leading batch dimensions."""
    xx = torch.sum(X * X, dim=-1, keepdim=True)
    cc = torch.sum(C * C, dim=-1)[..., None, :]
    return torch.clamp(xx + cc - 2.0 * (X @ C.transpose(-1, -2)), min=0.0)


def assign(X: torch.Tensor, C: torch.Tensor) -> torch.Tensor:
    """Nearest centroid; torch.argmin returns the first (lowest) index
    among equal minima."""
    return torch.argmin(pairwise_sqdist(X, C), dim=-1)


def _plusplus_init(gen: torch.Generator, X: torch.Tensor, k: int,
                   restarts: int) -> torch.Tensor:
    """kmeans++ seeding for ``restarts`` independent runs: (R, k, d)."""
    n = X.shape[0]
    first = torch.randint(0, n, (restarts,), generator=gen, device=X.device)
    C = X[first][:, None, :].repeat(1, k, 1)
    for i in range(1, k):
        d2 = pairwise_sqdist(X, C)                            # (R, n, k)
        mask = torch.arange(k, device=X.device)[None, None, :] < i
        dmin = torch.min(torch.where(mask, d2, torch.full_like(d2, float("inf"))),
                         dim=-1).values                       # (R, n)
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
    for _ in range(iters):
        d2 = pairwise_sqdist(X, C)                            # (..., n, k)
        a = torch.argmin(d2, dim=-1)
        onehot = torch.nn.functional.one_hot(a, k).to(X.dtype)
        counts = torch.sum(onehot, dim=-2)                    # (..., k)
        sums = onehot.transpose(-1, -2) @ X                   # (..., k, d)
        newC = sums / torch.clamp(counts[..., None], min=1.0)
        far = X[torch.argmax(torch.min(d2, dim=-1).values, dim=-1)]  # (..., d)
        C = torch.where(counts[..., None] > 0, newC, far[..., None, :])
    d2 = pairwise_sqdist(X, C)
    a = torch.argmin(d2, dim=-1)
    inertia = torch.sum(torch.min(d2, dim=-1).values, dim=-1)
    return a, C, inertia


def kmeans(gen: torch.Generator, X: torch.Tensor, k: int, restarts: int = 8,
           iters: int = 50) -> Tuple[torch.Tensor, torch.Tensor]:
    """Multi-restart kmeans++: (labels (n,), centroids (k,d))."""
    C0 = _plusplus_init(gen, X, k, restarts)
    labels, Cs, inertias = lloyd(X, C0, iters)
    best = int(torch.argmin(inertias))
    return labels[best], Cs[best]
