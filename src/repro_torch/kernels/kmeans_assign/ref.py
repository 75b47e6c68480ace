"""The plain version of the fused kmeans assignment: the port of the
reference's ``kernels/kmeans_assign/ref.py::kmeans_assign_ref``.

    d(x, c) = ||x||^2 + ||c||^2 - 2 x.c, clamped at 0

as one matmul, then the argmin (ties go to the lowest index: torch's
``min`` over a dimension returns the first minimal index) and the min.
``C`` may carry a leading batch of centroid sets, (R, kc, d), the
port's written-out form of the reference ``vmap``ping its restarts.
"""
from __future__ import annotations

from typing import Tuple

import torch


def pairwise_sqdist(X: torch.Tensor, C: torch.Tensor) -> torch.Tensor:
    """(..., n, kc) squared distances via the matmul identity; C may
    carry leading batch dimensions."""
    xx = torch.sum(X * X, dim=-1, keepdim=True)
    cc = torch.sum(C * C, dim=-1)[..., None, :]
    return torch.clamp(xx + cc - 2.0 * (X @ C.transpose(-1, -2)), min=0.0)


def kmeans_assign_ref(X: torch.Tensor, C: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(labels int32 (..., n), min sqdist (..., n)) for X (n, d) and
    C (kc, d) or (R, kc, d)."""
    dmin, labels = torch.min(pairwise_sqdist(X, C), dim=-1)
    return labels.to(torch.int32), dmin
