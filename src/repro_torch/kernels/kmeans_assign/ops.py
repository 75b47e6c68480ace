"""Public entry of the fused kmeans assignment.

``kmeans_assign(X, C)`` returns (labels int32, min sqdist) for X (n, d)
and C (kc, d) or a batch (R, kc, d).  A CUDA tensor goes to the
hand-written kernels (``kmeans_assign.kmeans_assign_planned``: the
narrow variant in groups of restarts that fit its shared memory, or the
tiled variant for d > 16 or kc > 128), a CPU tensor to the plain version
(``ref.kmeans_assign_ref``); any other device raises.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.kmeans_assign.kmeans_assign import (
    check_operands, kmeans_assign_planned)
from repro_torch.kernels.kmeans_assign.ref import kmeans_assign_ref


def kmeans_assign(X: torch.Tensor, C: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    check_operands(X, C)
    if X.device.type == "cpu":
        return kmeans_assign_ref(X, C)
    return kmeans_assign_planned(X.contiguous(), C.contiguous())
