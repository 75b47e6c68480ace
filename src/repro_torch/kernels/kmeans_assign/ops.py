"""Public entry of the fused kmeans assignment.

``kmeans_assign(X, C)`` returns (labels int32, min sqdist) for X (n, d)
and C (kc, d) or a batch (R, kc, d).  A CUDA tensor goes to the
hand-written kernel (``kmeans_assign.kmeans_assign_cuda``), a CPU
tensor to the plain version (``ref.kmeans_assign_ref``); any other
device raises.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.kmeans_assign.kmeans_assign import (
    check_operands, kmeans_assign_cuda)
from repro_torch.kernels.kmeans_assign.ref import kmeans_assign_ref


def kmeans_assign(X: torch.Tensor, C: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    check_operands(X, C)
    if X.device.type == "cpu":
        return kmeans_assign_ref(X, C)
    return kmeans_assign_cuda(X.contiguous(), C.contiguous())
