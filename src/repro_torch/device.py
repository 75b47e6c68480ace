"""Device and dtype helpers shared by every entry point of the port.

``resolve_device(None)`` means the GPU: the port's entry points run on
``cuda`` unless the caller asks for ``"cpu"`` explicitly (as the CPU
tests do).  With no GPU present a default request raises — nothing falls
back to the CPU behind the caller's back.

Resolving a CUDA device also turns TF32 off for matmuls and cuDNN
(``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32``): the fp32 parity bounds the port is
held to assume full fp32 products (TF32 keeps about three decimal
digits).  This is a process-wide setting of PyTorch, set on the port's
path and never set back.
"""
from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

DEFAULT_DEVICE = "cuda"

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The torch device an entry point runs on (default: ``cuda``)."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on the GPU by default and no CUDA device "
                "is available; pass device='cpu' to run on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev


def torch_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch dtype, a numpy dtype or its name
    (including "bfloat16", which numpy does not know)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    if isinstance(dtype, str) and isinstance(getattr(torch, dtype, None),
                                             torch.dtype):
        return getattr(torch, dtype)
    return torch.from_numpy(np.empty(0, np.dtype(dtype))).dtype


def numpy_dtype(dtype) -> np.dtype:
    """The numpy dtype of a torch (or numpy) dtype."""
    if isinstance(dtype, torch.dtype):
        return torch.empty((), dtype=dtype).numpy().dtype
    return np.dtype(dtype)
