"""repro_torch — the PyTorch/CUDA port of GrB-pGrass (``repro``).

The package mirrors the reference tree (``core/``, ``grblas/``,
``kernels/``, ``graphs/``) so each module's counterpart is easy to find.
It imports ``torch``, numpy and scipy, and nothing of JAX or of the
``repro`` package.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
without a GPU and without that explicit request they raise instead of
quietly running on the CPU (``repro_torch.device.resolve_device``).
"""
from repro_torch.device import DEFAULT_DEVICE, resolve_device, torch_dtype

__all__ = ["DEFAULT_DEVICE", "resolve_device", "torch_dtype"]
