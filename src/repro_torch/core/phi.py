"""phi_p and smoothed p-powers — the scalar nonlinearity of the p-Laplacian.

For p<2, |x|^p is not C^2 at 0; Newton needs the eps-smoothed surrogate
   s_eps(x) = (x^2 + eps)^{p/2}
whose derivative is phi_eps(x) = p (x^2+eps)^{(p-2)/2} x.  eps=0 recovers
the exact p-power (function values / metrics; derivatives use eps>0).
Port of ``repro.core.phi``; ``p`` and ``eps`` are Python floats.
"""
from __future__ import annotations

import torch


def p_power(x: torch.Tensor, p: float, eps: float = 0.0) -> torch.Tensor:
    """|x|^p (eps-smoothed: (x^2+eps)^{p/2})."""
    if eps == 0.0:
        return torch.abs(x) ** p
    return (x * x + eps) ** (p / 2.0)


def phi(x: torch.Tensor, p: float, eps: float = 0.0) -> torch.Tensor:
    """d/dx of p_power / p: phi_p(x) = |x|^{p-1} sign(x) (smoothed)."""
    if eps == 0.0:
        return torch.abs(x) ** (p - 1.0) * torch.sign(x)
    return (x * x + eps) ** ((p - 2.0) / 2.0) * x


def phi_prime(x: torch.Tensor, p: float, eps: float = 0.0) -> torch.Tensor:
    """d/dx phi_p(x) = (p-1)|x|^{p-2} (smoothed: keeps >=0 for p>1)."""
    if eps == 0.0:
        return (p - 1.0) * torch.abs(x) ** (p - 2.0)
    x2e = x * x + eps
    return x2e ** ((p - 2.0) / 2.0) + (p - 2.0) * x * x * x2e ** ((p - 4.0) / 2.0)


def p_norm_p(u: torch.Tensor, p: float, eps: float = 0.0, axis: int = 0):
    """||u||_p^p along axis (smoothed)."""
    return torch.sum(p_power(u, p, eps), dim=axis)
