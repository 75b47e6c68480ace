"""Public attention entry point, the counterpart of the reference's
``kernels/flash_attention/ops.py::flash_attention``.

``flash_attention(q, k, v, causal=True, window=None)`` takes q
(B, Hq, S, D), k (B, Hkv, S, D) and v (B, Hkv, S, Dv) and returns
(B, Hq, S, Dv); MLA's value head dim Dv is narrower than D.  A CUDA
tensor goes to the hand-written kernel (``flash_attention_cuda``); a CPU
tensor to the plain version, ``attention_ref`` up to S = 1024 and the
query-chunked ``attention_ref_chunked`` above, as the reference's jnp
path does; any other device raises.  On the card a v narrower than k is
zero-padded to D, the kernel launches on it, and the first Dv columns
of its output are returned: exact, since the padded columns of P V are
zero.  A kernel that reads only Dv columns of V would save the padded
reads and products; that is later performance work.  It is
differentiable: the forward is wrapped in a ``torch.autograd.Function``
whose backward recomputes through ``attention_ref``, as the
reference's ``custom_vjp`` does.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_attention.flash_attention import (
    check_operands, flash_attention_cuda)
from repro_torch.kernels.flash_attention.ref import (attention_ref,
                                                     attention_ref_chunked)

CHUNKED_ABOVE = 1024     # the plain version chunks queries above this S


def plain_attention(q, k, v, causal: bool = True,
                    window: Optional[int] = None) -> torch.Tensor:
    """The plain version the op runs for CPU tensors."""
    if q.shape[2] > CHUNKED_ABOVE:
        return attention_ref_chunked(q, k, v, causal=causal, window=window)
    return attention_ref(q, k, v, causal=causal, window=window)


def _forward(q, k, v, causal: bool, window: Optional[int]) -> torch.Tensor:
    check_operands(q, k, v, window)
    if q.device.type == "cpu":
        return plain_attention(q, k, v, causal, window)
    D, Dv = k.shape[3], v.shape[3]
    if Dv > D:
        raise ValueError(f"value head dim {Dv} above the q/k head dim {D}: "
                         "the kernels take Dv <= D")
    if Dv < D:
        v = torch.nn.functional.pad(v, (0, D - Dv))
    out = flash_attention_cuda(q.contiguous(), k.contiguous(),
                               v.contiguous(), causal, window)
    return out[..., :Dv] if Dv < D else out


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.window = causal, window
        return _forward(q, k, v, causal, window)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() for t in (q, k, v)]
            out = attention_ref(*leaves, causal=ctx.causal,
                                window=ctx.window)
            grads = torch.autograd.grad(out, leaves, g)
        return (*grads, None, None)


def flash_attention(q, k, v, causal: bool = True,
                    window: Optional[int] = None) -> torch.Tensor:
    """(B, Hq, S, Dv) attention output in q's dtype."""
    return _FlashAttention.apply(q, k, v, causal, window)
