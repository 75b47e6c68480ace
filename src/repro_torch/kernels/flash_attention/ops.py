"""Public attention entry point, the counterpart of the reference's
``kernels/flash_attention/ops.py::flash_attention``.

``flash_attention(q, k, v, causal=True, window=None)`` takes q
(B, Hq, S, D), k (B, Hkv, S, D) and v (B, Hkv, S, Dv) and returns
(B, Hq, S, Dv); MLA's value head dim Dv is narrower than D.  A CUDA
tensor goes to the hand-written kernel (``flash_attention_cuda``); a CPU
tensor to the plain version, ``attention_ref`` up to S = 1024 and the
query-chunked ``attention_ref_chunked`` above, as the reference's jnp
path does; a meta tensor (the dry run, ``launch/dryrun.py``) to a
shape-only route that makes the CUDA route's buffers and returns an
empty (B, Hq, S, Dv) meta tensor; any other device raises.  Every route
reports the call to the active ``launch.op_count.OpCounter``
(``flash_op``): its FLOPs on the visible (query, key) pairs, apart from
the dots.  On the card the wgmma kernel takes
v of width Dv as is at its compiled (D, Dv) (MLA's (192, 128) among
them: no pad, Dv-wide tiles and products); on the other routes (the
mma and fp32 kernels, wgmma at a (D, Dv) not compiled, such as D 128 /
Dv 64) a v narrower than k is zero-padded to D, the kernel launches on
it, and the first Dv columns of its output are returned: exact, since
the padded columns of P V are zero.  It is differentiable: the forward
is wrapped in a ``torch.autograd.Function`` whose backward recomputes
through ``attention_ref``, as the reference's ``custom_vjp`` does.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_attention.flash_attention import (
    check_operands, flash_attention_cuda, takes_value_dim)
from repro_torch.kernels.flash_attention.ref import (attention_ref,
                                                     attention_ref_chunked)
from repro_torch.launch.op_count import flash_op

CHUNKED_ABOVE = 1024     # the plain version chunks queries above this S


def plain_attention(q, k, v, causal: bool = True,
                    window: Optional[int] = None) -> torch.Tensor:
    """The plain version the op runs for CPU tensors."""
    if q.shape[2] > CHUNKED_ABOVE:
        return attention_ref_chunked(q, k, v, causal=causal, window=window)
    return attention_ref(q, k, v, causal=causal, window=window)


def _shape_only(q, k, v, causal, window) -> torch.Tensor:
    """The meta route's stand-in for one kernel launch: the output the
    kernel would write, no work."""
    return q.new_empty(q.shape[:3] + v.shape[3:])


def _forward(q, k, v, causal: bool, window: Optional[int]) -> torch.Tensor:
    check_operands(q, k, v, window)
    with flash_op(q, k, v, causal, window):
        if q.device.type == "cpu":
            return plain_attention(q, k, v, causal, window)
        launch = (_shape_only if q.device.type == "meta"
                  else flash_attention_cuda)    # which raises off CUDA
        return _kernel_route(q, k, v, causal, window, launch)


def _kernel_route(q, k, v, causal, window, launch) -> torch.Tensor:
    """The card's route: v padded to D where the kernel does not take
    its width, contiguous operands, one ``launch``."""
    D, Dv = k.shape[3], v.shape[3]
    if Dv > D:
        raise ValueError(f"value head dim {Dv} above the q/k head dim {D}: "
                         "the kernels take Dv <= D")
    pad = not takes_value_dim(q.dtype, D, Dv, k.shape[2])
    if pad:
        v = torch.nn.functional.pad(v, (0, D - Dv))
    out = launch(q.contiguous(), k.contiguous(), v.contiguous(), causal,
                 window)
    return out[..., :Dv] if pad else out


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
