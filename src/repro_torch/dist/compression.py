"""Int8 gradient compression with error feedback for data-parallel
gradient reduction (1-bit-Adam / EF-SGD style).  Port of the
reference's ``repro.dist.compression``.

Naive quantisation biases the step, so the quantisation residual is
carried forward and added to the next step's gradient (error
feedback): the running mean of the compressed stream converges to the
true gradient.

What is modelled, as in the reference: the numerics of compressed
reduction (quantise -> reduce -> residual carry).  The mean over the
axis runs on the dequantised fp32 values, so the wire carries fp32,
not int8; the reference's psum does the same (its NOTE), and this port
adds no wire format the reference lacks.

API (leaf-wise over a dict of tensors, or one tensor):
  quantize_int8(x)            -> (int8 values, float32 scalar scale)
  dequantize_int8(q, scale)   -> float32 reconstruction
  init_error_feedback(tree)   -> zero residual tree
  compressed_psum_tree(grads, err, mesh, axis)
                              -> (reduced grads, new residual tree)
"""
from __future__ import annotations

from typing import Dict, Tuple, Union

import torch

from repro_torch.launch import mesh as _mesh

Tree = Union[torch.Tensor, Dict[str, torch.Tensor]]


def _map(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: fn(*(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def quantize_int8(x: torch.Tensor, mesh=None, axes=()
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 quantisation: (q, scale) with q in
    [-127, 127] and x ~= q * scale, the scale max|x| / 127 (at least
    1e-30 / 127); round half to even, as ``jnp.round``.  With ``mesh``,
    ``x`` is this rank's block of a tensor split over ``axes`` and the
    max is the whole tensor's."""
    xf = x.to(torch.float32)
    amax = xf.abs().max() if xf.numel() else xf.new_zeros(())
    if mesh is not None:
        amax = _mesh.all_reduce(mesh, amax, axes, "max")
    scale = torch.clamp(amax, min=1e-30) / 127.0
    # one temporary the size of x (the same operations as round, clip)
    q = torch.div(xf, scale).round_().clamp_(-127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32).mul_(scale)


def init_error_feedback(tree: Tree) -> Tree:
    """Zero quantisation-residual state shaped like the gradient tree."""
    return _map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                      device=g.device), tree)


def _pmean_tree(tree: Tree, mesh, axis: str) -> Tree:
    """Mean of every rank's leaf values along ``axis`` (the identity on
    an axis of one rank)."""
    if axis not in mesh.shape:
        raise ValueError(f"compression axis {axis!r} not in mesh axes "
                         f"{tuple(mesh.shape)}")
    size = mesh.shape[axis]
    if size <= 1:
        return tree
    return _map(lambda v: _mesh.all_reduce(mesh, v, axis).div_(size), tree)


def compressed_psum_tree(grads: Tree, err: Tree, mesh,
                         axis: str = "data", scale_axes=()
                         ) -> Tuple[Tree, Tree]:
    """Error-feedback-compensated compressed gradient reduction.

    Per leaf: c = g + err is quantised to int8, the dequantised value
    is mean-reduced over the ``axis`` ranks, and the local residual
    c - deq(c) becomes the next step's err.  A leaf split over
    ``scale_axes`` (a rank's block of it) takes one scale over all its
    blocks.  Returns (reduced, new_err); thread new_err through
    successive steps (see train/loop.py)."""
    comp = _map(lambda g, e: g.to(torch.float32) + e, grads, err)
    deq = _map(lambda c: dequantize_int8(*quantize_int8(c, mesh,
                                                         scale_axes)), comp)
    new_err = _map(torch.subtract, comp, deq)
    return _pmean_tree(deq, mesh, axis), new_err
