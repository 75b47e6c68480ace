"""Optimizers from scratch: AdamW and Adafactor.  Port of the
reference's ``repro.train.optimizer``.

API: ``opt.init(params) -> state``; ``opt.update(grads, state, params,
lr) -> (params, state)`` (under a mesh also ``shards=``, below).  ``params`` is the model's ``nn.Module`` (or a
dict of name -> tensor), ``grads`` a dict keyed by the same names
(``named_parameters()``).  The update writes the parameters and the
moments in place under ``torch.no_grad()`` and returns the same objects:
at Gemma-2B's size a functional copy would cost another 10 GB of
parameters and 20 GB of moments a step.  The moments are fp32, the
arithmetic fp32, and a parameter is written back in its own dtype, as
the reference casts ``p - lr * step`` back.  ``count`` is a 0-d int32
tensor on the host, so reading it for the learning rate syncs nothing.

Adafactor (Shazeer & Stern 2018) keeps factored second moments for
leaves with ndim >= 2 (a row and a column accumulator in place of a
full moment tensor).  The reference stacks every per-layer leaf on a
leading layers axis, so it factors a norm's (L, d) scale across layers
and takes the update clip's RMS over all L layers of a leaf at once; a
per-leaf Adafactor over the port's ``blocks.{i}.…`` leaves would be
another optimizer.  So ``adafactor`` groups the leaves by their name
with the layer index removed (``layer_groups``: ``blocks.3.ln1.scale``
joins ``blocks.ln1.scale``, the inverse of ``convert.lm_state_dict``;
``dense_blocks``, ``enc_blocks`` and a hybrid group's ``sub{i}``
likewise) and keeps one moment a group, over the stacked group.  A leaf
without a layer index is a group of its own, as in the reference.
AdamW is elementwise and needs no grouping; the global-norm clip is the
same either way.

Under a mesh a parameter is a rank's block: ``update(..., shards=)``
(name -> the mesh and the axes of each of the leaf's dims, which the
train step passes) makes Adafactor's means over a dim a split dim's
mean over its ranks' blocks (``_block_mean``), so its moments and its
update clip are the whole leaf's; AdamW takes it and needs nothing.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, NamedTuple, Tuple

import torch
from torch import nn

from repro_torch.launch import mesh as _mesh


def named_leaves(tree) -> Dict[str, torch.Tensor]:
    """name -> tensor of a module's parameters or of a dict."""
    if isinstance(tree, nn.Module):
        return dict(tree.named_parameters())
    return dict(tree)


def global_norm(tree) -> torch.Tensor:
    """The fp32 2-norm over every leaf of a dict (or module)."""
    leaves = list(named_leaves(tree).values())
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in leaves))


@torch.no_grad()
def clip_by_global_norm(tree, max_norm, norm=None):
    """Scale every leaf of ``tree`` in place by min(1, max_norm / norm);
    returns (tree, norm).  ``norm`` defaults to ``global_norm(tree)``
    (under a mesh the caller passes the global tree's)."""
    n = global_norm(tree) if norm is None else norm
    scale = torch.clamp(max_norm / torch.clamp(n, min=1e-9), max=1.0)
    for x in named_leaves(tree).values():
        x.mul_(scale)
    return tree, n


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable
    update: Callable  # (grads, state, params, lr) -> (params, state)
    name: str = "opt"


def _write(p: torch.Tensor, step: torch.Tensor, lr: float) -> None:
    """p <- p - lr * step, in fp32, cast back to p's dtype."""
    if p.dtype == torch.float32:
        p.sub_(step.mul_(lr))
    else:
        p.copy_(p.to(torch.float32) - step.mul_(lr))


# ----------------------------------------------------------------- AdamW

class AdamState(NamedTuple):
    mu: Any
    nu: Any
    count: torch.Tensor


def adamw(b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1) -> Optimizer:
    def init(params):
        named = named_leaves(params)

        def f32():
            return {n: torch.zeros_like(p, dtype=torch.float32)
                    for n, p in named.items()}

        return AdamState(mu=f32(), nu=f32(),
                         count=torch.zeros((), dtype=torch.int32))

    @torch.no_grad()
    def update(grads, state, params, lr, shards=None):
        c = state.count + 1
        bc1 = 1.0 - b1 ** float(c)
        bc2 = 1.0 - b2 ** float(c)
        for name, p in named_leaves(params).items():
            g = grads[name].to(torch.float32)
            m, v = state.mu[name], state.nu[name]
            m.mul_(b1).add_(g, alpha=1.0 - b1)
            v.mul_(b2).addcmul_(g, g, value=1.0 - b2)
            step = (m / bc1).div_((v / bc2).sqrt_().add_(eps))
            if weight_decay:
                step.add_(p.to(torch.float32), alpha=weight_decay)
            _write(p, step, lr)
        return params, AdamState(mu=state.mu, nu=state.nu, count=c)

    return Optimizer(init=init, update=update, name="adamw")


# -------------------------------------------------------------- Adafactor

class FactoredMoment(NamedTuple):
    row: torch.Tensor    # mean of squares over the last axis
    col: torch.Tensor    # mean of squares over the second-to-last axis


class AdafactorState(NamedTuple):
    moments: Any         # FactoredMoment for ndim>=2, full nu otherwise
    count: torch.Tensor


def layer_groups(names) -> Dict[str, Tuple[List[str], bool]]:
    """Group name -> (its member leaves in layer order, stacked).  A
    name's layer index (its one numeric component) is dropped from the
    group name, so ``blocks.{i}.x`` for every i forms the stacked group
    ``blocks.x`` (stacked even with one member, as the reference's
    (1, ...) stack is); a leaf without one is a group of its own."""
    groups: Dict[str, Tuple[list, bool]] = {}
    for name in names:
        parts = name.split(".")
        idx = [i for i, s in enumerate(parts) if s.isdigit()]
        if not idx:
            groups[name] = ([(0, name)], False)
            continue
        if len(idx) > 1:
            raise ValueError(f"{name}: more than one layer index")
        key = ".".join(parts[:idx[0]] + parts[idx[0] + 1:])
        groups.setdefault(key, ([], True))[0].append(
            (int(parts[idx[0]]), name))
    return {k: ([n for _, n in sorted(v)], st)
            for k, (v, st) in groups.items()}


def adafactor(decay=0.8, eps=1e-30, clip_threshold=1.0,
              weight_decay=0.0) -> Optimizer:
    def init(params):
        named = named_leaves(params)
        moments = {}
        for key, (members, stacked) in layer_groups(named).items():
            p = named[members[0]]
            shape = ((len(members),) if stacked else ()) + tuple(p.shape)

            def zeros(s):
                return torch.zeros(s, dtype=torch.float32, device=p.device)

            moments[key] = (FactoredMoment(row=zeros(shape[:-1]),
                                           col=zeros(shape[:-2]
                                                     + shape[-1:]))
                            if len(shape) >= 2 else zeros(shape))
        return AdafactorState(moments=moments,
                              count=torch.zeros((), dtype=torch.int32))

    @torch.no_grad()
    def update(grads, state, params, lr, shards=None):
        c = state.count + 1
        beta = 1.0 - float(c) ** -decay
        named = named_leaves(params)
        for key, (members, stacked) in layer_groups(named).items():
            m = state.moments[key]
            g = (torch.stack([grads[n].to(torch.float32) for n in members])
                 if stacked else grads[members[0]].to(torch.float32))
            mean = _block_mean(shards, members[0], g.ndim, stacked)
            g2 = g * g + eps
            if isinstance(m, FactoredMoment):
                m.row.mul_(beta).add_(mean(g2, -1), alpha=1.0 - beta)
                m.col.mul_(beta).add_(mean(g2, -2), alpha=1.0 - beta)
                row_mean = mean(m.row, -1, leaf_dim=-2, keepdim=True)
                vhat = (m.row[..., None] / torch.clamp(
                    row_mean[..., None], min=eps)) * m.col[..., None, :]
                step = g * torch.rsqrt(torch.clamp(vhat, min=eps))
            else:
                m.mul_(beta).add_(g2, alpha=1.0 - beta)
                step = g * torch.rsqrt(torch.clamp(m, min=eps))
            del g, g2
            # update clipping (RMS of step <= clip_threshold), over the
            # whole group
            rms = torch.sqrt(mean(step * step) + 1e-30)
            step = step / torch.clamp(rms / clip_threshold, min=1.0)
            for i, n in enumerate(members):
                s = step[i] if stacked else step
                p = named[n]
                if weight_decay:
                    s = s + weight_decay * p.to(torch.float32)
                _write(p, s, lr)
        return params, AdafactorState(moments=state.moments, count=c)

    return Optimizer(init=init, update=update, name="adafactor")


def _block_mean(shards, name: str, ndim: int, stacked: bool):
    """``mean(x, dim, leaf_dim, keepdim)``: the mean of ``x`` over its
    dim ``dim`` (None: every dim), which is the group's (stacked) leaf's
    dim ``leaf_dim`` (default ``dim``), where ``x`` is a rank's block:
    the block's mean, averaged over the ranks that split that dim
    (``shards[name]``: the mesh and the axes of each of the leaf's
    dims; None: one process).  The blocks are equal in size, so that is
    the whole leaf's mean."""
    mesh, dims = shards[name] if shards is not None else (None, ())
    dims = ((),) * stacked + tuple(dims)
    dims += ((),) * (ndim - len(dims))          # trailing replication

    def mean(x, dim=None, leaf_dim=None, keepdim=False):
        if dim is None:
            out, axes = torch.mean(x), tuple(a for d in dims for a in d)
        else:
            out = x.mean(dim, keepdim=keepdim)
            axes = dims[dim if leaf_dim is None else leaf_dim]
        if mesh is None or mesh.count(axes) == 1:
            return out
        return _mesh.all_reduce(mesh, out, axes) / mesh.count(axes)

    return mean


def get_optimizer(name: str, **kw) -> Optimizer:
    if name == "adamw":
        return adamw(**kw)
    if name == "adafactor":
        return adafactor(**kw)
    raise KeyError(name)
