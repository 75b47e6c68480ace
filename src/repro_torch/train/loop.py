"""Training step factory: loss -> grads -> clip -> optimizer, with
optional microbatch gradient accumulation.  Port of the reference's
``repro.train.loop``.

The returned step is a plain function of (params, opt_state, batch),
called eagerly; it turns ``params`` (the model's ``nn.Module``,
``init_params``' frozen tree) trainable, takes the gradients with
``torch.autograd.grad`` (the tree's ``.grad`` fields stay unused) and
updates the parameters and the optimizer state in place.  Under
``cfg.remat == "full"`` each block is recomputed in the backward, so the
flash kernel launches twice an attention layer a step.

Under a mesh (``launch.mesh``; ``make_train_step(..., mesh=)``, the
mesh after ``opt`` to keep the port's positional order) each rank
holds its block of the global batch and of every parameter, and the
loss is the global batch's on every rank (``model.loss_fn``).  The
rule that makes each rank's gradients the global ones, as GSPMD gives
them in the reference:

  * every collective of the forward has its adjoint as its backward
    (``launch.mesh``: all-gather and reduce-scatter each other's, an
    all-reduce sum and an all-to-all their own), so autograd runs the
    chain rule across the ranks and each rank's backward gives the
    gradient of the one objective, summed over the ranks, with respect
    to the tensors it holds;
  * that objective is the loss once: the loss is the same on every
    rank, so each rank seeds its backward with 1 / (the mesh's ranks);
  * a parameter block is held by every rank along the axes its spec
    does not split, and each of those ranks used it on its own inputs
    (its batch block; under ``seq_sp`` or the ``attn_batch`` spread its
    sequence or batch block over ``model`` too), so its gradient is the
    sum of theirs: the step sums each leaf's gradient over every mesh
    axis its spec leaves out.  A norm scale, or a leaf the divisibility
    fallback keeps whole, is summed over ``model`` as well as the batch
    axes; a column block of ``wq`` over the batch axes only.

The global-norm clip takes each leaf's sum of squares over the ranks
its spec splits it over, and Adafactor's factored means likewise
(``optimizer.adafactor``), so a step over a model axis updates the
parameters as the one-process step does.

``grad_compression="int8"`` is the reference's error-feedback step:
``(params, opt_state, err, batch) -> (params, opt_state, err,
metrics)``, the global gradient plus the residual ``err`` quantized to
int8, its dequantized value mean-reduced over ``compression_axis``
(``dist.compression.compressed_psum_tree``) and the new residual
threaded to the next step (seed it with ``init_compression_state``).
As in the reference, the operands of that mean are equal on every rank
(the global gradient), and the wire carries fp32.  The reference
quantizes each leaf of its layer-stacked tree, one scale over all the
layers of a leaf (over the whole leaf, every block of it); the port
quantizes the same stacks (``optimizer.layer_groups``), the scale's
max taken over the ranks that split the leaf, so its int8 values and
scales are the reference's.  Without a mesh the
int8 step raises the reference's ValueError.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional

import torch

from repro_torch.dist.compression import (compressed_psum_tree,
                                          init_error_feedback)
from repro_torch.launch import mesh as _mesh
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models.config import ArchConfig
from repro_torch.train import optimizer as OPT


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    optimizer: str = "adamw"
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10000
    clip_norm: float = 1.0
    microbatch: int = 1          # grad-accumulation factor
    aux_weight: float = 0.01     # MoE load-balance loss weight
    weight_decay: float = 0.1
    grad_compression: str = "none"   # none | int8 (error-feedback psum)
    compression_axis: str = "data"   # mesh axis the compressed psum crosses


def lr_schedule(tc: TrainConfig, step) -> float:
    """Linear warmup to ``learning_rate``, then a cosine to a tenth of
    it at ``total_steps``."""
    step = float(step)
    warm = step / max(tc.warmup_steps, 1)
    prog = min(max((step - tc.warmup_steps)
                   / max(tc.total_steps - tc.warmup_steps, 1), 0.0), 1.0)
    cos = 0.5 * (1 + math.cos(math.pi * prog))
    return tc.learning_rate * min(warm, 1.0) * (0.1 + 0.9 * cos)


def make_optimizer(tc: TrainConfig) -> OPT.Optimizer:
    if tc.optimizer == "adamw":
        return OPT.adamw(weight_decay=tc.weight_decay)
    return OPT.adafactor(weight_decay=0.0)


def make_train_step(cfg: ArchConfig, tc: TrainConfig,
                    opt: Optional[OPT.Optimizer] = None,
                    mesh=None) -> Callable:
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics), or under ``grad_compression="int8"`` train_step(params,
    opt_state, err, batch) -> (params, opt_state, err, metrics).  batch:
    {tokens, labels[, enc_frames, extra_embeds]}, the global batch under
    a mesh; metrics: loss, nll, aux, grad_norm (before the clip) and
    lr."""
    if tc.grad_compression not in ("none", "int8"):
        raise ValueError(f"unknown grad_compression "
                         f"{tc.grad_compression!r}; use 'none' or 'int8'")
    if tc.grad_compression == "int8" and mesh is None:
        raise ValueError("grad_compression='int8' needs a mesh "
                         "(the psum axis lives on it)")
    opt = opt or make_optimizer(tc)

    def loss_of(params, batch):
        return M.loss_fn(cfg, params, batch["tokens"], batch["labels"],
                         mesh=mesh,
                         extra_embeds=batch.get("extra_embeds"),
                         enc_frames=batch.get("enc_frames"),
                         aux_weight=tc.aux_weight)

    def reduce_shares(grads, axes):
        """Each leaf's gradient summed over the axes its spec leaves out
        (``leaf_axes``)."""
        for k in list(grads):      # leaf by leaf: one transient copy
            grads[k] = _mesh.all_reduce(mesh, grads[k], axes[k][1])
        return grads

    def grads_of(params, batch):
        names, leaves = zip(*params.named_parameters())

        def one(b):
            loss, (nll, aux) = loss_of(params, b)
            # the loss is the same on every rank: seeding each with
            # 1 / ranks differentiates it once
            seed = (None if mesh is None else
                    torch.full_like(loss, 1.0 / mesh.size))
            gs = torch.autograd.grad(loss, leaves, grad_outputs=seed,
                                     allow_unused=True,
                                     materialize_grads=True)
            return loss.detach(), nll.detach(), aux.detach(), gs

        if tc.microbatch <= 1:
            loss, nll, aux, gs = one(batch)
            return loss, nll, aux, dict(zip(names, gs))

        # microbatch accumulation: equal splits of the leading dim, the
        # grads summed in fp32 and divided by the count, as the
        # reference's scan does
        B = batch["tokens"].shape[0]
        if B % tc.microbatch:
            raise ValueError(f"batch {B} does not split into "
                             f"{tc.microbatch} microbatches")
        n = B // tc.microbatch
        acc = [torch.zeros_like(p, dtype=torch.float32) for p in leaves]
        sums = torch.zeros(3, dtype=torch.float32,
                           device=batch["tokens"].device)
        for i in range(tc.microbatch):
            mb = {k: v[i * n:(i + 1) * n] for k, v in batch.items()}
            loss, nll, aux, gs = one(mb)
            for a, g in zip(acc, gs):
                a.add_(g)
            sums += torch.stack([loss, nll, aux]).to(torch.float32)
        inv = 1.0 / tc.microbatch
        loss, nll, aux = sums * inv
        return loss, nll, aux, {k: a.mul_(inv) for k, a in zip(names, acc)}

    def finish_step(grads, opt_state, params, loss, nll, aux, axes):
        norm = None if mesh is None else _global_norm(grads, axes, mesh)
        grads, gnorm = OPT.clip_by_global_norm(grads, tc.clip_norm, norm)
        lr = lr_schedule(tc, int(opt_state.count))
        kw = ({} if mesh is None else
              {"shards": {k: (mesh, a[2]) for k, a in axes.items()}})
        params, opt_state = opt.update(grads, opt_state, params, lr, **kw)
        metrics = {"loss": loss, "nll": nll, "aux": aux,
                   "grad_norm": gnorm, "lr": torch.tensor(lr)}
        return params, opt_state, metrics

    def step_axes():
        return None if mesh is None else leaf_axes(cfg, mesh)

    if tc.grad_compression == "int8":
        def train_step(params, opt_state, err, batch):
            params.requires_grad_(True)
            axes = step_axes()
            loss, nll, aux, grads = grads_of(params, batch)
            grads, err = _stacked_psum(reduce_shares(grads, axes),
                                       dict(err), mesh, tc.compression_axis,
                                       axes)
            params, opt_state, metrics = finish_step(
                grads, opt_state, params, loss, nll, aux, axes)
            return params, opt_state, err, metrics

        return train_step

    def train_step(params, opt_state, batch):
        params.requires_grad_(True)
        axes = step_axes()
        loss, nll, aux, grads = grads_of(params, batch)
        if mesh is not None:
            grads = reduce_shares(grads, axes)
        return finish_step(grads, opt_state, params, loss, nll, aux, axes)

    return train_step


def leaf_axes(cfg: ArchConfig, mesh) -> Dict[str, tuple]:
    """name -> (the mesh axes of more than one rank that split the
    leaf, those that hold it whole, the axes of each of its dims) under
    the active rules: its gradient is summed over the second."""
    out = {}
    for name, ns in M.param_specs(cfg, mesh).items():
        dims = tuple(L.axes_of(e) for e in ns.spec)
        split = tuple(a for d in dims for a in d if mesh.shape[a] > 1)
        whole = tuple(a for a in mesh.axis_names
                      if mesh.shape[a] > 1 and a not in split)
        out[name] = (split, whole, dims)
    return out


def _global_norm(grads, axes, mesh) -> torch.Tensor:
    """The 2-norm of the global gradient, every rank holding its blocks
    (each the same on the ranks that hold it): a leaf's sum of squares
    summed over the ranks that split it, one collective for the leaves
    split alike, then summed in the leaves' order."""
    sq = [torch.sum(torch.square(g.to(torch.float32)))
          for g in grads.values()]
    by_split: Dict[tuple, list] = {}
    for i, k in enumerate(grads):
        if axes[k][0]:
            by_split.setdefault(axes[k][0], []).append(i)
    for split, idx in by_split.items():
        red = _mesh.all_reduce(mesh, torch.stack([sq[i] for i in idx]),
                               split)
        for j, i in enumerate(idx):
            sq[i] = red[j]
    return torch.sqrt(sum(sq))


def _stacked_psum(grads, err, mesh, axis, axes):
    """``compressed_psum_tree`` over the reference's layer stacks: the
    leaves of each ``layer_groups`` group stacked, compressed as one
    leaf (its scale over every rank's block of it), and split back by
    name.  Group by group, each group's grads and residuals taken out of
    ``grads`` and ``err`` as it goes, so the transients are one
    group's."""
    out, new_err = {}, {}
    for members, stacked in OPT.layer_groups(grads).values():
        def take(tree):
            if stacked:
                return torch.stack([tree.pop(n) for n in members])
            return tree.pop(members[0])

        g, e = compressed_psum_tree(take(grads), take(err), mesh, axis,
                                    scale_axes=axes[members[0]][0])
        for i, n in enumerate(members):
            out[n], new_err[n] = (g[i], e[i]) if stacked else (g, e)
    return out, new_err


def init_compression_state(params) -> Dict[str, torch.Tensor]:
    """Zero error-feedback residuals for a grad_compression='int8' step
    (fp32, one a parameter): ``dist.compression.init_error_feedback``
    over the parameters by name."""
    return init_error_feedback(dict(OPT.named_leaves(params)))
