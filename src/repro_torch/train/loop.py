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
holds its block of the global batch and the loss is the global
batch's (``model.loss_fn``); each rank's gradient is its share, and
the step sums the shares over the batch axes, so every rank holds the
gradient of the global batch, as GSPMD gives it in the reference.  A
model axis of more than one rank is refused: gradients through its
collectives are ROADMAP.md queue 1, item 17.10.

``grad_compression="int8"`` is the reference's error-feedback step:
``(params, opt_state, err, batch) -> (params, opt_state, err,
metrics)``, the global gradient plus the residual ``err`` quantized to
int8, its dequantized value mean-reduced over ``compression_axis``
(``dist.compression.compressed_psum_tree``) and the new residual
threaded to the next step (seed it with ``init_compression_state``).
As in the reference, the operands of that mean are equal on every rank
(the global gradient), and the wire carries fp32.  The reference
quantizes each leaf of its layer-stacked tree, one scale over all the
layers of a leaf; the port quantizes the same stacks
(``optimizer.layer_groups``), so its int8 values and scales are the
reference's.  Without a mesh the
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
    if mesh is not None and mesh.count("model") > 1:
        raise NotImplementedError(
            "a train step over a model axis of more than one rank: "
            "gradients through its collectives are ROADMAP.md queue 1, "
            "item 17.10")
    opt = opt or make_optimizer(tc)

    def loss_of(params, batch):
        return M.loss_fn(cfg, params, batch["tokens"], batch["labels"],
                         mesh=mesh,
                         extra_embeds=batch.get("extra_embeds"),
                         enc_frames=batch.get("enc_frames"),
                         aux_weight=tc.aux_weight)

    def reduce_shares(grads, batch):
        """The sum of every rank's share over the batch axes."""
        if mesh is None:
            return grads
        B, S = batch["tokens"].shape
        axes = L.Placement.between_blocks(mesh, B, S, cfg.d_model).batch
        for k in list(grads):      # leaf by leaf: one transient copy
            grads[k] = _mesh.all_reduce(mesh, grads[k], axes)
        return grads

    def grads_of(params, batch):
        names, leaves = zip(*params.named_parameters())

        def one(b):
            loss, (nll, aux) = loss_of(params, b)
            gs = torch.autograd.grad(loss, leaves, allow_unused=True,
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

    def finish_step(grads, opt_state, params, loss, nll, aux):
        grads, gnorm = OPT.clip_by_global_norm(grads, tc.clip_norm)
        lr = lr_schedule(tc, int(opt_state.count))
        params, opt_state = opt.update(grads, opt_state, params, lr)
        metrics = {"loss": loss, "nll": nll, "aux": aux,
                   "grad_norm": gnorm, "lr": torch.tensor(lr)}
        return params, opt_state, metrics

    if tc.grad_compression == "int8":
        def train_step(params, opt_state, err, batch):
            params.requires_grad_(True)
            loss, nll, aux, grads = grads_of(params, batch)
            grads, err = _stacked_psum(reduce_shares(grads, batch),
                                       dict(err), mesh, tc.compression_axis)
            params, opt_state, metrics = finish_step(
                grads, opt_state, params, loss, nll, aux)
            return params, opt_state, err, metrics

        return train_step

    def train_step(params, opt_state, batch):
        params.requires_grad_(True)
        loss, nll, aux, grads = grads_of(params, batch)
        return finish_step(reduce_shares(grads, batch), opt_state, params,
                           loss, nll, aux)

    return train_step


def _stacked_psum(grads, err, mesh, axis):
    """``compressed_psum_tree`` over the reference's layer stacks: the
    leaves of each ``layer_groups`` group stacked, compressed as one
    leaf, and split back by name.  Group by group, each group's grads
    and residuals taken out of ``grads`` and ``err`` as it goes, so the
    transients are one group's."""
    out, new_err = {}, {}
    for members, stacked in OPT.layer_groups(grads).values():
        def take(tree):
            if stacked:
                return torch.stack([tree.pop(n) for n in members])
            return tree.pop(members[0])

        g, e = compressed_psum_tree(take(grads), take(err), mesh, axis)
        for i, n in enumerate(members):
            out[n], new_err[n] = (g[i], e[i]) if stacked else (g, e)
    return out, new_err


def init_compression_state(params) -> Dict[str, torch.Tensor]:
    """Zero error-feedback residuals for a grad_compression='int8' step
    (fp32, one a parameter): ``dist.compression.init_error_feedback``
    over the parameters by name."""
    return init_error_feedback(dict(OPT.named_leaves(params)))
