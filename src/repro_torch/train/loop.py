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

The reference's int8 error-feedback gradient compression is a psum
over a mesh axis; the port has no mesh yet, so
``grad_compression="int8"`` raises (ROADMAP.md queue 1, item 17.7).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional

import torch

from repro_torch.models import model as M
from repro_torch.models.config import ArchConfig
from repro_torch.train import optimizer as OPT

COMPRESSION_NOT_PORTED = (
    "grad_compression='int8' is an error-feedback psum over a mesh axis, "
    "and the mesh is not ported yet: ROADMAP.md queue 1, item 17.7 "
    "(dist/compression.py)")


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
    grad_compression: str = "none"   # none | int8 (needs a mesh)
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
                    opt: Optional[OPT.Optimizer] = None) -> Callable:
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics).  batch: {tokens, labels[, enc_frames, extra_embeds]};
    metrics: loss, nll, aux, grad_norm (before the clip) and lr."""
    if tc.grad_compression == "int8":
        raise ValueError(COMPRESSION_NOT_PORTED)
    if tc.grad_compression != "none":
        raise ValueError(f"unknown grad_compression "
                         f"{tc.grad_compression!r}; use 'none' or 'int8'")
    opt = opt or make_optimizer(tc)

    def loss_of(params, batch):
        return M.loss_fn(cfg, params, batch["tokens"], batch["labels"],
                         extra_embeds=batch.get("extra_embeds"),
                         enc_frames=batch.get("enc_frames"),
                         aux_weight=tc.aux_weight)

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

    def train_step(params, opt_state, batch):
        params.requires_grad_(True)
        loss, nll, aux, grads = grads_of(params, batch)
        grads, gnorm = OPT.clip_by_global_norm(grads, tc.clip_norm)
        lr = lr_schedule(tc, int(opt_state.count))
        params, opt_state = opt.update(grads, opt_state, params, lr)
        metrics = {"loss": loss, "nll": nll, "aux": aux,
                   "grad_norm": gnorm, "lr": torch.tensor(lr)}
        return params, opt_state, metrics

    return train_step


def init_compression_state(params) -> Dict[str, torch.Tensor]:
    """Zero error-feedback residuals for a grad_compression='int8' step
    (fp32, one a parameter), as the reference's
    ``dist.compression.init_error_feedback`` gives them."""
    return {n: torch.zeros_like(p, dtype=torch.float32)
            for n, p in OPT.named_leaves(params).items()}
