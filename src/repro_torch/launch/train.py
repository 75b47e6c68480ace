"""Training entry point of the port: the reference's
``repro.launch.train`` loop (data pipeline, train step,
checkpoint / resume, preemption guard, straggler watchdog).

  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma-2b \\
      --reduced --device cpu --steps 200 --batch 8 --seq 64
  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma-2b \\
      --reduced --steps 30 --ckpt-dir /tmp/ck --resume

It runs on ``cuda`` unless ``--device cpu`` is given, from parameters
drawn from seed 0.  Checkpoints go to ``<ckpt-dir>/<config name>``
(every ``--save-every`` steps, on preemption, and at the end);
``--resume`` continues from the latest one.  The log goes to
``experiments/train_<config name>.json`` under the working directory.
At full size on one card, Gemma-2B with AdamW takes some 40 GB of
parameters, gradients and moments; the MoE models and jamba do not fit.
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import torch

from repro_torch.configs import ARCH_IDS, get_config, get_reduced_config
from repro_torch.data import SyntheticTokens
from repro_torch.models import model as M
from repro_torch.train import (CheckpointManager, PreemptionGuard,
                               StepWatchdog, TrainConfig, make_optimizer,
                               make_train_step)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="gemma-2b")
    ap.add_argument("--reduced", action="store_true",
                    help="tiny same-family config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--optimizer", default="adamw",
                    choices=["adamw", "adafactor"])
    ap.add_argument("--microbatch", type=int, default=1)
    ap.add_argument("--ckpt-dir", default="checkpoints")
    ap.add_argument("--save-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    cfg = get_reduced_config(args.arch) if args.reduced \
        else get_config(args.arch)
    tc = TrainConfig(optimizer=args.optimizer, learning_rate=args.lr,
                     warmup_steps=max(args.steps // 20, 5),
                     total_steps=args.steps, microbatch=args.microbatch)
    opt = make_optimizer(tc)

    params = M.init_params(cfg, seed=0, device=args.device)
    params.requires_grad_(True)
    opt_state = opt.init(params)
    device = params["embed"]["table"].device
    n_par = sum(p.numel() for p in params.parameters())
    print(f"[train] {cfg.name} ({'reduced' if args.reduced else 'full'}): "
          f"{n_par/1e6:.1f}M params on {device}")

    data = SyntheticTokens(cfg, batch=args.batch, seq=args.seq,
                           device=device)
    step_fn = make_train_step(cfg, tc, opt=opt)

    mgr = CheckpointManager(Path(args.ckpt_dir) / cfg.name, keep=3)
    start = 0
    if args.resume:
        latest = mgr.latest()
        if latest is not None:
            (params, opt_state), _ = mgr.restore(latest, (params, opt_state))
            start = latest
            print(f"[train] resumed from step {latest}")

    guard = PreemptionGuard()
    watchdog = StepWatchdog()
    log = []
    t_start = time.time()
    for step in range(start, args.steps):
        t0 = time.time()
        params, opt_state, metrics = step_fn(params, opt_state,
                                             data.batch_at(step))
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        dt = time.time() - t0
        watchdog.record(step, dt)
        if step % args.log_every == 0 or step == args.steps - 1:
            m = {k: float(v) for k, v in metrics.items()}
            tokens_s = args.batch * args.seq / dt
            print(f"[train] step {step:5d} loss {m['loss']:.4f} "
                  f"nll {m['nll']:.4f} gnorm {m['grad_norm']:.3f} "
                  f"lr {m['lr']:.2e} {tokens_s:,.0f} tok/s")
            log.append({"step": step, **m, "tokens_per_s": tokens_s})
        if (step + 1) % args.save_every == 0 or guard.should_stop:
            mgr.save(step + 1, (params, opt_state))
            if guard.should_stop:
                print("[train] preemption requested: checkpointed, exiting")
                break
    guard.restore()

    mgr.save(args.steps, (params, opt_state))
    out = {"config": cfg.name, "steps": args.steps, "start_step": start,
           "wall_s": time.time() - t_start, "log": log,
           "stragglers": watchdog.straggler_steps}
    Path("experiments").mkdir(exist_ok=True)
    with open(f"experiments/train_{cfg.name}.json", "w") as f:
        json.dump(out, f, indent=1)
    if log:
        print(f"[train] done in {out['wall_s']:.1f}s; "
              f"final loss {log[-1]['loss']:.4f}")
    return out


if __name__ == "__main__":
    main()
