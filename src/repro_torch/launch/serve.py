"""Serving entry point of the port: initializes a model from a seed and
serves batched requests through the ServeEngine (prefill through the
flash attention kernel, then the decode loop).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma-2b
  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma-2b \\
      --reduced --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --arch deepseek-v3-671b --reduced --device cpu

It runs on ``cuda`` unless ``--device cpu`` is given.  The dense and
moe families are ported (mixtral-8x22b and deepseek-v3-671b among the
archs; at full size neither fits one 80 GB card: serve them with
``--reduced``); the others raise NotImplementedError naming ROADMAP.md
queue 1, item 17.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.configs import ARCH_IDS, get_config, get_reduced_config
from repro_torch.models import model as M
from repro_torch.serve import GenerationConfig, ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="gemma-2b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=24)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    cfg = get_reduced_config(args.arch) if args.reduced \
        else get_config(args.arch)
    if not cfg.has_decoder:
        raise SystemExit(f"{cfg.name} has no decoder")
    params = M.init_params(cfg, seed=0, device=args.device)

    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab,
                           (args.batch, args.prompt_len)).astype(np.int32)
    engine = ServeEngine(cfg, params,
                         max_len=args.prompt_len + args.max_new + 8)
    gen = GenerationConfig(max_new_tokens=args.max_new,
                           temperature=args.temperature)
    t0 = time.time()
    out = engine.generate(prompts, gen)
    dt = time.time() - t0
    n_tok = out.size
    print(f"[serve] {cfg.name} on {engine.device}: generated {n_tok} tokens "
          f"for {args.batch} requests in {dt:.2f}s ({n_tok/dt:.1f} tok/s)")
    print("[serve] first request tokens:", out[0][:16].tolist())
    return out


if __name__ == "__main__":
    main()
