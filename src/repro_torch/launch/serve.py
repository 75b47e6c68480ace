"""Serving entry point of the port: initializes a model from a seed and
serves batched requests through the ServeEngine (prefill through the
flash attention kernel and the chunked SSD, then the decode loop).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma-2b
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-780m
  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma-2b \\
      --reduced --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --arch jamba-1.5-large-398b --reduced --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-small
  PYTHONPATH=src python -m repro_torch.launch.serve --arch internvl2-1b

It runs on ``cuda`` unless ``--device cpu`` is given.  Every family of
``configs/`` serves; mixtral-8x22b, deepseek-v3-671b and
jamba-1.5-large-398b do not fit one 80 GB card at full size: serve them
with ``--reduced``.  A prompt longer than one SSD chunk must be a
multiple of it (``--prompt-len``; 256 at full size, 32 reduced).  The
front ends are the reference's stubs, drawn from the seed as it draws
them: whisper-small takes (batch, enc_seq, d_model) frames, internvl2-1b
(batch, vis_seq, d_model) patch embeddings, which the cache
(``max_len``) counts.
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
    kw = {}
    if cfg.family == "encdec":
        kw["enc_frames"] = rng.standard_normal(
            (args.batch, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        kw["extra_embeds"] = rng.standard_normal(
            (args.batch, cfg.vis_seq, cfg.d_model)).astype(np.float32)
    patches = cfg.vis_seq if cfg.family == "vlm" else 0
    engine = ServeEngine(cfg, params, max_len=patches + args.prompt_len
                         + args.max_new + 8)
    gen = GenerationConfig(max_new_tokens=args.max_new,
                           temperature=args.temperature)
    t0 = time.time()
    out = engine.generate(prompts, gen, **kw)
    dt = time.time() - t0
    n_tok = out.size
    print(f"[serve] {cfg.name} on {engine.device}: generated {n_tok} tokens "
          f"for {args.batch} requests in {dt:.2f}s ({n_tok/dt:.1f} tok/s)")
    print("[serve] first request tokens:", out[0][:16].tolist())
    return out


if __name__ == "__main__":
    main()
