"""Deterministic synthetic token pipeline.  Port of the reference's
``repro.data.tokens``.

Stateless by step: ``batch_at(step)`` draws from a ``torch.Generator``
on the host seeded from (seed, step), so a resume at step k reproduces
the stream with no data-loader state in checkpoints, no skipped or
replayed batches, and the same batches on any device.  The reference
draws from ``jax.random`` streams, which torch cannot reproduce: the
process is the same (a start in [0, vocab), drifts in [-3, 3], the
tokens their cumsum mod vocab, the labels the tokens shifted by one
with -100 last), the tokens are not.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.config import ArchConfig


class SyntheticTokens:
    """Markov-ish synthetic LM data: structured enough that loss falls.
    Batches land on ``device`` (default: cuda)."""

    def __init__(self, cfg: ArchConfig, batch: int, seq: int, seed: int = 0,
                 device: DeviceLike = None):
        self.cfg = cfg
        self.batch = batch
        self.seq = seq
        self.seed = seed
        self.device = resolve_device(device)

    def _generator(self, step: int) -> torch.Generator:
        key = np.random.SeedSequence([self.seed, step]).generate_state(
            1, np.uint64)[0]
        return torch.Generator().manual_seed(int(key))

    def batch_at(self, step: int) -> dict:
        gen = self._generator(step)
        B, S, v = self.batch, self.seq, self.cfg.vocab
        # piecewise-linear token process: next ~ prev + small step (mod v)
        start = torch.randint(0, v, (B, 1), generator=gen)
        drift = torch.randint(-3, 4, (B, S), generator=gen)
        tokens = ((start + torch.cumsum(drift, dim=1)) % v).to(torch.int32)
        labels = torch.roll(tokens, -1, dims=1)
        labels[:, -1] = -100
        out = {"tokens": tokens, "labels": labels}
        if self.cfg.family == "encdec":
            out["enc_frames"] = torch.randn(
                (B, self.cfg.enc_seq, self.cfg.d_model), generator=gen)
        if self.cfg.family == "vlm":
            out["extra_embeds"] = torch.randn(
                (B, self.cfg.vis_seq, self.cfg.d_model), generator=gen)
        return {k: t.to(self.device) for k, t in out.items()}


def batch_specs(cfg: ArchConfig, batch: int, seq: int,
                dtype=torch.float32) -> dict:
    """Meta-device stand-ins for one training batch: shapes and dtypes,
    no storage."""
    def meta(shape, dt):
        return torch.empty(shape, dtype=dt, device="meta")

    out = {"tokens": meta((batch, seq), torch.int32),
           "labels": meta((batch, seq), torch.int32)}
    if cfg.family == "encdec":
        out["enc_frames"] = meta((batch, cfg.enc_seq, cfg.d_model), dtype)
    if cfg.family == "vlm":
        out["extra_embeds"] = meta((batch, cfg.vis_seq, cfg.d_model), dtype)
    return out
