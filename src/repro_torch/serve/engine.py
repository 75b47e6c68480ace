"""Batched LM serving: prefill once, decode step by step with a
static-shape KV cache; greedy or temperature sampling; per-request stop.
Port of the reference's ``repro.serve.engine``.

It serves the families ``models.model`` ports: dense (Gemma-2B and its
kin) and moe (mixtral-8x22b, deepseek-v3-671b with MLA).  The reference
``jit``s its prefill and decode step; here both run eagerly (no CUDA
graphs yet), on the device of the parameters.  Prefill goes through the
port's flash attention op (the hand-written kernel on the card); decode
is plain torch ops over the cache (KV, or MLA's latent), updated in
place.
Temperature sampling draws from a ``torch.Generator`` seeded with
``GenerationConfig.seed`` (the reference's ``jax.random`` stream cannot
be reproduced; greedy decoding is the same in both packages).

``ServeEngine.timing`` holds the host seconds of the last ``generate``:
``prefill_s`` (up to the first sampled token, the device synchronized)
and ``decode_s`` over ``decode_steps`` steps.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.models import model as M
from repro_torch.models.config import ArchConfig


@dataclasses.dataclass
class GenerationConfig:
    max_new_tokens: int = 32
    temperature: float = 0.0          # 0 => greedy
    eos_id: Optional[int] = None
    seed: int = 0


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class ServeEngine:
    def __init__(self, cfg: ArchConfig, params, max_len: int = 256):
        self.cfg = cfg
        self.params = params
        self.max_len = max_len
        self.device = params["embed"]["table"].device
        self.timing: dict = {}

    @torch.no_grad()
    def generate(self, tokens: np.ndarray, gen: GenerationConfig,
                 enc_frames=None, extra_embeds=None) -> np.ndarray:
        """tokens: (B, S) prompt. Returns (B, max_new_tokens) int32, fewer
        columns if every request stopped at ``eos_id``."""
        if enc_frames is not None or extra_embeds is not None:
            raise NotImplementedError(
                "encoder frames and vision embeddings (the encdec and vlm "
                "families) are not ported yet: ROADMAP.md queue 1, item 17")
        B, S = tokens.shape
        if S + gen.max_new_tokens > self.max_len:
            raise ValueError(f"prompt {S} + {gen.max_new_tokens} new tokens "
                             f"exceed max_len {self.max_len}")
        t0 = time.perf_counter()
        prompt = torch.as_tensor(np.asarray(tokens), device=self.device)
        logits, cache, pos = M.prefill(self.cfg, self.params, prompt,
                                       self.max_len)
        rng = torch.Generator(device=self.device).manual_seed(gen.seed)
        cur = self._sample(logits[:, -1], gen, rng)
        _sync(self.device)
        t1 = time.perf_counter()
        out = []
        done = np.zeros(B, bool)
        steps = 0
        for i in range(gen.max_new_tokens):
            out.append(cur)
            if gen.eos_id is not None:
                done |= cur[:, 0].cpu().numpy() == gen.eos_id
                if done.all():
                    break
            if i + 1 == gen.max_new_tokens:
                break                  # the last token needs no decode
            positions = torch.full((B, 1), pos + i, dtype=torch.int32,
                                   device=self.device)
            logits, cache = M.decode_step(self.cfg, self.params, cache, cur,
                                          positions)
            cur = self._sample(logits[:, -1], gen, rng)
            steps += 1
        result = torch.cat(out, dim=1).cpu().numpy().astype(np.int32)
        self.timing = {"prefill_s": t1 - t0,
                       "decode_s": time.perf_counter() - t1,
                       "decode_steps": steps}
        return result

    @staticmethod
    def _sample(logits, gen: GenerationConfig, rng: torch.Generator):
        if gen.temperature <= 0:
            return torch.argmax(logits, dim=-1)[:, None].to(torch.int32)
        probs = torch.softmax(logits.to(torch.float32) / gen.temperature,
                              dim=-1)
        return torch.multinomial(probs, 1, generator=rng).to(torch.int32)
