"""Batched LM serving: prefill once, decode step by step with a
static-shape cache; greedy or temperature sampling; per-request stop.
Port of the reference's ``repro.serve.engine``.

It serves every family of ``configs/``: dense (Gemma-2B and its kin),
moe (mixtral-8x22b, deepseek-v3-671b with MLA), ssm (mamba2-780m),
hybrid (jamba-1.5-large-398b), encdec (whisper-small: ``generate``
takes the encoder's stub frames, ``enc_frames``) and vlm (internvl2-1b:
the stub patch embeddings, ``extra_embeds``, prepended to each prompt).
The reference ``jit``s its prefill
and decode step; here both run eagerly (no CUDA graphs yet), on the
device of the parameters.  Prefill goes through the port's flash
attention op (the hand-written kernel on the card) and the chunked SSD
(plain torch products, as the reference's einsums); decode is plain
torch ops over the cache (KV, MLA's latent, or the Mamba conv window
and recurrent state), updated in place, but for whisper's
cross-attention, which runs the flash op over the encoder's output at
every step, as the reference does.
Temperature sampling draws from a ``torch.Generator`` seeded with
``GenerationConfig.seed`` (the reference's ``jax.random`` stream cannot
be reproduced; greedy decoding is the same in both packages).

Under a mesh (``ServeEngine(..., mesh=)``, the dense and moe families)
every rank runs the same ``generate`` on the global prompts: the
sharded ``prefill`` / ``decode_step``, the greedy pick across the
vocabulary blocks (``layers.vocab_argmax``; a temperature samples from
the logits gathered over them), and the picks of each rank's batch
block gathered, so every rank returns every request's tokens.

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

from repro_torch.dist.sharding import NamedSharding
from repro_torch.launch import mesh as _mesh
from repro_torch.models import layers as L
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
    def __init__(self, cfg: ArchConfig, params, max_len: int = 256,
                 mesh=None):
        self.cfg = cfg
        self.params = params
        self.max_len = max_len
        self.mesh = mesh
        self.device = params["embed"]["table"].device
        self.timing: dict = {}

    @torch.no_grad()
    def generate(self, tokens: np.ndarray, gen: GenerationConfig,
                 enc_frames=None, extra_embeds=None) -> np.ndarray:
        """tokens: (B, S) prompt; enc_frames (B, enc_seq, d_model) for an
        encdec model, extra_embeds (B, P, d_model) patch embeddings for a
        vlm model (numpy arrays or tensors).  Returns (B, max_new_tokens)
        int32, fewer columns if every request stopped at ``eos_id``.  The
        cache must hold P + S + max_new_tokens positions (P = 0 without
        extra_embeds), else a ValueError."""
        B, S = tokens.shape
        P = 0 if extra_embeds is None else extra_embeds.shape[1]
        if P + S + gen.max_new_tokens > self.max_len:
            raise ValueError(f"{P} patches + prompt {S} + "
                             f"{gen.max_new_tokens} new tokens exceed "
                             f"max_len {self.max_len}")
        t0 = time.perf_counter()
        prompt = torch.as_tensor(np.asarray(tokens), device=self.device)
        kw = {name: torch.as_tensor(a, device=self.device)
              for name, a in (("enc_frames", enc_frames),
                              ("extra_embeds", extra_embeds))
              if a is not None}
        logits, cache, pos = M.prefill(self.cfg, self.params, prompt,
                                       self.max_len, mesh=self.mesh, **kw)
        rng = torch.Generator(device=self.device).manual_seed(gen.seed)
        cur = self._pick(logits[:, -1], gen, rng, B)
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
                                          positions, self.mesh)
            cur = self._pick(logits[:, -1], gen, rng, B)
            steps += 1
        result = torch.cat(out, dim=1).cpu().numpy().astype(np.int32)
        self.timing = {"prefill_s": t1 - t0,
                       "decode_s": time.perf_counter() - t1,
                       "decode_steps": steps}
        return result

    def _pick(self, logits, gen: GenerationConfig, rng: torch.Generator,
              B: int):
        """The next token of each request, (B, 1) int32: under a mesh
        from this rank's blocks of the logits, gathered to every rank."""
        if self.mesh is None:
            return self._sample(logits, gen, rng)
        table = M._table_sharding(self.cfg, self.mesh)
        if gen.temperature <= 0:
            cur = L.vocab_argmax(logits, table)[:, None].to(torch.int32)
        else:
            whole = NamedSharding(self.mesh, (None, table.spec[0] if
                                              table.spec else None))
            cur = self._sample(whole.gather(logits), gen, rng)
        return _mesh.all_gather(self.mesh, cur, L.Placement.between_blocks(
            self.mesh, B, 1, self.cfg.d_model).batch, 0)

    @staticmethod
    def _sample(logits, gen: GenerationConfig, rng: torch.Generator):
        if gen.temperature <= 0:
            return torch.argmax(logits, dim=-1)[:, None].to(torch.int32)
        probs = torch.softmax(logits.to(torch.float32) / gen.temperature,
                              dim=-1)
        return torch.multinomial(probs, 1, generator=rng).to(torch.int32)
