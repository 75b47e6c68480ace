"""The plain versions of flash attention: the port of the reference's
``kernels/flash_attention/ref.py``.

  attention_ref          materializes the (Sq, Sk) scores in q's dtype,
                         divides by sqrt(D) in q's dtype, and maps q head
                         h to kv head h // group; the oracle of the tests.
  attention_ref_chunked  walks query chunks of about 512 rows with fp32
                         scores and ``softmax(...).to(v.dtype)``: peak
                         memory O(chunk * Sk).  The reference reshapes Sq
                         into Sq // 512 equal chunks and raises where they
                         do not divide Sq (S = 1025, for one); here the
                         chunks have the reference's size and the last
                         one is shorter, so any Sq is right.

q is (B, Hq, Sq, D) and k, v are (B, Hkv, Sk, D) with Hq % Hkv == 0;
the result is (B, Hq, Sq, Dv).
"""
from __future__ import annotations

import math
from typing import Optional

import torch


def _mask(qi: torch.Tensor, ki: torch.Tensor, causal: bool,
          window: Optional[int]) -> torch.Tensor:
    mask = torch.ones((qi.shape[0], ki.shape[0]), dtype=torch.bool,
                      device=qi.device)
    if causal:
        mask &= ki[None, :] <= qi[:, None]
    if window is not None:
        mask &= ki[None, :] > qi[:, None] - window
    return mask


def attention_ref(q, k, v, causal: bool = True,
                  window: Optional[int] = None) -> torch.Tensor:
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    group = Hq // Hkv
    kk = torch.repeat_interleave(k, group, dim=1)
    vv = torch.repeat_interleave(v, group, dim=1)
    scores = torch.einsum("bhqd,bhkd->bhqk", q, kk) / torch.tensor(
        math.sqrt(D), dtype=q.dtype, device=q.device)
    mask = _mask(torch.arange(Sq, device=q.device),
                 torch.arange(Sk, device=q.device), causal, window)
    scores = torch.where(mask[None, None], scores,
                         torch.tensor(float("-inf"), dtype=scores.dtype,
                                      device=q.device))
    w = torch.nan_to_num(torch.exp(
        scores - torch.amax(scores, dim=-1, keepdim=True)))
    w = w / torch.clamp(torch.sum(w, dim=-1, keepdim=True), min=1e-30)
    return torch.einsum("bhqk,bhkd->bhqd", w.to(v.dtype), vv)


def attention_ref_chunked(q, k, v, causal: bool = True,
                          window: Optional[int] = None,
                          q_chunk: int = 512) -> torch.Tensor:
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    Dv = v.shape[-1]                  # MLA: value dim != qk dim
    group = Hq // Hkv
    qc = Sq // max(Sq // q_chunk, 1)  # the reference's chunk size
    scale = 1.0 / torch.tensor(math.sqrt(D), dtype=q.dtype, device=q.device)
    ki = torch.arange(Sk, device=q.device)
    out = []
    for s0 in range(0, Sq, max(qc, 1)):
        rows = min(qc, Sq - s0)
        q_blk = q[:, :, s0:s0 + rows].reshape(B, Hkv, group, rows, D)
        s = torch.einsum("bhgqd,bhkd->bhgqk", q_blk, k) * scale
        mask = _mask(torch.arange(s0, s0 + rows, device=q.device), ki,
                     causal, window)
        s = torch.where(mask[None, None, None], s.to(torch.float32),
                        torch.tensor(-1e30, device=q.device))
        p = torch.softmax(s, dim=-1).to(v.dtype)
        o = torch.einsum("bhgqk,bhkd->bhgqd", p, v)
        out.append(o.reshape(B, Hq, rows, Dv))
    return torch.cat(out, dim=2)
