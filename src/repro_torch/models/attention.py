"""GQA / MQA attention (RoPE, optional sliding window): the GQA part of
the reference's ``repro.models.attention``.

``gqa_train`` (train and prefill) calls the port's ``flash_attention``
op, which launches the hand-written CUDA kernel for tensors on the card
(the reference's model forces its plain path with ``use_pallas=False``;
the function computed is the same).  ``gqa_decode`` stays plain torch
ops over the static cache, as in the reference; it writes the new
key/value into the cache in place (the reference returns an updated
copy), so a decode step allocates no second cache.

MLA (DeepSeek's latent attention) is not ported: a config with ``mla``
raises NotImplementedError in ``models/model.py``.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models import layers as L
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import PAb

NOT_PORTED = ("is not ported yet: ROADMAP.md queue 1, item 17 (the LM "
              "substrate) lists it")


def gqa_ab(cfg: ArchConfig):
    d, H, Hkv = cfg.d_model, cfg.n_heads, cfg.n_kv_heads
    hd = cfg.resolved_head_dim
    s = d ** -0.5
    return {
        "wq": PAb((d, H, hd), ("embed", "heads", None), "normal", s),
        "wk": PAb((d, Hkv, hd), ("embed", "kv", None), "normal", s),
        "wv": PAb((d, Hkv, hd), ("embed", "kv", None), "normal", s),
        "wo": PAb((H, hd, d), ("heads", None, "embed"), "normal",
                  (H * hd) ** -0.5),
    }


def gqa_train(cfg: ArchConfig, params, x, positions, causal: bool = True,
              return_kv: bool = False):
    """Full-sequence self-attention (train / prefill). x: (B,S,D)."""
    cd = x.dtype
    q = torch.einsum("bsd,dhk->bhsk", x, params["wq"].to(cd))
    k = torch.einsum("bsd,dhk->bhsk", x, params["wk"].to(cd))
    v = torch.einsum("bsd,dhk->bhsk", x, params["wv"].to(cd))
    q = L.apply_rope(q, positions, cfg.rope_theta, cfg.rope_fraction)
    k = L.apply_rope(k, positions, cfg.rope_theta, cfg.rope_fraction)
    out = flash_attention(q, k, v, causal=causal, window=cfg.window)
    proj = torch.einsum("bhsk,hkd->bsd", out, params["wo"].to(cd))
    if return_kv:
        return proj, (k, v)
    return proj


class KVCache(NamedTuple):
    k: torch.Tensor   # (B, Hkv, Smax, hd), or (L, B, Hkv, Smax, hd) stacked
    v: torch.Tensor


def gqa_init_cache(cfg: ArchConfig, batch, max_len, dtype,
                   device=None) -> KVCache:
    shape = (batch, cfg.n_kv_heads, max_len, cfg.resolved_head_dim)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device))


def gqa_decode(cfg: ArchConfig, params, x, cache: KVCache, positions):
    """One-token decode. x: (B,1,D); positions: (B,1) absolute position,
    the same for every row.  Writes the new key/value at that position
    of ``cache`` in place and returns (proj, cache)."""
    B = x.shape[0]
    cd = x.dtype
    q = torch.einsum("bsd,dhk->bhsk", x, params["wq"].to(cd))
    k_new = torch.einsum("bsd,dhk->bhsk", x, params["wk"].to(cd))
    v_new = torch.einsum("bsd,dhk->bhsk", x, params["wv"].to(cd))
    q = L.apply_rope(q, positions, cfg.rope_theta, cfg.rope_fraction)
    k_new = L.apply_rope(k_new, positions, cfg.rope_theta,
                         cfg.rope_fraction)

    pos = positions[0, :1].long()              # (1,), stays on the device
    k, v = cache.k, cache.v
    k.index_copy_(2, pos, k_new.to(k.dtype))
    v.index_copy_(2, pos, v_new.to(v.dtype))

    Hq, Hkv = cfg.n_heads, cfg.n_kv_heads
    group = Hq // Hkv
    hd = cfg.resolved_head_dim
    Smax = k.shape[2]
    qg = q.reshape(B, Hkv, group, hd)
    scores = torch.einsum("bhgk,bhsk->bhgs", qg, k.to(cd)) / torch.tensor(
        math.sqrt(hd), dtype=cd, device=x.device)
    idx = torch.arange(Smax, device=x.device)
    mask = idx[None, :] <= pos[:, None]
    if cfg.window is not None:
        mask &= idx[None, :] > pos[:, None] - cfg.window
    scores = torch.where(mask[None, None], scores.to(torch.float32),
                         torch.tensor(-1e30, device=x.device))
    w = torch.softmax(scores, dim=-1).to(cd)
    out = torch.einsum("bhgs,bhsk->bhgk", w, v.to(cd))
    out = out.reshape(B, Hq, 1, hd).transpose(1, 2)          # (B,1,H,hd)
    proj = torch.einsum("bshk,hkd->bsd", out, params["wo"].to(cd))
    return proj, cache
