"""Attention variants: GQA / MQA (RoPE, optional sliding window) and
DeepSeek-style MLA (multi-head latent attention) with an absorbed
latent-cache decode.  Port of the reference's ``repro.models.attention``.

``gqa_train`` and ``mla_train`` (train and prefill) call the port's
``flash_attention`` op, which launches the hand-written CUDA kernel for
tensors on the card (the reference's model forces its plain path with
``use_pallas=False``; the function computed is the same).  MLA's value
head dim (``v_dim``) is narrower than its q/k head dim (``nope_dim +
rope_dim``); the op takes that.  ``gqa_decode`` and ``mla_decode`` stay
plain torch ops over the static cache, as in the reference; they write
the new key/value (or latent) into the cache in place (the reference
returns an updated copy), so a decode step allocates no second cache.

The reference's ``gqa_cache_abstract`` / ``mla_cache_abstract`` and
``*_cache_logical`` serve its dry run and its sharding (ROADMAP.md
queue 1, items 17.9 and 17.7) and are not ported yet.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models import layers as L
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import PAb


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
              kv_override=None, return_kv: bool = False):
    """Full-sequence attention (train / prefill). x: (B,S,D).

    kv_override: (B, Sk, D) memory (whisper's encoder output) that k and
    v are projected from instead of x: cross-attention, neither q nor k
    rotated; the caller passes ``causal=False``."""
    cd = x.dtype
    kv_src = x if kv_override is None else kv_override
    q = torch.einsum("bsd,dhk->bhsk", x, params["wq"].to(cd))
    k = torch.einsum("bsd,dhk->bhsk", kv_src, params["wk"].to(cd))
    v = torch.einsum("bsd,dhk->bhsk", kv_src, params["wv"].to(cd))
    if kv_override is None:            # self-attention: rotate q and k
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


# ---------------------------------------------------------------- MLA

def mla_ab(cfg: ArchConfig):
    d, H = cfg.d_model, cfg.n_heads
    m = cfg.mla
    s = d ** -0.5
    return {
        "wq_a": PAb((d, m.q_lora_rank), ("embed", "latent"), "normal", s),
        "q_norm": L.rmsnorm_ab(m.q_lora_rank),
        "wq_b": PAb((m.q_lora_rank, H, m.nope_dim + m.rope_dim),
                    ("latent", "heads", None), "normal", m.q_lora_rank ** -0.5),
        "wkv_a": PAb((d, m.kv_lora_rank + m.rope_dim), ("embed", "latent"),
                     "normal", s),
        "kv_norm": L.rmsnorm_ab(m.kv_lora_rank),
        "wk_b": PAb((m.kv_lora_rank, H, m.nope_dim), ("latent", "heads", None),
                    "normal", m.kv_lora_rank ** -0.5),
        "wv_b": PAb((m.kv_lora_rank, H, m.v_dim), ("latent", "heads", None),
                    "normal", m.kv_lora_rank ** -0.5),
        "wo": PAb((H, m.v_dim, d), ("heads", None, "embed"), "normal",
                  (H * m.v_dim) ** -0.5),
    }


def _mla_qk(cfg, params, x, positions):
    """Shared q / latent projections. Returns q_nope, q_rope, c_kv, k_rope."""
    m = cfg.mla
    cd = x.dtype
    ql = L.rmsnorm(params["q_norm"], x @ params["wq_a"].to(cd), cfg.norm_eps)
    q = torch.einsum("bsr,rhk->bhsk", ql, params["wq_b"].to(cd))
    q_nope, q_rope = q[..., : m.nope_dim], q[..., m.nope_dim:]
    q_rope = L.apply_rope(q_rope, positions, cfg.rope_theta)

    kv = x @ params["wkv_a"].to(cd)                      # (B,S,rank+rope)
    c_kv = L.rmsnorm(params["kv_norm"], kv[..., : m.kv_lora_rank],
                     cfg.norm_eps)
    k_rope = kv[..., m.kv_lora_rank:][:, None]           # (B,1,S,rope)
    k_rope = L.apply_rope(k_rope, positions, cfg.rope_theta)
    return q_nope, q_rope, c_kv, k_rope


def mla_train(cfg: ArchConfig, params, x, positions,
              return_latent: bool = False):
    """Full-sequence MLA (train / prefill): expand k, v from the latent.
    q and k are (B, H, S, nope + rope), v (B, H, S, v_dim)."""
    m = cfg.mla
    cd = x.dtype
    q_nope, q_rope, c_kv, k_rope = _mla_qk(cfg, params, x, positions)
    k_nope = torch.einsum("bsr,rhk->bhsk", c_kv, params["wk_b"].to(cd))
    v = torch.einsum("bsr,rhk->bhsk", c_kv, params["wv_b"].to(cd))
    k_rope_b = k_rope.expand(*k_nope.shape[:-1], m.rope_dim)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope_b], dim=-1)
    out = flash_attention(q, k, v, causal=True)
    proj = torch.einsum("bhsk,hkd->bsd", out, params["wo"].to(cd))
    if return_latent:
        return proj, (c_kv, k_rope[:, 0])       # (B,S,rank), (B,S,rope)
    return proj


class MLACache(NamedTuple):
    c_kv: torch.Tensor    # (B, Smax, kv_lora_rank), or (L, B, ...) stacked
    k_rope: torch.Tensor  # (B, Smax, rope_dim)


def mla_init_cache(cfg: ArchConfig, batch, max_len, dtype,
                   device=None) -> MLACache:
    m = cfg.mla
    return MLACache(
        c_kv=torch.zeros((batch, max_len, m.kv_lora_rank), dtype=dtype,
                         device=device),
        k_rope=torch.zeros((batch, max_len, m.rope_dim), dtype=dtype,
                           device=device))


def mla_decode(cfg: ArchConfig, params, x, cache: MLACache, positions):
    """Absorbed-matmul decode: scores computed against the latent cache
    directly (q~ = q_nope @ W_kb per head), so per step the cache read is
    O(S * (rank + rope)) instead of O(S * H * head_dim).  Writes the new
    latent and rotary key at ``positions`` (the same for every row) of
    ``cache`` in place and returns (proj, cache)."""
    m = cfg.mla
    cd = x.dtype
    q_nope, q_rope, c_new, kr_new = _mla_qk(cfg, params, x, positions)
    pos = positions[0, :1].long()              # (1,), stays on the device
    c_kv, k_rope = cache.c_kv, cache.k_rope
    c_kv.index_copy_(1, pos, c_new.to(c_kv.dtype))
    k_rope.index_copy_(1, pos, kr_new[:, 0].to(k_rope.dtype))

    # absorb: q~_h = q_nope_h @ W_kb_h^T  -> (B,H,1,rank)
    q_lat = torch.einsum("bhsk,rhk->bhsr", q_nope, params["wk_b"].to(cd))
    s_nope = torch.einsum("bhsr,btr->bhst", q_lat, c_kv.to(cd))
    s_rope = torch.einsum("bhsk,btk->bhst", q_rope, k_rope.to(cd))
    scale = 1.0 / torch.sqrt(torch.tensor(float(m.nope_dim + m.rope_dim),
                                          device=x.device))
    scores = (s_nope + s_rope).to(torch.float32) * scale
    idx = torch.arange(c_kv.shape[1], device=x.device)
    scores = torch.where((idx <= pos)[None, None, None], scores,
                         torch.tensor(-1e30, device=x.device))
    w = torch.softmax(scores, dim=-1).to(cd)
    # attend in latent space, then expand once: (B,H,1,rank) @ W_vb
    o_lat = torch.einsum("bhst,btr->bhsr", w, c_kv.to(cd))
    out = torch.einsum("bhsr,rhk->bhsk", o_lat, params["wv_b"].to(cd))
    proj = torch.einsum("bhsk,hkd->bsd", out, params["wo"].to(cd))
    return proj, cache
