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

Under a mesh (explicit SPMD, ``launch.mesh``) each rank holds the
blocks of the weights ``resolve_spec`` gives it.  The projections are
column-parallel over the q heads (``heads``) and kv heads (``kv``), and
``wo`` row-parallel: its product is a partial sum that ends in a
``model`` all-reduce, or, where the caller's ``Placement`` splits the
sequence between blocks (``seq_sp``), in a reduce-scatter over the
sequence.  Where the q heads do not divide the model axis the batch
spreads over it instead (``attn_batch``, as the reference's branch).
A rank's q heads read the kv heads their group maps to, also where the
kv heads stay replicated (fewer than the model axis).  A
cross-attention (``kv_override``) projects its k and v from the
memory the same way, column-parallel over the kv heads.  The decode
cache lies as ``gqa_cache_logical`` / ``mla_cache_logical`` resolve:
kv-head-sharded (16 or more kv heads), else sequence-sharded over
``model``.  Decoding against a sequence-sharded cache is flash-decoding,
which GSPMD inserts in the reference and the port writes: each rank
takes the softmax over its slice of positions (max, sum of
exponentials, weighted values, the window applied to global
positions), and a log-sum-exp merge across ``model`` combines them.

``gqa_cache_abstract`` / ``mla_cache_abstract`` are one layer's cache
as meta tensors (shapes and dtypes, no storage), for the dry run
(``launch/dryrun.py``).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.device import torch_dtype
from repro_torch.dist.sharding import relayout, resolve_spec
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.launch import mesh as _mesh
from repro_torch.models import layers as L
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import PAb, Placement, axes_of, entry_of


def _kv_for_heads(k, q_heads: int, h0: int, group: int):
    """The kv heads (dim 1 of ``k``, all of them) that q heads [h0, h0 +
    q_heads) read under a group of ``group`` q heads a kv head."""
    if q_heads % group == 0:
        return k[:, h0 // group: h0 // group + q_heads // group]
    if group % q_heads == 0:
        return k[:, h0 // group: h0 // group + 1]
    raise NotImplementedError(f"{q_heads} q heads a rank do not align with "
                              f"a group of {group}")


def _head_block(x, mesh, src_entry, dst_entry, dim=1):
    """x's heads (``dim``) moved from one spec entry to another."""
    src = [None] * x.ndim
    dst = [None] * x.ndim
    src[dim], dst[dim] = src_entry, dst_entry
    return relayout(x, mesh, src, dst)


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


def gqa_train(cfg: ArchConfig, params, x, positions, mesh=None,
              causal: bool = True, kv_override=None, return_kv: bool = False,
              *, place: Placement = None, seq_out: bool = False):
    """Full-sequence attention (train / prefill). x: (B,S,D).

    kv_override: (B, Sk, D) memory (whisper's encoder output) that k and
    v are projected from instead of x: cross-attention, neither q nor k
    rotated; the caller passes ``causal=False``.

    Under a mesh: ``x``, ``positions`` and ``kv_override`` are this
    rank's batch block as ``place`` lays it (default: the whole batch),
    the whole sequence;
    the result is this rank's block of the summed projection, its
    sequence split as ``place.seq`` when ``seq_out``.  The returned k
    and v are in ``gqa_kv_spec``'s layout."""
    cd = x.dtype
    kv_src = x if kv_override is None else kv_override
    q = torch.einsum("bsd,dhk->bhsk", x, params["wq"].to(cd))
    k = torch.einsum("bsd,dhk->bhsk", kv_src, params["wk"].to(cd))
    v = torch.einsum("bsd,dhk->bhsk", kv_src, params["wv"].to(cd))
    if kv_override is None:            # self-attention: rotate q and k
        q = L.apply_rope(q, positions, cfg.rope_theta, cfg.rope_fraction)
        k = L.apply_rope(k, positions, cfg.rope_theta, cfg.rope_fraction)
    if mesh is None:
        out = flash_attention(q, k, v, causal=causal, window=cfg.window)
        proj = torch.einsum("bhsk,hkd->bsd", out, params["wo"].to(cd))
        return (proj, (k, v)) if return_kv else proj
    place = place or Placement.whole(mesh, x.shape[0], x.shape[1])
    H, Hkv, hd, D = (cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim,
                     cfg.d_model)
    B, S = place.B, place.S
    b_in = entry_of(place.batch)
    wq_h = L.spec_entry((D, H, hd), ("embed", "heads", None), mesh, 1)
    wk_h = L.spec_entry((D, Hkv, hd), ("embed", "kv", None), mesh, 1)
    wo_h = L.spec_entry((H, hd, D), ("heads", None, "embed"), mesh, 0)
    # TP over heads when they divide the model axis; else the batch
    # spreads over model too (the reference's attn_batch branch)
    bax = ("batch" if H % mesh.shape.get("model", 1) == 0
           else "attn_batch")
    q_spec = resolve_spec((B, H, S, hd), (bax, "heads", "seq", None), mesh)
    k_spec = gqa_kv_spec(cfg, mesh, B, kv_src.shape[1], bax)
    q = relayout(q, mesh, (b_in, wq_h), q_spec)
    k = relayout(k, mesh, (b_in, wk_h), k_spec)
    v = relayout(v, mesh, (b_in, wk_h), k_spec)
    q_ent = (tuple(q_spec) + (None, None))[:2]
    k_ent = (tuple(k_spec) + (None, None))[:2]
    kq, vq = k, v
    if axes_of(q_ent[1]) and not axes_of(k_ent[1]):
        hq = q.shape[1]
        h0 = mesh.index(axes_of(q_ent[1])) * hq
        kq = _kv_for_heads(k, hq, h0, H // Hkv)
        vq = _kv_for_heads(v, hq, h0, H // Hkv)
    out = flash_attention(q, kq, vq, causal=causal, window=cfg.window)
    out = _head_block(out, mesh, q_ent[1], wo_h)
    proj = torch.einsum("bhsk,hkd->bsd", out, params["wo"].to(cd))
    proj = L.finish_row_parallel(proj, mesh, place, q_ent[0], axes_of(wo_h),
                                seq_out)
    return (proj, (k, v)) if return_kv else proj


def gqa_kv_spec(cfg: ArchConfig, mesh, B: int, S: int, bax=None):
    """The layout of ``gqa_train``'s k and v, (B, Hkv, S, hd), under a
    mesh."""
    if bax is None:
        bax = ("batch" if cfg.n_heads % mesh.shape.get("model", 1) == 0
               else "attn_batch")
    return resolve_spec((B, cfg.n_kv_heads, S, cfg.resolved_head_dim),
                        (bax, "kv", "seq", None), mesh)


class KVCache(NamedTuple):
    k: torch.Tensor   # (B, Hkv, Smax, hd), or (L, B, Hkv, Smax, hd) stacked
    v: torch.Tensor


def gqa_init_cache(cfg: ArchConfig, batch, max_len, dtype,
                   device=None) -> KVCache:
    shape = (batch, cfg.n_kv_heads, max_len, cfg.resolved_head_dim)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device))


def gqa_cache_abstract(cfg: ArchConfig, batch, max_len,
                       dtype=torch.bfloat16) -> KVCache:
    """One layer's cache on the meta device: ``gqa_init_cache``'s
    shapes and dtype without storage."""
    return gqa_init_cache(cfg, batch, max_len, torch_dtype(dtype), "meta")


def gqa_cache_logical(cfg: ArchConfig) -> KVCache:
    """The logical axes of one layer's cache: kv heads over ``model``
    when there are 16 or more, else the sequence (flash-decoding)."""
    if cfg.n_kv_heads >= 16:
        ls = ("cache_batch", "kv", None, None)
    else:
        ls = ("cache_batch", None, "cache_seq", None)
    return KVCache(k=ls, v=ls)


def _write_at(cache_t, dim: int, pos, new, lo: int = 0):
    """Write ``new`` (extent 1 on ``dim``) at global position ``pos``
    into ``cache_t``, a block that holds positions [lo, lo + extent):
    in place, without a host sync; a block without ``pos`` is left as
    it is."""
    n = cache_t.shape[dim]
    li = pos - lo
    lc = li.clamp(0, n - 1)
    inside = (li >= 0) & (li < n)
    shape = [1] * cache_t.ndim
    val = torch.where(inside.view(shape), new.to(cache_t.dtype),
                      cache_t.index_select(dim, lc))
    cache_t.index_copy_(dim, lc, val)


def _lse_merge(mesh, axes, mx, denom, acc):
    """The flash-decoding combine: each rank's max ``mx``, sum of
    exponentials ``denom`` (both (..., 1)) and unnormalized output
    ``acc`` (..., hd), all fp32, merged across ``axes``."""
    stats = torch.cat([mx, denom, acc], dim=-1)[None]
    every = _mesh.all_gather(mesh, stats, axes, 0)
    top = every[..., :1].max(0).values
    wts = torch.exp(every[..., :1] - top)
    return (wts * every[..., 2:]).sum(0) / (wts * every[..., 1:2]).sum(0)


def gqa_decode(cfg: ArchConfig, params, x, cache: KVCache, positions,
               mesh=None, *, place: Placement = None, cache_spec=None):
    """One-token decode. x: (B,1,D); positions: (B,1) absolute position,
    the same for every row.  Writes the new key/value at that position
    of ``cache`` in place and returns (proj, cache).

    Under a mesh: ``x`` is this rank's batch block (``place``), ``cache``
    this rank's block of the layer's cache as ``cache_spec`` (its
    PartitionSpec) lays it, and proj the summed projection."""
    B = x.shape[0]
    cd = x.dtype
    q = torch.einsum("bsd,dhk->bhsk", x, params["wq"].to(cd))
    k_new = torch.einsum("bsd,dhk->bhsk", x, params["wk"].to(cd))
    v_new = torch.einsum("bsd,dhk->bhsk", x, params["wv"].to(cd))
    q = L.apply_rope(q, positions, cfg.rope_theta, cfg.rope_fraction)
    k_new = L.apply_rope(k_new, positions, cfg.rope_theta,
                         cfg.rope_fraction)

    pos = positions[0, :1].long()              # (1,), stays on the device
    if mesh is not None:
        return _gqa_decode_mesh(cfg, params, q, k_new, v_new, cache, pos,
                                mesh, place, cache_spec, cd)
    k, v = cache.k, cache.v
    k.index_copy_(2, pos, k_new.to(k.dtype))
    v.index_copy_(2, pos, v_new.to(v.dtype))
    out = _gqa_attend(cfg, q, k, v, pos, cd, cfg.n_heads // cfg.n_kv_heads)
    proj = torch.einsum("bshk,hkd->bsd", out, params["wo"].to(cd))
    return proj, cache


def _gqa_attend(cfg, q, k, v, pos, cd, group, lo: int = 0,
                partial: bool = False):
    """Scores of q (B, Hq, 1, hd) against k (B, Hkv, n, hd), n positions
    from ``lo``, masked causally (and by the window) at ``pos``.  Returns
    the output (B, 1, Hq, hd); with ``partial`` the fp32 (max, sum of
    exponentials, unnormalized output) of this block instead."""
    B, Hq, _, hd = q.shape
    Hkv, n = k.shape[1], k.shape[2]
    qg = q.reshape(B, Hkv, group, hd)
    scores = torch.einsum("bhgk,bhsk->bhgs", qg, k.to(cd)) / torch.tensor(
        math.sqrt(hd), dtype=cd, device=q.device)
    idx = lo + torch.arange(n, device=q.device)
    mask = idx[None, :] <= pos[:, None]
    if cfg.window is not None:
        mask &= idx[None, :] > pos[:, None] - cfg.window
    scores = torch.where(mask[None, None], scores.to(torch.float32),
                         torch.tensor(-1e30, device=q.device))
    if partial:
        mx = scores.amax(-1, keepdim=True)
        p = torch.exp(scores - mx)
        acc = torch.einsum("bhgs,bhsk->bhgk", p.to(cd), v.to(cd))
        return mx, p.sum(-1, keepdim=True), acc.to(torch.float32)
    w = torch.softmax(scores, dim=-1).to(cd)
    out = torch.einsum("bhgs,bhsk->bhgk", w, v.to(cd))
    return out.reshape(B, Hq, 1, hd).transpose(1, 2)          # (B,1,H,hd)


def _gqa_decode_mesh(cfg, params, q, k_new, v_new, cache, pos, mesh, place,
                     cache_spec, cd):
    B = q.shape[0]
    H, Hkv, hd, D = (cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim,
                     cfg.d_model)
    place = place or Placement.whole(mesh, B, 1)
    wq_h = L.spec_entry((D, H, hd), ("embed", "heads", None), mesh, 1)
    wk_h = L.spec_entry((D, Hkv, hd), ("embed", "kv", None), mesh, 1)
    wo_h = L.spec_entry((H, hd, D), ("heads", None, "embed"), mesh, 0)
    cb, ch, cs = (tuple(cache_spec) + (None,) * 4)[:3]
    if axes_of(cb) != tuple(place.batch):
        raise NotImplementedError(f"a cache batch laid as {cb!r} under "
                                  f"activations laid as {place.batch}")
    k, v = cache.k, cache.v
    group = H // Hkv
    if axes_of(cs):
        # flash-decoding: every head against this rank's positions
        q = _head_block(q, mesh, wq_h, None)
        k_new = _head_block(k_new, mesh, wk_h, None)
        v_new = _head_block(v_new, mesh, wk_h, None)
        lo = mesh.index(axes_of(cs)) * k.shape[2]
        _write_at(k, 2, pos, k_new, lo)
        _write_at(v, 2, pos, v_new, lo)
        mx, den, acc = _gqa_attend(cfg, q, k, v, pos, cd, group, lo,
                                   partial=True)
        out = _lse_merge(mesh, axes_of(cs), mx, den, acc).to(cd)
        out = out.reshape(B, H, 1, hd).transpose(1, 2)
        out = _head_block(out, mesh, None, wo_h, dim=2)
    else:
        q = _head_block(q, mesh, wq_h, wo_h)
        k_new = _head_block(k_new, mesh, wk_h, ch)
        v_new = _head_block(v_new, mesh, wk_h, ch)
        k.index_copy_(2, pos, k_new.to(k.dtype))
        v.index_copy_(2, pos, v_new.to(v.dtype))
        hq = q.shape[1]
        kq, vq = k, v
        if axes_of(wo_h) and not axes_of(ch):
            h0 = mesh.index(axes_of(wo_h)) * hq
            kq = _kv_for_heads(k, hq, h0, group)
            vq = _kv_for_heads(v, hq, h0, group)
        out = _gqa_attend(cfg, q, kq, vq, pos, cd, hq // kq.shape[1])
    proj = torch.einsum("bshk,hkd->bsd", out, params["wo"].to(cd))
    if axes_of(wo_h):
        proj = _mesh.all_reduce(mesh, proj, axes_of(wo_h))
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


def mla_train(cfg: ArchConfig, params, x, positions, mesh=None,
              return_latent: bool = False, *, place: Placement = None,
              seq_out: bool = False):
    """Full-sequence MLA (train / prefill): expand k, v from the latent.
    q and k are (B, H, S, nope + rope), v (B, H, S, v_dim).  Under a
    mesh as ``gqa_train``: this rank's heads, the projection summed (and
    reduce-scattered over the sequence when ``seq_out``); the latent
    (c_kv, k_rope) is this rank's batch block, whole over ``model``."""
    m = cfg.mla
    cd = x.dtype
    q_nope, q_rope, c_kv, k_rope = _mla_qk(cfg, params, x, positions)
    k_nope = torch.einsum("bsr,rhk->bhsk", c_kv, params["wk_b"].to(cd))
    v = torch.einsum("bsr,rhk->bhsk", c_kv, params["wv_b"].to(cd))
    k_rope_b = k_rope.expand(*k_nope.shape[:-1], m.rope_dim)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope_b], dim=-1)
    if mesh is None:
        out = flash_attention(q, k, v, causal=True)
        proj = torch.einsum("bhsk,hkd->bsd", out, params["wo"].to(cd))
    else:
        place = place or Placement.whole(mesh, x.shape[0], x.shape[1])
        H, D = cfg.n_heads, cfg.d_model
        w_h = L.spec_entry((m.q_lora_rank, H, m.nope_dim + m.rope_dim),
                     ("latent", "heads", None), mesh, 1)
        wo_h = L.spec_entry((H, m.v_dim, D), ("heads", None, "embed"), mesh, 0)
        spec = resolve_spec((place.B, H, place.S, m.nope_dim + m.rope_dim),
                            ("batch", "heads", "seq", None), mesh)
        src = (entry_of(place.batch), w_h)
        q, k, v = (relayout(t, mesh, src, spec) for t in (q, k, v))
        ent = (tuple(spec) + (None, None))[:2]
        out = flash_attention(q, k, v, causal=True)
        out = _head_block(out, mesh, ent[1], wo_h)
        proj = torch.einsum("bhsk,hkd->bsd", out, params["wo"].to(cd))
        proj = L.finish_row_parallel(proj, mesh, place, ent[0],
                                    axes_of(wo_h), seq_out)
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


def mla_cache_abstract(cfg: ArchConfig, batch, max_len,
                       dtype=torch.bfloat16) -> MLACache:
    """One layer's latent cache on the meta device."""
    return mla_init_cache(cfg, batch, max_len, torch_dtype(dtype), "meta")


def mla_cache_logical(cfg: ArchConfig) -> MLACache:
    """The latent cache has no head dim: the sequence over ``model``."""
    return MLACache(c_kv=("cache_batch", "cache_seq", None),
                    k_rope=("cache_batch", "cache_seq", None))


def _mla_attend(q_lat, q_rope, c_kv, k_rope, pos, cd, scale, lo: int = 0,
                partial: bool = False):
    """Absorbed scores of (B,H,1,rank) / (B,H,1,rope) against n latent
    positions from ``lo``, masked causally at ``pos``: the latent-space
    output (B,H,1,rank), or with ``partial`` this block's fp32 (max, sum
    of exponentials, unnormalized output)."""
    s_nope = torch.einsum("bhsr,btr->bhst", q_lat, c_kv.to(cd))
    s_rope = torch.einsum("bhsk,btk->bhst", q_rope, k_rope.to(cd))
    scores = (s_nope + s_rope).to(torch.float32) * scale
    idx = lo + torch.arange(c_kv.shape[1], device=q_lat.device)
    scores = torch.where((idx <= pos)[None, None, None], scores,
                         torch.tensor(-1e30, device=q_lat.device))
    if partial:
        mx = scores.amax(-1, keepdim=True)
        p = torch.exp(scores - mx)
        acc = torch.einsum("bhst,btr->bhsr", p.to(cd), c_kv.to(cd))
        return mx, p.sum(-1, keepdim=True), acc.to(torch.float32)
    w = torch.softmax(scores, dim=-1).to(cd)
    return torch.einsum("bhst,btr->bhsr", w, c_kv.to(cd))


def mla_decode(cfg: ArchConfig, params, x, cache: MLACache, positions,
               mesh=None, *, place: Placement = None, cache_spec=None):
    """Absorbed-matmul decode: scores computed against the latent cache
    directly (q~ = q_nope @ W_kb per head), so per step the cache read is
    O(S * (rank + rope)) instead of O(S * H * head_dim).  Writes the new
    latent and rotary key at ``positions`` (the same for every row) of
    ``cache`` in place and returns (proj, cache).  Under a mesh as
    ``gqa_decode`` (``cache_spec``: the c_kv leaf's PartitionSpec)."""
    m = cfg.mla
    cd = x.dtype
    q_nope, q_rope, c_new, kr_new = _mla_qk(cfg, params, x, positions)
    pos = positions[0, :1].long()              # (1,), stays on the device
    c_kv, k_rope = cache.c_kv, cache.k_rope
    # absorb: q~_h = q_nope_h @ W_kb_h^T  -> (B,H,1,rank)
    q_lat = torch.einsum("bhsk,rhk->bhsr", q_nope, params["wk_b"].to(cd))
    scale = 1.0 / torch.sqrt(torch.tensor(float(m.nope_dim + m.rope_dim),
                                          device=x.device))
    if mesh is None:
        c_kv.index_copy_(1, pos, c_new.to(c_kv.dtype))
        k_rope.index_copy_(1, pos, kr_new[:, 0].to(k_rope.dtype))
        o_lat = _mla_attend(q_lat, q_rope, c_kv, k_rope, pos, cd, scale)
        # attend in latent space, then expand once: (B,H,1,rank) @ W_vb
        out = torch.einsum("bhsr,rhk->bhsk", o_lat, params["wv_b"].to(cd))
        proj = torch.einsum("bhsk,hkd->bsd", out, params["wo"].to(cd))
        return proj, cache
    place = place or Placement.whole(mesh, x.shape[0], 1)
    H, D = cfg.n_heads, cfg.d_model
    w_h = L.spec_entry((m.q_lora_rank, H, m.nope_dim + m.rope_dim),
                 ("latent", "heads", None), mesh, 1)
    wo_h = L.spec_entry((H, m.v_dim, D), ("heads", None, "embed"), mesh, 0)
    cb, cs = (tuple(cache_spec) + (None,) * 3)[:2]
    if axes_of(cb) != tuple(place.batch):
        raise NotImplementedError(f"a cache batch laid as {cb!r} under "
                                  f"activations laid as {place.batch}")
    if axes_of(cs):
        lo = mesh.index(axes_of(cs)) * c_kv.shape[1]
        _write_at(c_kv, 1, pos, c_new, lo)
        _write_at(k_rope, 1, pos, kr_new[:, 0], lo)
        q_lat = _head_block(q_lat, mesh, w_h, None)
        q_rope = _head_block(q_rope, mesh, w_h, None)
        mx, den, acc = _mla_attend(q_lat, q_rope, c_kv, k_rope, pos, cd,
                                   scale, lo, partial=True)
        o_lat = _lse_merge(mesh, axes_of(cs), mx, den, acc).to(cd)
        o_lat = _head_block(o_lat, mesh, None, w_h)
    else:
        c_kv.index_copy_(1, pos, c_new.to(c_kv.dtype))
        k_rope.index_copy_(1, pos, kr_new[:, 0].to(k_rope.dtype))
        o_lat = _mla_attend(q_lat, q_rope, c_kv, k_rope, pos, cd, scale)
    out = torch.einsum("bhsr,rhk->bhsk", o_lat, params["wv_b"].to(cd))
    out = _head_block(out, mesh, w_h, wo_h)
    proj = torch.einsum("bhsk,hkd->bsd", out, params["wo"].to(cd))
    if axes_of(wo_h):
        proj = _mesh.all_reduce(mesh, proj, axes_of(wo_h))
    return proj, cache
