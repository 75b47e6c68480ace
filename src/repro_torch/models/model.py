"""Model assembly for the ``dense``, ``moe``, ``ssm`` and ``hybrid``
families: parameters, the train / prefill forward, and decode.  Port of
those paths of the reference's ``repro.models.model``.

The reference stacks its layers on a leading ``layers`` axis and runs
them under ``lax.scan``; here the parameter tree is an ``nn.Module``
with one block per layer (``params["blocks"][i]``, and deepseek's
leading dense layers in ``params["dense_blocks"][i]``), and a Python
loop runs them.  A hybrid (jamba) model holds one entry a group of
``cfg.hybrid_group``: ``params["blocks"][g]["sub{i}"]`` is the i-th
layer of group g, a Mamba2 block ("m") or an attention block ("a"),
with a MoE FFN at odd positions and the dense MLP at even ones.

The decode cache keeps the reference's layout, stacked over the layers
of each run of blocks: one ``KVCache`` (k and v (L, B, Hkv, Smax, hd))
or, under MLA, one ``MLACache`` (c_kv (L, B, Smax, rank), k_rope (L,
B, Smax, rope)); for the ssm family one ``MambaCache`` (conv (L, B,
d_conv-1, conv_dim), state (L, B, nh, hp, N)); for the hybrid family a
dict ``sub{i}`` of ``MambaCache`` / ``KVCache``, each stacked over the
groups.  ``decode_step`` writes into it in place.

Every forward returns (hidden_states, aux), aux the sum of the MoE
layers' load-balancing losses (0 for the dense and ssm families).

The encdec and vlm families raise NotImplementedError naming ROADMAP.md
queue 1, items 17.4 and 17.5.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.device import DeviceLike, resolve_device, torch_dtype
from repro_torch.models import attention as ATT
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as SSM
from repro_torch.models import moe as MOE
from repro_torch.models.config import ArchConfig

# the ROADMAP.md queue 1 item of each family not ported yet
_FAMILY_ITEM = {"encdec": "17.4", "vlm": "17.5"}


def _check_family(cfg: ArchConfig) -> None:
    dense = cfg.family == "dense" and cfg.moe is None and cfg.mla is None
    moe = cfg.family == "moe" and cfg.moe is not None
    ssm = cfg.family == "ssm" and cfg.ssm is not None and cfg.moe is None
    hybrid = (cfg.family == "hybrid" and cfg.ssm is not None
              and cfg.moe is not None and cfg.mla is None
              and bool(cfg.hybrid_group))
    if not (dense or moe or ssm or hybrid):
        item = _FAMILY_ITEM.get(cfg.family, "17")
        raise NotImplementedError(
            f"the {cfg.family} family ({cfg.name}) is not ported yet: "
            f"ROADMAP.md queue 1, item {item} lists it")
    if cfg.norm != "rmsnorm" or cfg.pos_embedding != "rope":
        raise NotImplementedError(
            f"{cfg.norm} / {cfg.pos_embedding} positions ({cfg.name}) "
            f"{ATT.NOT_PORTED}")


def _n_dense(cfg: ArchConfig) -> int:
    """Leading dense blocks of a moe model (deepseek's first_dense)."""
    return cfg.moe.first_dense if cfg.family == "moe" else 0


# ================================================================ params

def _attn_block_ab(cfg, ffn: str):
    return {"ln1": L.rmsnorm_ab(cfg.d_model), "ln2": L.rmsnorm_ab(cfg.d_model),
            "attn": ATT.mla_ab(cfg) if cfg.mla else ATT.gqa_ab(cfg),
            "ffn": (MOE.moe_ab(cfg) if ffn == "moe"
                    else L.mlp_ab(cfg.d_model, cfg.d_ff, cfg.gated))}


def _mamba_block_ab(cfg, ffn):
    blk = {"ln1": L.rmsnorm_ab(cfg.d_model), "mamba": SSM.mamba_ab(cfg)}
    if ffn:
        blk["ln2"] = L.rmsnorm_ab(cfg.d_model)
        blk["ffn"] = (MOE.moe_ab(cfg) if ffn == "moe"
                      else L.mlp_ab(cfg.d_model, cfg.d_ff, cfg.gated))
    return blk


def _jamba_group_ab(cfg):
    """One jamba group: pattern cfg.hybrid_group; MoE at odd positions."""
    group = {}
    for i, kind in enumerate(cfg.hybrid_group):
        ffn = "moe" if i % 2 == 1 else "mlp"
        group[f"sub{i}"] = (_mamba_block_ab(cfg, ffn) if kind == "m"
                            else _attn_block_ab(cfg, ffn))
    return group


def _n_groups(cfg: ArchConfig) -> int:
    return cfg.n_layers // len(cfg.hybrid_group)


def abstract_params(cfg: ArchConfig) -> dict:
    _check_family(cfg)
    p = {"embed": L.embedding_ab(cfg.vocab, cfg.d_model,
                                 pad_to=cfg.vocab_pad_to),
         "final_norm": L.rmsnorm_ab(cfg.d_model)}
    if cfg.family == "ssm":
        p["blocks"] = [_mamba_block_ab(cfg, None)
                       for _ in range(cfg.n_layers)]
        return p
    if cfg.family == "hybrid":
        p["blocks"] = [_jamba_group_ab(cfg) for _ in range(_n_groups(cfg))]
        return p
    nd = _n_dense(cfg)
    if nd:
        p["dense_blocks"] = [_attn_block_ab(cfg, "mlp") for _ in range(nd)]
    ffn = "moe" if cfg.family == "moe" else "mlp"
    p["blocks"] = [_attn_block_ab(cfg, ffn) for _ in range(cfg.n_layers - nd)]
    return p


def init_params(cfg: ArchConfig, seed: int = 0, device: DeviceLike = None,
                dtype=None) -> L.ParamTree:
    """The parameter tree in ``dtype`` (default ``cfg.params_dtype``),
    drawn on the device from a ``torch.Generator`` seeded with ``seed``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return L.ParamTree(abstract_params(cfg), gen, dev,
                       torch_dtype(dtype or cfg.params_dtype))


# ================================================================ blocks

def _ffn(cfg, blk, h):
    """The block's FFN: (out, aux); aux is 0.0 for a dense MLP."""
    if "router" in blk["ffn"]:
        return MOE.moe_block(cfg, blk["ffn"], h)
    return L.mlp(blk["ffn"], h, cfg.act, cfg.gated), 0.0


def _attn_block(cfg, blk, x, positions, collect=False):
    """Pre-norm attention block (train / prefill path): (out, aux[,
    cache piece])."""
    h = L.rmsnorm(blk["ln1"], x, cfg.norm_eps)
    piece = None
    if cfg.mla:
        if collect:
            h, lat = ATT.mla_train(cfg, blk["attn"], h, positions,
                                   return_latent=True)
            piece = ATT.MLACache(c_kv=lat[0], k_rope=lat[1])
        else:
            h = ATT.mla_train(cfg, blk["attn"], h, positions)
    elif collect:
        h, kv = ATT.gqa_train(cfg, blk["attn"], h, positions,
                              return_kv=True)
        piece = ATT.KVCache(k=kv[0], v=kv[1])
    else:
        h = ATT.gqa_train(cfg, blk["attn"], h, positions)
    x = x + h
    h, aux = _ffn(cfg, blk, L.rmsnorm(blk["ln2"], x, cfg.norm_eps))
    out = x + h
    if collect:
        return out, aux, piece
    return out, aux


def _mamba_block(cfg, blk, x, collect=False):
    """Pre-norm Mamba2 block, its FFN (hybrid) after a second norm:
    (out, aux[, MambaCache piece])."""
    h = L.rmsnorm(blk["ln1"], x, cfg.norm_eps)
    piece = None
    if collect:
        h, piece = SSM.mamba_train(cfg, blk["mamba"], h, return_state=True)
    else:
        h = SSM.mamba_train(cfg, blk["mamba"], h)
    x = x + h
    aux = 0.0
    if "ffn" in blk:
        h, aux = _ffn(cfg, blk, L.rmsnorm(blk["ln2"], x, cfg.norm_eps))
        x = x + h
    if collect:
        return x, aux, piece
    return x, aux


def _stack(pieces):
    """Per-layer cache pieces (one NamedTuple each, or a hybrid group's
    dict of them) stacked along a leading layers axis."""
    if isinstance(pieces[0], dict):
        return {k: _stack([p[k] for p in pieces]) for k in pieces[0]}
    return type(pieces[0])(*(torch.stack(f) for f in zip(*pieces)))


def _group_block(cfg, group, x, positions, collect=False):
    """One hybrid group, its layers in ``cfg.hybrid_group`` order:
    (out, aux[, dict sub{i} of pieces])."""
    aux = 0.0
    pieces = {}
    for i, kind in enumerate(cfg.hybrid_group):
        sub = group[f"sub{i}"]
        out = (_mamba_block(cfg, sub, x, collect=collect) if kind == "m"
               else _attn_block(cfg, sub, x, positions, collect=collect))
        x, aux = out[0], aux + out[1]
        if collect:
            pieces[f"sub{i}"] = out[2]
    if collect:
        return x, aux, pieces
    return x, aux


def _block(cfg, blk, x, positions, collect):
    if cfg.family == "ssm":
        return _mamba_block(cfg, blk, x, collect=collect)
    if cfg.family == "hybrid":
        return _group_block(cfg, blk, x, positions, collect=collect)
    return _attn_block(cfg, blk, x, positions, collect=collect)


def _run_blocks(cfg, blocks, x, positions, collect):
    """(x, aux summed over the blocks, stacked pieces or None)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    pieces = []
    for blk in blocks:
        out = _block(cfg, blk, x, positions, collect)
        x, aux = out[0], aux + out[1]
        if collect:
            pieces.append(out[2])
    return x, aux, (_stack(pieces) if collect else None)


def forward_train(cfg: ArchConfig, params, tokens, collect_cache=False):
    """Train / prefill forward -> (hidden (B,S,D), aux[, cache pieces]).

    aux is the sum of the MoE layers' load-balancing losses, 0 for the
    dense and ssm families.  collect_cache: also return the per-layer KV
    (MLA latent, Mamba conv tail and state) pieces, stacked along a
    leading layers axis (a hybrid model's: a dict ``sub{i}`` of pieces
    stacked over the groups), as ``(pieces, dense_pieces, None)`` (the
    reference's (pieces, dense_pieces, enc_out)); dense_pieces are
    those of deepseek's leading dense blocks, else None."""
    _check_family(cfg)
    cd = torch_dtype(cfg.compute_dtype)
    x = L.embed(params["embed"], tokens, cfg.embed_scale).to(cd)
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)[None].expand(B, S)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    dense_pieces = None
    if "dense_blocks" in params:
        x, a, dense_pieces = _run_blocks(cfg, params["dense_blocks"], x,
                                         positions, collect_cache)
        aux = aux + a
    x, a, pieces = _run_blocks(cfg, params["blocks"], x, positions,
                               collect_cache)
    aux = aux + a
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    if collect_cache:
        return x, aux, (pieces, dense_pieces, None)
    return x, aux


# ================================================================ decode

class DecodeCache(NamedTuple):
    layers: Any            # KVCache, MLACache or MambaCache stacked over
                           # layers; hybrid: a dict sub{i} of them stacked
                           # over groups
    dense_layers: Any      # the same for deepseek's leading dense blocks
    enc_out: Any           # encdec cross-attention memory: None here


def _layer_cache(cfg, batch, max_len, dtype, device, n, kind="a"):
    if kind == "m":
        one = SSM.mamba_init_cache(cfg, batch, dtype, device)
    else:
        init = ATT.mla_init_cache if cfg.mla else ATT.gqa_init_cache
        one = init(cfg, batch, max_len, dtype, device)
    return type(one)(*(f[None].repeat(n, *(1,) * f.ndim) for f in one))


def cache_zeros(cfg: ArchConfig, batch, max_len, dtype=torch.bfloat16,
                device: DeviceLike = None) -> DecodeCache:
    _check_family(cfg)
    dev = resolve_device(device)
    dt = torch_dtype(dtype)
    if cfg.family == "hybrid":
        layers = {f"sub{i}": _layer_cache(cfg, batch, max_len, dt, dev,
                                          _n_groups(cfg), kind)
                  for i, kind in enumerate(cfg.hybrid_group)}
        return DecodeCache(layers=layers, dense_layers=None, enc_out=None)
    if cfg.family == "ssm":
        layers = _layer_cache(cfg, batch, max_len, dt, dev, cfg.n_layers,
                              "m")
        return DecodeCache(layers=layers, dense_layers=None, enc_out=None)
    nd = _n_dense(cfg)
    layers = _layer_cache(cfg, batch, max_len, dt, dev, cfg.n_layers - nd)
    dense = _layer_cache(cfg, batch, max_len, dt, dev, nd) if nd else None
    return DecodeCache(layers=layers, dense_layers=dense, enc_out=None)


def _attn_block_decode(cfg, blk, x, cache, positions):
    h = L.rmsnorm(blk["ln1"], x, cfg.norm_eps)
    decode = ATT.mla_decode if cfg.mla else ATT.gqa_decode
    h, cache = decode(cfg, blk["attn"], h, cache, positions)
    x = x + h
    h, _ = _ffn(cfg, blk, L.rmsnorm(blk["ln2"], x, cfg.norm_eps))
    return x + h, cache


def _mamba_block_decode(cfg, blk, x, cache):
    h = L.rmsnorm(blk["ln1"], x, cfg.norm_eps)
    h, cache = SSM.mamba_decode(cfg, blk["mamba"], h, cache)
    x = x + h
    if "ffn" in blk:
        h, _ = _ffn(cfg, blk, L.rmsnorm(blk["ln2"], x, cfg.norm_eps))
        x = x + h
    return x, cache


def _layer(stacked, i):
    """Layer (or group) i of a stacked cache: views, written in place."""
    return type(stacked)(*(f[i] for f in stacked))


def _decode_blocks(cfg, blocks, x, stacked, positions):
    for g, blk in enumerate(blocks):
        if cfg.family == "ssm":
            x, _ = _mamba_block_decode(cfg, blk, x, _layer(stacked, g))
        elif cfg.family == "hybrid":
            for i, kind in enumerate(cfg.hybrid_group):
                sub, c = blk[f"sub{i}"], _layer(stacked[f"sub{i}"], g)
                x, _ = (_mamba_block_decode(cfg, sub, x, c) if kind == "m"
                        else _attn_block_decode(cfg, sub, x, c, positions))
        else:
            x, _ = _attn_block_decode(cfg, blk, x, _layer(stacked, g),
                                      positions)
    return x


def decode_step(cfg: ArchConfig, params, cache: DecodeCache, tokens,
                positions):
    """One decode step. tokens (B,1) int, positions (B,1) int, the same
    position for every row.  Returns (logits (B,1,V), cache), the cache
    updated in place."""
    _check_family(cfg)
    cd = torch_dtype(cfg.compute_dtype)
    x = L.embed(params["embed"], tokens, cfg.embed_scale).to(cd)
    if "dense_blocks" in params:
        x = _decode_blocks(cfg, params["dense_blocks"], x,
                           cache.dense_layers, positions)
    x = _decode_blocks(cfg, params["blocks"], x, cache.layers, positions)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = L.unembed_logits(params["embed"], x, real_vocab=cfg.vocab)
    return logits, cache


def _pad_piece(piece, max_len, dtype):
    """Left-align stacked prefill pieces into max_len buffers along the
    sequence axis, in ``dtype``: KV (L,B,H,S,hd) on axis 3, MLA
    (L,B,S,r) on axis 2; a Mamba piece (conv tail, recurrent state) has
    no sequence axis and passes through, cast; a hybrid dict piece by
    piece."""
    if isinstance(piece, dict):
        return {k: _pad_piece(v, max_len, dtype) for k, v in piece.items()}
    if isinstance(piece, SSM.MambaCache):
        return SSM.MambaCache(*(f.to(dtype) for f in piece))
    axis = 3 if isinstance(piece, ATT.KVCache) else 2

    def pad(x):
        widths = [0, 0] * (x.ndim - 1 - axis) + [0, max_len - x.shape[axis]]
        return torch.nn.functional.pad(x, widths).to(dtype)

    return type(piece)(*(pad(f) for f in piece))


def prefill(cfg: ArchConfig, params, tokens, max_len):
    """Run the full prompt once, returning (last-token logits, a decode
    cache valid for positions < S, next position S).  The KV / latent /
    Mamba pieces are captured in the same pass as the forward, the KV and
    latent ones left-aligned into max_len buffers, all in the compute
    dtype."""
    S = tokens.shape[1]
    x, _, (pieces, dense_pieces, _) = forward_train(cfg, params, tokens,
                                                    collect_cache=True)
    logits = L.unembed_logits(params["embed"], x[:, -1:],
                              real_vocab=cfg.vocab)
    cd = torch_dtype(cfg.compute_dtype)
    dense = (_pad_piece(dense_pieces, max_len, cd)
             if dense_pieces is not None else None)
    return logits, DecodeCache(layers=_pad_piece(pieces, max_len, cd),
                               dense_layers=dense, enc_out=None), S
