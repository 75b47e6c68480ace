"""Model assembly for the ``dense`` and ``moe`` families: parameters, the
train / prefill forward, and decode.  Port of the dense and moe paths of
the reference's ``repro.models.model``.

The reference stacks its layers on a leading ``layers`` axis and runs
them under ``lax.scan``; here the parameter tree is an ``nn.Module``
with one block per layer (``params["blocks"][i]``, and deepseek's
leading dense layers in ``params["dense_blocks"][i]``), and a Python
loop runs them.  The decode cache keeps the reference's layout: one
``KVCache`` (k and v (L, B, Hkv, Smax, hd)) or, under MLA, one
``MLACache`` (c_kv (L, B, Smax, rank), k_rope (L, B, Smax, rope))
stacked over the layers of each run of blocks.  ``decode_step`` writes
into it in place.

Every forward returns (hidden_states, aux), aux the sum of the MoE
layers' load-balancing losses (0 for the dense family).

Other families (ssm, hybrid, encdec, vlm) raise NotImplementedError
naming ROADMAP.md queue 1, item 17.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.device import DeviceLike, resolve_device, torch_dtype
from repro_torch.models import attention as ATT
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models.config import ArchConfig


def _check_family(cfg: ArchConfig) -> None:
    dense = cfg.family == "dense" and cfg.moe is None and cfg.mla is None
    moe = cfg.family == "moe" and cfg.moe is not None
    if not (dense or moe):
        raise NotImplementedError(
            f"the {cfg.family} family ({cfg.name}) {ATT.NOT_PORTED}")
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


def abstract_params(cfg: ArchConfig) -> dict:
    _check_family(cfg)
    p = {"embed": L.embedding_ab(cfg.vocab, cfg.d_model,
                                 pad_to=cfg.vocab_pad_to),
         "final_norm": L.rmsnorm_ab(cfg.d_model)}
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


def _stack(pieces):
    """Per-layer cache pieces (one NamedTuple each) stacked along a
    leading layers axis."""
    return type(pieces[0])(*(torch.stack(f) for f in zip(*pieces)))


def _run_blocks(cfg, blocks, x, positions, collect):
    """(x, aux summed over the blocks, stacked pieces or None)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    pieces = []
    for blk in blocks:
        out = _attn_block(cfg, blk, x, positions, collect=collect)
        x, aux = out[0], aux + out[1]
        if collect:
            pieces.append(out[2])
    return x, aux, (_stack(pieces) if collect else None)


def forward_train(cfg: ArchConfig, params, tokens, collect_cache=False):
    """Train / prefill forward -> (hidden (B,S,D), aux[, cache pieces]).

    aux is the sum of the MoE layers' load-balancing losses, 0 for the
    dense family.  collect_cache: also return the per-layer KV (or MLA
    latent) pieces, stacked along a leading layers axis, as
    ``(pieces, dense_pieces, None)`` (the reference's (pieces,
    dense_pieces, enc_out)); dense_pieces are those of deepseek's
    leading dense blocks, else None."""
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
    layers: Any            # KVCache or MLACache stacked over layers
    dense_layers: Any      # the same for deepseek's leading dense blocks
    enc_out: Any           # encdec cross-attention memory: None here


def _layer_cache(cfg, batch, max_len, dtype, device, n):
    init = ATT.mla_init_cache if cfg.mla else ATT.gqa_init_cache
    one = init(cfg, batch, max_len, dtype, device)
    return type(one)(*(f[None].repeat(n, *(1,) * f.ndim) for f in one))


def cache_zeros(cfg: ArchConfig, batch, max_len, dtype=torch.bfloat16,
                device: DeviceLike = None) -> DecodeCache:
    _check_family(cfg)
    dev = resolve_device(device)
    dt = torch_dtype(dtype)
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


def _decode_blocks(cfg, blocks, x, stacked, positions):
    for i, blk in enumerate(blocks):
        layer = type(stacked)(*(f[i] for f in stacked))    # views
        x, _ = _attn_block_decode(cfg, blk, x, layer, positions)
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
    (L,B,S,r) on axis 2."""
    axis = 3 if isinstance(piece, ATT.KVCache) else 2

    def pad(x):
        widths = [0, 0] * (x.ndim - 1 - axis) + [0, max_len - x.shape[axis]]
        return torch.nn.functional.pad(x, widths).to(dtype)

    return type(piece)(*(pad(f) for f in piece))


def prefill(cfg: ArchConfig, params, tokens, max_len):
    """Run the full prompt once, returning (last-token logits, a decode
    cache valid for positions < S, next position S).  The KV / latent
    pieces are captured in the same pass as the forward and left-aligned
    into max_len buffers in the compute dtype."""
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
