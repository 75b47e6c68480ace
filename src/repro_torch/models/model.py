"""Model assembly for the ``dense`` family: parameters, the train /
prefill forward, and decode.  Port of the dense path of the reference's
``repro.models.model``.

The reference stacks its layers on a leading ``layers`` axis and runs
them under ``lax.scan``; here the parameter tree is an ``nn.Module``
with one block per layer (``params["blocks"][i]``), and a Python loop
runs them.  The decode cache keeps the reference's layout: one
``KVCache`` whose k and v are stacked over layers, (L, B, Hkv, Smax,
hd).  ``decode_step`` writes into it in place.

Other families (moe, ssm, hybrid, encdec, vlm) raise NotImplementedError
naming ROADMAP.md queue 1, item 17.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.device import DeviceLike, resolve_device, torch_dtype
from repro_torch.models import attention as ATT
from repro_torch.models import layers as L
from repro_torch.models.config import ArchConfig


def _check_family(cfg: ArchConfig) -> None:
    if cfg.family != "dense" or cfg.mla is not None or cfg.moe is not None:
        raise NotImplementedError(
            f"the {cfg.family} family ({cfg.name}) {ATT.NOT_PORTED}")
    if cfg.norm != "rmsnorm" or cfg.pos_embedding != "rope":
        raise NotImplementedError(
            f"{cfg.norm} / {cfg.pos_embedding} positions ({cfg.name}) "
            f"{ATT.NOT_PORTED}")


# ================================================================ params

def _attn_block_ab(cfg):
    return {"ln1": L.rmsnorm_ab(cfg.d_model), "ln2": L.rmsnorm_ab(cfg.d_model),
            "attn": ATT.gqa_ab(cfg),
            "ffn": L.mlp_ab(cfg.d_model, cfg.d_ff, cfg.gated)}


def abstract_params(cfg: ArchConfig) -> dict:
    _check_family(cfg)
    return {
        "embed": L.embedding_ab(cfg.vocab, cfg.d_model,
                                pad_to=cfg.vocab_pad_to),
        "final_norm": L.rmsnorm_ab(cfg.d_model),
        "blocks": [_attn_block_ab(cfg) for _ in range(cfg.n_layers)],
    }


def init_params(cfg: ArchConfig, seed: int = 0, device: DeviceLike = None,
                dtype=None) -> L.ParamTree:
    """The parameter tree in ``dtype`` (default ``cfg.params_dtype``),
    drawn on the device from a ``torch.Generator`` seeded with ``seed``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return L.ParamTree(abstract_params(cfg), gen, dev,
                       torch_dtype(dtype or cfg.params_dtype))


# ================================================================ blocks

def _attn_block(cfg, blk, x, positions, collect=False):
    """Pre-norm attention block (train / prefill path)."""
    h = L.rmsnorm(blk["ln1"], x, cfg.norm_eps)
    piece = None
    if collect:
        h, kv = ATT.gqa_train(cfg, blk["attn"], h, positions,
                              return_kv=True)
        piece = ATT.KVCache(k=kv[0], v=kv[1])
    else:
        h = ATT.gqa_train(cfg, blk["attn"], h, positions)
    x = x + h
    h = L.rmsnorm(blk["ln2"], x, cfg.norm_eps)
    out = x + L.mlp(blk["ffn"], h, cfg.act, cfg.gated)
    if collect:
        return out, piece
    return out


def forward_train(cfg: ArchConfig, params, tokens, collect_cache=False):
    """Train / prefill forward -> (hidden (B,S,D), aux[, cache pieces]).

    aux is the MoE load-balancing loss of the reference, 0 for the dense
    family.  collect_cache: also return the per-layer KV pieces, stacked
    along a leading layers axis, as ``(KVCache, None, None)`` (the
    reference's (pieces, dense_pieces, enc_out))."""
    _check_family(cfg)
    cd = torch_dtype(cfg.compute_dtype)
    x = L.embed(params["embed"], tokens, cfg.embed_scale).to(cd)
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)[None].expand(B, S)
    pieces = []
    for blk in params["blocks"]:
        if collect_cache:
            x, piece = _attn_block(cfg, blk, x, positions, collect=True)
            pieces.append(piece)
        else:
            x = _attn_block(cfg, blk, x, positions)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if collect_cache:
        stacked = ATT.KVCache(k=torch.stack([p.k for p in pieces]),
                              v=torch.stack([p.v for p in pieces]))
        return x, aux, (stacked, None, None)
    return x, aux


# ================================================================ decode

class DecodeCache(NamedTuple):
    layers: Any            # KVCache stacked over layers
    dense_layers: Any      # deepseek's leading dense blocks: None here
    enc_out: Any           # encdec cross-attention memory: None here


def cache_zeros(cfg: ArchConfig, batch, max_len, dtype=torch.bfloat16,
                device: DeviceLike = None) -> DecodeCache:
    _check_family(cfg)
    dev = resolve_device(device)
    one = ATT.gqa_init_cache(cfg, batch, max_len, torch_dtype(dtype), dev)
    layers = ATT.KVCache(
        k=one.k[None].repeat(cfg.n_layers, 1, 1, 1, 1),
        v=one.v[None].repeat(cfg.n_layers, 1, 1, 1, 1))
    return DecodeCache(layers=layers, dense_layers=None, enc_out=None)


def _attn_block_decode(cfg, blk, x, cache, positions):
    h = L.rmsnorm(blk["ln1"], x, cfg.norm_eps)
    h, cache = ATT.gqa_decode(cfg, blk["attn"], h, cache, positions)
    x = x + h
    h = L.rmsnorm(blk["ln2"], x, cfg.norm_eps)
    return x + L.mlp(blk["ffn"], h, cfg.act, cfg.gated), cache


def decode_step(cfg: ArchConfig, params, cache: DecodeCache, tokens,
                positions):
    """One decode step. tokens (B,1) int, positions (B,1) int, the same
    position for every row.  Returns (logits (B,1,V), cache), the cache
    updated in place."""
    _check_family(cfg)
    cd = torch_dtype(cfg.compute_dtype)
    x = L.embed(params["embed"], tokens, cfg.embed_scale).to(cd)
    for i, blk in enumerate(params["blocks"]):
        layer = ATT.KVCache(k=cache.layers.k[i], v=cache.layers.v[i])
        x, _ = _attn_block_decode(cfg, blk, x, layer, positions)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = L.unembed_logits(params["embed"], x, real_vocab=cfg.vocab)
    return logits, cache


def _pad_piece(piece: ATT.KVCache, max_len) -> ATT.KVCache:
    """Left-align stacked prefill pieces (L, B, H, S, hd) into max_len
    buffers along the sequence axis."""
    def pad(x):
        return torch.nn.functional.pad(x, (0, 0, 0, max_len - x.shape[3]))

    return ATT.KVCache(k=pad(piece.k), v=pad(piece.v))


def prefill(cfg: ArchConfig, params, tokens, max_len):
    """Run the full prompt once, returning (last-token logits, a decode
    cache valid for positions < S, next position S).  The KV pieces are
    captured in the same pass as the forward and left-aligned into
    max_len buffers in the compute dtype."""
    S = tokens.shape[1]
    x, _, (pieces, _, _) = forward_train(cfg, params, tokens,
                                         collect_cache=True)
    logits = L.unembed_logits(params["embed"], x[:, -1:],
                              real_vocab=cfg.vocab)
    cd = torch_dtype(cfg.compute_dtype)
    padded = _pad_piece(pieces, max_len)
    layers = ATT.KVCache(k=padded.k.to(cd), v=padded.v.to(cd))
    return logits, DecodeCache(layers=layers, dense_layers=None,
                               enc_out=None), S
