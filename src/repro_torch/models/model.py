"""Model assembly for every family of ``configs/``: ``dense``, ``moe``,
``ssm``, ``hybrid``, ``encdec`` (whisper) and ``vlm`` (InternVL2):
parameters, the train / prefill forward, and decode.  Port of the
meshless paths of the reference's ``repro.models.model``.

The reference stacks its layers on a leading ``layers`` axis and runs
them under ``lax.scan``; here the parameter tree is an ``nn.Module``
with one block per layer (``params["blocks"][i]``, and deepseek's
leading dense layers in ``params["dense_blocks"][i]``), and a Python
loop runs them.  A hybrid (jamba) model holds one entry a group of
``cfg.hybrid_group``: ``params["blocks"][g]["sub{i}"]`` is the i-th
layer of group g, a Mamba2 block ("m") or an attention block ("a"),
with a MoE FFN at odd positions and the dense MLP at even ones.  An
encdec model also holds ``params["enc_blocks"][i]`` (the encoder's
non-causal blocks), ``enc_pos`` and ``enc_norm``, and each decoder block
a cross-attention (``xattn``, pre-normed by ``ln_x``) over the encoder's
output.  The norm (RMSNorm or whisper's LayerNorm) and the positions
(RoPE, or a learned ``pos_embed`` table) follow the config.

The reference stubs the front ends: an encdec model takes precomputed
frames (B, enc_seq, d_model) (``enc_frames``), a vlm model precomputed
patch embeddings (B, P, d_model) (``extra_embeds``), prepended to the
token embeddings, so its sequence and its cache hold P + S positions.

The decode cache keeps the reference's layout, stacked over the layers
of each run of blocks: one ``KVCache`` (k and v (L, B, Hkv, Smax, hd))
or, under MLA, one ``MLACache`` (c_kv (L, B, Smax, rank), k_rope (L,
B, Smax, rope)); for the ssm family one ``MambaCache`` (conv (L, B,
d_conv-1, conv_dim), state (L, B, nh, hp, N)); for the hybrid family a
dict ``sub{i}`` of ``MambaCache`` / ``KVCache``, each stacked over the
groups.  An encdec cache also holds the encoder's output,
``enc_out={"mem": (B, enc_seq, d)}``, which every decode step's
cross-attention reads.  ``decode_step`` writes into it in place.

Every forward returns (hidden_states, aux), aux the sum of the MoE
layers' load-balancing losses (0 for the other families).  ``loss_fn``
is the training loss over it; under ``cfg.remat == "full"`` (the full
configs) each block, hybrid group and encoder block is recomputed in
the backward (``_maybe_remat``).

``prefill`` returns the next position P + S for a vlm model, the patches
counted; the reference returns S there, a position its own forward
does not continue from (ROADMAP.md queue 3 lists the fault).
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.device import DeviceLike, resolve_device, torch_dtype
from repro_torch.models import attention as ATT
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as SSM
from repro_torch.models import moe as MOE
from repro_torch.models.config import ArchConfig


def _check_family(cfg: ArchConfig) -> None:
    plain = cfg.moe is None and cfg.mla is None and cfg.ssm is None
    dense = cfg.family in ("dense", "vlm") and plain
    moe = cfg.family == "moe" and cfg.moe is not None
    ssm = cfg.family == "ssm" and cfg.ssm is not None and cfg.moe is None
    hybrid = (cfg.family == "hybrid" and cfg.ssm is not None
              and cfg.moe is not None and cfg.mla is None
              and bool(cfg.hybrid_group))
    encdec = cfg.family == "encdec" and plain and cfg.enc_layers > 0
    if not (dense or moe or ssm or hybrid or encdec):
        raise ValueError(f"{cfg.name}: family {cfg.family!r} with moe="
                         f"{cfg.moe}, mla={cfg.mla}, ssm={cfg.ssm}, "
                         f"enc_layers={cfg.enc_layers} is not a model "
                         "this module assembles")


def _n_dense(cfg: ArchConfig) -> int:
    """Leading dense blocks of a moe model (deepseek's first_dense)."""
    return cfg.moe.first_dense if cfg.family == "moe" else 0


# ================================================================ params

def _norm_ab(cfg):
    return (L.layernorm_ab(cfg.d_model) if cfg.norm == "layernorm"
            else L.rmsnorm_ab(cfg.d_model))


def _apply_norm(cfg, p, x):
    return (L.layernorm(p, x, cfg.norm_eps) if cfg.norm == "layernorm"
            else L.rmsnorm(p, x, cfg.norm_eps))


def _attn_block_ab(cfg, ffn: str, cross: bool = False):
    blk = {"ln1": _norm_ab(cfg), "ln2": _norm_ab(cfg),
           "attn": ATT.mla_ab(cfg) if cfg.mla else ATT.gqa_ab(cfg)}
    if cross:
        blk["ln_x"] = _norm_ab(cfg)
        blk["xattn"] = ATT.gqa_ab(cfg)
    blk["ffn"] = (MOE.moe_ab(cfg) if ffn == "moe"
                  else L.mlp_ab(cfg.d_model, cfg.d_ff, cfg.gated))
    return blk


def _mamba_block_ab(cfg, ffn):
    blk = {"ln1": _norm_ab(cfg), "mamba": SSM.mamba_ab(cfg)}
    if ffn:
        blk["ln2"] = _norm_ab(cfg)
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
         "final_norm": _norm_ab(cfg)}
    if cfg.pos_embedding == "learned":
        p["pos_embed"] = {"table": L.PAb((cfg.max_position, cfg.d_model),
                                         (None, "embed"), "normal", 0.02)}
    if cfg.family == "encdec":
        p["enc_pos"] = {"table": L.PAb((cfg.enc_seq, cfg.d_model),
                                       (None, "embed"), "normal", 0.02)}
        p["enc_blocks"] = [_attn_block_ab(cfg, "mlp")
                           for _ in range(cfg.enc_layers)]
        p["enc_norm"] = _norm_ab(cfg)
        p["blocks"] = [_attn_block_ab(cfg, "mlp", cross=True)
                       for _ in range(cfg.n_layers)]
        return p
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


def _attn_block(cfg, blk, x, positions, causal=True, enc_out=None,
                collect=False):
    """Pre-norm attention block (train / prefill path), with a
    cross-attention over ``enc_out`` after the self-attention where given
    (whisper's decoder): (out, aux[, cache piece])."""
    h = _apply_norm(cfg, blk["ln1"], x)
    piece = None
    if cfg.mla:
        if collect:
            h, lat = ATT.mla_train(cfg, blk["attn"], h, positions,
                                   return_latent=True)
            piece = ATT.MLACache(c_kv=lat[0], k_rope=lat[1])
        else:
            h = ATT.mla_train(cfg, blk["attn"], h, positions)
    elif collect:
        h, kv = ATT.gqa_train(cfg, blk["attn"], h, positions, causal=causal,
                              return_kv=True)
        piece = ATT.KVCache(k=kv[0], v=kv[1])
    else:
        h = ATT.gqa_train(cfg, blk["attn"], h, positions, causal=causal)
    x = x + h
    if enc_out is not None:
        h = _apply_norm(cfg, blk["ln_x"], x)
        x = x + ATT.gqa_train(cfg, blk["xattn"], h, positions, causal=False,
                              kv_override=enc_out)
    h, aux = _ffn(cfg, blk, _apply_norm(cfg, blk["ln2"], x))
    out = x + h
    if collect:
        return out, aux, piece
    return out, aux


def _mamba_block(cfg, blk, x, collect=False):
    """Pre-norm Mamba2 block, its FFN (hybrid) after a second norm:
    (out, aux[, MambaCache piece])."""
    h = _apply_norm(cfg, blk["ln1"], x)
    piece = None
    if collect:
        h, piece = SSM.mamba_train(cfg, blk["mamba"], h, return_state=True)
    else:
        h = SSM.mamba_train(cfg, blk["mamba"], h)
    x = x + h
    aux = 0.0
    if "ffn" in blk:
        h, aux = _ffn(cfg, blk, _apply_norm(cfg, blk["ln2"], x))
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


def _block(cfg, blk, x, positions, collect, causal, enc_out):
    if cfg.family == "ssm":
        return _mamba_block(cfg, blk, x, collect=collect)
    if cfg.family == "hybrid":
        return _group_block(cfg, blk, x, positions, collect=collect)
    return _attn_block(cfg, blk, x, positions, causal=causal,
                       enc_out=enc_out, collect=collect)


def _maybe_remat(cfg, fn):
    """``fn`` recomputed in the backward when ``cfg.remat == "full"``
    (``torch.utils.checkpoint``, non-reentrant: only its inputs are kept
    for the backward), as the reference wraps each scanned block in
    ``jax.checkpoint``.  Without a gradient to record (serving) it runs
    ``fn`` as it is.  The model draws no random numbers, so the RNG
    state is not stashed."""
    if cfg.remat != "full":
        return fn

    def run(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False)

    return run


def _run_blocks(cfg, blocks, x, positions, collect, causal=True,
                enc_out=None):
    """(x, aux summed over the blocks, stacked pieces or None); each
    block (a hybrid model's: each group) under ``_maybe_remat``."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    pieces = []
    block = _maybe_remat(cfg, _block)
    for blk in blocks:
        out = block(cfg, blk, x, positions, collect, causal, enc_out)
        x, aux = out[0], aux + out[1]
        if collect:
            pieces.append(out[2])
    return x, aux, (_stack(pieces) if collect else None)


def _encode(cfg, params, enc_frames, cd):
    """The encoder of an encdec model: frames (B, enc_seq, d) plus the
    learned ``enc_pos``, non-causal blocks, ``enc_norm``."""
    if enc_frames is None or tuple(enc_frames.shape[1:]) != (cfg.enc_seq,
                                                            cfg.d_model):
        got = None if enc_frames is None else tuple(enc_frames.shape)
        raise ValueError(f"{cfg.name} takes enc_frames (B, {cfg.enc_seq}, "
                         f"{cfg.d_model}), got {got}")
    e = enc_frames.to(cd) + params["enc_pos"]["table"][None].to(cd)
    B, S = e.shape[:2]
    e_pos = torch.arange(S, device=e.device)[None].expand(B, S)
    e, _, _ = _run_blocks(cfg, params["enc_blocks"], e, e_pos, False,
                          causal=False)
    return _apply_norm(cfg, params["enc_norm"], e)


def forward_train(cfg: ArchConfig, params, tokens, extra_embeds=None,
                  enc_frames=None, collect_cache=False):
    """Train / prefill forward -> (hidden (B,S,D), aux[, cache pieces]).

    extra_embeds: (B, P, D) patch embeddings prepended (the vlm stub);
    the hidden states then cover P + S positions.  enc_frames: (B,
    enc_seq, D) audio frames (the encdec stub's input), which the encoder
    runs over; the decoder's blocks attend to its output.  aux is the sum
    of the MoE layers' load-balancing losses, 0 for the other families.
    collect_cache: also return the per-layer KV (MLA latent, Mamba conv
    tail and state) pieces, stacked along a leading layers axis (a
    hybrid model's: a dict ``sub{i}`` of pieces stacked over the groups),
    as ``(pieces, dense_pieces, enc_out)``; dense_pieces are those of
    deepseek's leading dense blocks, enc_out the encoder's output, else
    None."""
    _check_family(cfg)
    cd = torch_dtype(cfg.compute_dtype)
    x = L.embed(params["embed"], tokens, cfg.embed_scale).to(cd)
    if extra_embeds is not None:
        x = torch.cat([extra_embeds.to(cd), x], dim=1)
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)[None].expand(B, S)
    if cfg.pos_embedding == "learned":
        x = x + params["pos_embed"]["table"][:S][None].to(cd)
    enc_out = (_encode(cfg, params, enc_frames, cd)
               if cfg.family == "encdec" else None)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    dense_pieces = None
    if "dense_blocks" in params:
        x, a, dense_pieces = _run_blocks(cfg, params["dense_blocks"], x,
                                         positions, collect_cache)
        aux = aux + a
    x, a, pieces = _run_blocks(cfg, params["blocks"], x, positions,
                               collect_cache, enc_out=enc_out)
    aux = aux + a
    x = _apply_norm(cfg, params["final_norm"], x)
    if collect_cache:
        return x, aux, (pieces, dense_pieces, enc_out)
    return x, aux


def loss_fn(cfg: ArchConfig, params, tokens, labels, extra_embeds=None,
            enc_frames=None, aux_weight=0.01):
    """The training loss: (nll + aux_weight * aux, (nll, aux)), nll the
    mean next-token NLL (``chunked_xent``, labels of -100 masked), aux
    the MoE layers' load-balancing loss.  A vlm model takes the loss on
    its text positions only, after the P patches."""
    x, aux = forward_train(cfg, params, tokens, extra_embeds=extra_embeds,
                           enc_frames=enc_frames)
    if extra_embeds is not None:
        x = x[:, extra_embeds.shape[1]:]
    nll = L.chunked_xent(params["embed"], x, labels, real_vocab=cfg.vocab)
    return nll + aux_weight * aux, (nll, aux)


# ================================================================ decode

class DecodeCache(NamedTuple):
    layers: Any            # KVCache, MLACache or MambaCache stacked over
                           # layers; hybrid: a dict sub{i} of them stacked
                           # over groups
    dense_layers: Any      # the same for deepseek's leading dense blocks
    enc_out: Any           # encdec: {"mem": (B, enc_seq, d)}, else None


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
    enc = ({"mem": torch.zeros((batch, cfg.enc_seq, cfg.d_model), dtype=dt,
                               device=dev)}
           if cfg.family == "encdec" else None)
    return DecodeCache(layers=layers, dense_layers=dense, enc_out=enc)


def _attn_block_decode(cfg, blk, x, cache, positions, enc_mem=None):
    """One decode step of an attention block; with ``enc_mem`` its
    cross-attention recomputes the memory's k and v through ``gqa_train``
    at Sq = 1, as the reference does (one flash launch a layer)."""
    h = _apply_norm(cfg, blk["ln1"], x)
    decode = ATT.mla_decode if cfg.mla else ATT.gqa_decode
    h, cache = decode(cfg, blk["attn"], h, cache, positions)
    x = x + h
    if enc_mem is not None:
        h = _apply_norm(cfg, blk["ln_x"], x)
        x = x + ATT.gqa_train(cfg, blk["xattn"], h, positions, causal=False,
                              kv_override=enc_mem)
    h, _ = _ffn(cfg, blk, _apply_norm(cfg, blk["ln2"], x))
    return x + h, cache


def _mamba_block_decode(cfg, blk, x, cache):
    h = _apply_norm(cfg, blk["ln1"], x)
    h, cache = SSM.mamba_decode(cfg, blk["mamba"], h, cache)
    x = x + h
    if "ffn" in blk:
        h, _ = _ffn(cfg, blk, _apply_norm(cfg, blk["ln2"], x))
        x = x + h
    return x, cache


def _layer(stacked, i):
    """Layer (or group) i of a stacked cache: views, written in place."""
    return type(stacked)(*(f[i] for f in stacked))


def _decode_blocks(cfg, blocks, x, stacked, positions, enc_mem=None):
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
                                      positions, enc_mem)
    return x


def decode_step(cfg: ArchConfig, params, cache: DecodeCache, tokens,
                positions):
    """One decode step. tokens (B,1) int, positions (B,1) int, the same
    position for every row (for a vlm model it counts the patches).
    Returns (logits (B,1,V), cache), the cache updated in place."""
    _check_family(cfg)
    cd = torch_dtype(cfg.compute_dtype)
    x = L.embed(params["embed"], tokens, cfg.embed_scale).to(cd)
    if cfg.pos_embedding == "learned":
        pos = positions[0, :1].long()          # (1,), stays on the device
        x = x + params["pos_embed"]["table"][pos][None].to(cd)
    enc_mem = cache.enc_out["mem"].to(cd) if cache.enc_out else None
    if "dense_blocks" in params:
        x = _decode_blocks(cfg, params["dense_blocks"], x,
                           cache.dense_layers, positions)
    x = _decode_blocks(cfg, params["blocks"], x, cache.layers, positions,
                       enc_mem)
    x = _apply_norm(cfg, params["final_norm"], x)
    logits = L.unembed_logits(params["embed"], x, real_vocab=cfg.vocab)
    return logits, cache


def _pad_piece(piece, max_len, dtype):
    """Left-align stacked prefill pieces into max_len buffers along the
    sequence axis, in ``dtype``: KV (L,B,H,S,hd) on axis 3, MLA
    (L,B,S,r) on axis 2; a Mamba piece (conv tail, recurrent state) has
    no sequence axis and passes through, cast; a hybrid dict piece by
    piece.  A piece longer than max_len raises a ValueError."""
    if isinstance(piece, dict):
        return {k: _pad_piece(v, max_len, dtype) for k, v in piece.items()}
    if isinstance(piece, SSM.MambaCache):
        return SSM.MambaCache(*(f.to(dtype) for f in piece))
    axis = 3 if isinstance(piece, ATT.KVCache) else 2
    if piece[0].shape[axis] > max_len:
        raise ValueError(f"{piece[0].shape[axis]} cached positions exceed "
                         f"max_len {max_len}")

    def pad(x):
        widths = [0, 0] * (x.ndim - 1 - axis) + [0, max_len - x.shape[axis]]
        return torch.nn.functional.pad(x, widths).to(dtype)

    return type(piece)(*(pad(f) for f in piece))


def prefill(cfg: ArchConfig, params, tokens, max_len, enc_frames=None,
            extra_embeds=None):
    """Run the full prompt once, returning (last-token logits, a decode
    cache valid for positions < N, the next position N).  N is S, or
    P + S with P patch embeddings (``extra_embeds``) prepended: the
    cache holds them too.  (The reference returns S there; decoding
    from it overwrites a cached prompt entry.)  The KV / latent / Mamba
    pieces are captured in the same pass as the forward, the KV and
    latent ones left-aligned into max_len buffers, all in the compute
    dtype; an encdec model's encoder output goes into the cache."""
    S = tokens.shape[1]
    x, _, (pieces, dense_pieces, enc_out) = forward_train(
        cfg, params, tokens, extra_embeds=extra_embeds,
        enc_frames=enc_frames, collect_cache=True)
    logits = L.unembed_logits(params["embed"], x[:, -1:],
                              real_vocab=cfg.vocab)
    cd = torch_dtype(cfg.compute_dtype)
    dense = (_pad_piece(dense_pieces, max_len, cd)
             if dense_pieces is not None else None)
    enc = {"mem": enc_out.to(cd)} if enc_out is not None else None
    nxt = S + (extra_embeds.shape[1] if extra_embeds is not None else 0)
    return logits, DecodeCache(layers=_pad_piece(pieces, max_len, cd),
                               dense_layers=dense, enc_out=enc), nxt
