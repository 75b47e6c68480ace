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

Under a mesh (``launch.mesh``; every family) the forward is explicit
SPMD, each rank holding its block of every parameter
(``param_shardings``; ``init_params(..., mesh=)`` draws them) and of
the decode cache (``cache_logical``).  The entry points take the global
tokens and positions and compute on this rank's batch block; the
embedding is vocabulary-sharded, the attention and MLP projections
column- / row-parallel, the MoE one of its three schedules
(``moe.moe_block``), a Mamba2 layer head-parallel
(``mamba2.mamba_train``), and between blocks the residual stream is
split over the sequence where ``("batch", "seq_sp", None)`` resolves so
(``layers.Placement``): each block, or each layer of a hybrid group,
all-gathers it before its projections and reduce-scatters its
row-parallel sums back.  An encdec model's encoder runs the same way
over its frames, its output gathered whole over the sequence for the
decoder's cross-attention (column-parallel over the heads, as the
self-attention); a vlm model's patches join the tokens before the
blocks, so its layouts cover P + S positions.  They
return this rank's blocks: ``forward_train`` the hidden states in that
layout, ``prefill`` / ``decode_step`` this rank's vocabulary block of
the logits (``layers.vocab_argmax`` is the greedy pick across ranks)
and the cache in ``cache_logical``'s layout (``DecodeCache.max_len``
keeps its global length), ``loss_fn`` the global batch's loss.  Every collective on the way
has its adjoint as its gradient, so ``loss_fn`` trains over the mesh
(``train.loop`` states the rule).
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.device import DeviceLike, resolve_device, torch_dtype
from repro_torch.dist.sharding import named_sharding, relayout, resolve_spec
from repro_torch.launch import mesh as _mesh
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
                dtype=None, mesh=None) -> L.ParamTree:
    """The parameter tree in ``dtype`` (default ``cfg.params_dtype``),
    drawn on the device from a ``torch.Generator`` seeded with ``seed``;
    under a mesh each leaf is this rank's block of the same global
    tree (``param_shardings``).  On the meta device (the dry run) the
    leaves are shapes: nothing is drawn."""
    dev = resolve_device(device)
    gen = (None if dev.type == "meta"
           else torch.Generator(device=dev).manual_seed(seed))
    return L.ParamTree(abstract_params(cfg), gen, dev,
                       torch_dtype(dtype or cfg.params_dtype), mesh)


def param_shapes(cfg: ArchConfig, dtype=None) -> dict:
    """Every parameter's global shape as a meta tensor in ``dtype``
    (default ``cfg.params_dtype``), in the structure of
    ``abstract_params``: one entry a layer where the reference stacks
    them on a leading ``layers`` axis."""
    return L.shape_tree(abstract_params(cfg), dtype or cfg.params_dtype)


def param_shardings(cfg: ArchConfig, mesh):
    """The ``NamedSharding`` of every parameter, in the structure of
    ``abstract_params``."""
    return L.spec_tree(abstract_params(cfg), mesh)


def param_specs(cfg: ArchConfig, mesh) -> dict:
    """The ``NamedSharding`` of every parameter by its ``state_dict``
    name."""
    return dict(L.named_leaves(param_shardings(cfg, mesh)))


def _table_sharding(cfg: ArchConfig, mesh):
    if mesh is None:
        return None
    return named_sharding((cfg.padded_vocab, cfg.d_model), ("vocab", "embed"),
                          mesh)


# ================================================================ blocks

def _ffn(cfg, blk, h, mesh=None, place=None):
    """The block's FFN: (out, aux); aux is 0.0 for a dense MLP.  Under a
    mesh ``h`` is this rank's block as ``place`` lays it, and so is the
    output."""
    if "router" in blk["ffn"]:
        return MOE.moe_block(cfg, blk["ffn"], h, mesh, place=place)
    if mesh is None:
        return L.mlp(blk["ffn"], h, cfg.act, cfg.gated), 0.0
    # column-parallel up / gate over the whole sequence, row-parallel down
    p = blk["ffn"]
    f_ent = L.spec_entry((cfg.d_model, cfg.d_ff), ("embed", "mlp"), mesh, 1)
    b_ent = L.entry_of(place.batch)
    h = relayout(h, mesh, place.spec(), (b_ent, None))
    y = L.mlp(p, h, cfg.act, cfg.gated)
    return L.finish_row_parallel(y, mesh, place, b_ent, L.axes_of(f_ent),
                                 bool(place.seq)), 0.0


def _attn_block(cfg, blk, x, positions, causal=True, enc_out=None,
                collect=False, mesh=None, place_in=None, place=None):
    """Pre-norm attention block (train / prefill path), with a
    cross-attention over ``enc_out`` after the self-attention where given
    (whisper's decoder): (out, aux[, cache piece]).  Under a mesh ``x``
    is this rank's block as ``place_in`` lays it, the output as
    ``place`` (the layout between blocks)."""
    h = _apply_norm(cfg, blk["ln1"], x)
    kw = {}
    if mesh is not None:
        h = relayout(h, mesh, place_in.spec(), place.spec(seq=False))
        x = relayout(x, mesh, place_in.spec(), place.spec())
        kw = dict(mesh=mesh, place=place, seq_out=bool(place.seq))
    piece = None
    if cfg.mla:
        if collect:
            h, lat = ATT.mla_train(cfg, blk["attn"], h, positions,
                                   return_latent=True, **kw)
            piece = ATT.MLACache(c_kv=lat[0], k_rope=lat[1])
        else:
            h = ATT.mla_train(cfg, blk["attn"], h, positions, **kw)
    elif collect:
        h, kv = ATT.gqa_train(cfg, blk["attn"], h, positions, causal=causal,
                              return_kv=True, **kw)
        piece = ATT.KVCache(k=kv[0], v=kv[1])
    else:
        h = ATT.gqa_train(cfg, blk["attn"], h, positions, causal=causal, **kw)
    x = x + h
    if enc_out is not None:
        h = _apply_norm(cfg, blk["ln_x"], x)
        if mesh is not None:
            h = relayout(h, mesh, place.spec(), place.spec(seq=False))
        x = x + ATT.gqa_train(cfg, blk["xattn"], h, positions, causal=False,
                              kv_override=enc_out, **kw)
    h, aux = _ffn(cfg, blk, _apply_norm(cfg, blk["ln2"], x), mesh, place)
    out = x + h
    if collect:
        return out, aux, piece
    return out, aux


def _mamba_block(cfg, blk, x, collect=False, mesh=None, place_in=None,
                 place=None):
    """Pre-norm Mamba2 block, its FFN (hybrid) after a second norm:
    (out, aux[, MambaCache piece]).  Under a mesh as ``_attn_block``."""
    h = _apply_norm(cfg, blk["ln1"], x)
    kw = {}
    if mesh is not None:
        h = relayout(h, mesh, place_in.spec(), place.spec(seq=False))
        x = relayout(x, mesh, place_in.spec(), place.spec())
        kw = dict(place=place, seq_out=bool(place.seq))
    piece = None
    if collect:
        h, piece = SSM.mamba_train(cfg, blk["mamba"], h, mesh,
                                   return_state=True, **kw)
    else:
        h = SSM.mamba_train(cfg, blk["mamba"], h, mesh, **kw)
    x = x + h
    aux = 0.0
    if "ffn" in blk:
        h, aux = _ffn(cfg, blk, _apply_norm(cfg, blk["ln2"], x), mesh,
                      place)
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


def _group_block(cfg, group, x, positions, collect=False, mesh=None,
                 place_in=None, place=None):
    """One hybrid group, its layers in ``cfg.hybrid_group`` order:
    (out, aux[, dict sub{i} of pieces]).  Under a mesh ``x`` comes in as
    ``place_in`` lays it, and every layer hands the next its output as
    ``place`` lays it (``seq_sp`` between a Mamba2 layer and an
    attention or MoE layer alike)."""
    aux = 0.0
    pieces = {}
    for i, kind in enumerate(cfg.hybrid_group):
        sub = group[f"sub{i}"]
        kw = dict(collect=collect, mesh=mesh, place_in=place_in, place=place)
        out = (_mamba_block(cfg, sub, x, **kw) if kind == "m"
               else _attn_block(cfg, sub, x, positions, **kw))
        x, aux = out[0], aux + out[1]
        place_in = place
        if collect:
            pieces[f"sub{i}"] = out[2]
    if collect:
        return x, aux, pieces
    return x, aux


def _block(cfg, blk, x, positions, collect, causal, enc_out, mesh=None,
           place_in=None, place=None):
    if cfg.family == "ssm":
        return _mamba_block(cfg, blk, x, collect=collect, mesh=mesh,
                            place_in=place_in, place=place)
    if cfg.family == "hybrid":
        return _group_block(cfg, blk, x, positions, collect=collect,
                            mesh=mesh, place_in=place_in, place=place)
    return _attn_block(cfg, blk, x, positions, causal=causal,
                       enc_out=enc_out, collect=collect, mesh=mesh,
                       place_in=place_in, place=place)


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
                enc_out=None, mesh=None, place_in=None, place=None):
    """(x, aux summed over the blocks, stacked pieces or None); each
    block (a hybrid model's: each group) under ``_maybe_remat``.  Under
    a mesh ``x`` comes in as ``place_in`` lays it and leaves as
    ``place``."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    pieces = []
    block = _maybe_remat(cfg, _block)
    for blk in blocks:
        out = block(cfg, blk, x, positions, collect, causal, enc_out, mesh,
                    place_in, place)
        x, aux = out[0], aux + out[1]
        place_in = place
        if collect:
            pieces.append(out[2])
    return x, aux, (_stack(pieces) if collect else None)


def _encode(cfg, params, enc_frames, cd, mesh=None, B: int = 0):
    """The encoder of an encdec model: frames (B, enc_seq, d) plus the
    learned ``enc_pos``, non-causal blocks, ``enc_norm``.  Under a mesh
    ``enc_frames`` is this rank's batch block of the global ``B`` and so
    is the output, whole over the sequence (the cross-attention's
    memory); between the encoder's blocks its sequence is split as
    ``seq_sp`` resolves over ``enc_seq``."""
    if enc_frames is None or tuple(enc_frames.shape[1:]) != (cfg.enc_seq,
                                                            cfg.d_model):
        got = None if enc_frames is None else tuple(enc_frames.shape)
        raise ValueError(f"{cfg.name} takes enc_frames (B, {cfg.enc_seq}, "
                         f"{cfg.d_model}), got {got}")
    e = enc_frames.to(cd) + params["enc_pos"]["table"][None].to(cd)
    B, S = e.shape[:2]
    e_pos = torch.arange(S, device=e.device)[None].expand(B, S)
    kw = {}
    if mesh is not None:
        place = L.Placement.between_blocks(mesh, B, S, cfg.d_model)
        kw = dict(mesh=mesh, place_in=place.whole_seq(), place=place)
    e, _, _ = _run_blocks(cfg, params["enc_blocks"], e, e_pos, False,
                          causal=False, **kw)
    e = _apply_norm(cfg, params["enc_norm"], e)
    if mesh is not None:
        e = relayout(e, mesh, kw["place"].spec(), kw["place"].spec(seq=False))
    return e


def _placement(cfg: ArchConfig, mesh, tokens, extra_embeds=None):
    """The layout between blocks of a forward over the global ``tokens``
    (B, S), P patches prepended where ``extra_embeds`` (B, P, D)."""
    B, S = tokens.shape
    P = 0 if extra_embeds is None else extra_embeds.shape[1]
    return L.Placement.between_blocks(mesh, B, P + S, cfg.d_model)


def forward_train(cfg: ArchConfig, params, tokens, mesh=None,
                  extra_embeds=None, enc_frames=None, collect_cache=False):
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
    None.

    Under a mesh ``tokens`` is the global (B, S) batch; the hidden
    states returned are this rank's block as ``Placement.between_blocks``
    lays them, the pieces this rank's blocks (``gqa_kv_spec``'s layout,
    or the MLA latent's batch block)."""
    _check_family(cfg)
    cd = torch_dtype(cfg.compute_dtype)
    place = place_in = None
    B_all = tokens.shape[0]
    if mesh is not None:
        place = _placement(cfg, mesh, tokens, extra_embeds)
        place_in = place.whole_seq()
        b_ent = (L.entry_of(place.batch),)
        tokens = relayout(tokens, mesh, (), b_ent)
        if extra_embeds is not None:
            extra_embeds = relayout(extra_embeds, mesh, (), b_ent)
        if enc_frames is not None:
            enc_frames = relayout(enc_frames, mesh, (), b_ent)
    x = L.embed(params["embed"], tokens, cfg.embed_scale,
                _table_sharding(cfg, mesh)).to(cd)
    if extra_embeds is not None:
        x = torch.cat([extra_embeds.to(cd), x], dim=1)
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)[None].expand(B, S)
    if cfg.pos_embedding == "learned":
        x = x + params["pos_embed"]["table"][:S][None].to(cd)
    enc_out = (_encode(cfg, params, enc_frames, cd, mesh, B_all)
               if cfg.family == "encdec" else None)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    dense_pieces = None
    if "dense_blocks" in params:
        x, a, dense_pieces = _run_blocks(cfg, params["dense_blocks"], x,
                                         positions, collect_cache, mesh=mesh,
                                         place_in=place_in, place=place)
        aux = aux + a
        place_in = place
    x, a, pieces = _run_blocks(cfg, params["blocks"], x, positions,
                               collect_cache, enc_out=enc_out, mesh=mesh,
                               place_in=place_in, place=place)
    aux = aux + a
    x = _apply_norm(cfg, params["final_norm"], x)
    if collect_cache:
        return x, aux, (pieces, dense_pieces, enc_out)
    return x, aux


def loss_fn(cfg: ArchConfig, params, tokens, labels, mesh=None,
            extra_embeds=None, enc_frames=None, aux_weight=0.01):
    """The training loss: (nll + aux_weight * aux, (nll, aux)), nll the
    mean next-token NLL (``chunked_xent``, labels of -100 masked), aux
    the MoE layers' load-balancing loss.  A vlm model takes the loss on
    its text positions only, after the P patches.

    Under a mesh ``tokens`` and ``labels`` are the global batch and the
    loss is the global batch's on every rank; its gradient on a rank is
    that rank's share (the train step sums them over the batch axes)."""
    x, aux = forward_train(cfg, params, tokens, mesh,
                           extra_embeds=extra_embeds, enc_frames=enc_frames)
    P = 0 if extra_embeds is None else extra_embeds.shape[1]
    if mesh is None:
        nll = L.chunked_xent(params["embed"], x[:, P:], labels,
                             real_vocab=cfg.vocab)
        return nll + aux_weight * aux, (nll, aux)
    place = _placement(cfg, mesh, tokens, extra_embeds)
    x = relayout(x, mesh, place.spec(), place.spec(seq=False))[:, P:]
    labels = relayout(labels, mesh, (), (L.entry_of(place.batch),))
    nll = L.chunked_xent(params["embed"], x, labels, real_vocab=cfg.vocab,
                         sharding=_table_sharding(cfg, mesh), mesh=mesh,
                         token_axes=place.batch)
    return nll + aux_weight * aux, (nll, aux)


# ================================================================ decode

class DecodeCache(NamedTuple):
    layers: Any            # KVCache, MLACache or MambaCache stacked over
                           # layers; hybrid: a dict sub{i} of them stacked
                           # over groups
    dense_layers: Any      # the same for deepseek's leading dense blocks
    enc_out: Any           # encdec: {"mem": (B, enc_seq, d)}, else None
    max_len: Any = None    # under a mesh: the global positions held (the
                           # blocks are as cache_logical lays them)


def _cache_logical_one(cfg, kind="a"):
    if kind == "m":
        return SSM.mamba_cache_logical(cfg)
    if cfg.mla:
        return ATT.mla_cache_logical(cfg)
    return ATT.gqa_cache_logical(cfg)


def cache_logical(cfg: ArchConfig) -> DecodeCache:
    """The logical axes of every leaf of the decode cache, in its
    structure (a leading ``layers`` axis on each stacked leaf)."""
    def stack(one):
        return type(one)(*(("layers",) + tuple(f) for f in one))

    dense_layers, enc_out = None, None
    if cfg.family == "hybrid":
        layers = {f"sub{i}": stack(_cache_logical_one(cfg, kind))
                  for i, kind in enumerate(cfg.hybrid_group)}
    elif cfg.family == "ssm":
        layers = stack(_cache_logical_one(cfg, "m"))
    else:
        layers = stack(_cache_logical_one(cfg))
        if _n_dense(cfg):
            dense_layers = stack(_cache_logical_one(cfg))
    if cfg.family == "encdec":
        enc_out = {"mem": ("cache_batch", None, None)}
    return DecodeCache(layers=layers, dense_layers=dense_layers,
                       enc_out=enc_out)


def _layer_cache_spec(cfg, mesh, B: int, max_len: int):
    """The PartitionSpec of one layer's cache leaf (k, or MLA's c_kv)."""
    one = _cache_logical_one(cfg)
    if cfg.mla:
        shape = (B, max_len, cfg.mla.kv_lora_rank)
    else:
        shape = (B, cfg.n_kv_heads, max_len, cfg.resolved_head_dim)
    return resolve_spec(shape, one[0], mesh)


def _layer_cache(cfg, batch, max_len, dtype, device, n, kind="a"):
    if kind == "m":
        one = SSM.mamba_init_cache(cfg, batch, dtype, device)
    else:
        init = ATT.mla_init_cache if cfg.mla else ATT.gqa_init_cache
        one = init(cfg, batch, max_len, dtype, device)
    return type(one)(*(f[None].repeat(n, *(1,) * f.ndim) for f in one))


def cache_zeros(cfg: ArchConfig, batch, max_len, dtype=torch.bfloat16,
                device: DeviceLike = None) -> DecodeCache:
    """The decode cache, zeros, stacked over the layers of each run of
    blocks (the reference's layout, ``cache_logical``'s structure)."""
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


def cache_abstract(cfg: ArchConfig, batch, max_len,
                   dtype=torch.bfloat16) -> DecodeCache:
    """The decode cache's shapes and dtypes as meta tensors (the dry
    run's input): ``cache_zeros`` on the meta device, so the two trees
    cannot drift; the leading layers axis, deepseek's ``dense_layers``
    and whisper's ``enc_out["mem"]`` included."""
    return cache_zeros(cfg, batch, max_len, dtype, device="meta")


def _attn_block_decode(cfg, blk, x, cache, positions, enc_mem=None,
                       mesh=None, place=None, cache_spec=None):
    """One decode step of an attention block; with ``enc_mem`` its
    cross-attention recomputes the memory's k and v through ``gqa_train``
    at Sq = 1, as the reference does (one flash launch a layer)."""
    h = _apply_norm(cfg, blk["ln1"], x)
    decode = ATT.mla_decode if cfg.mla else ATT.gqa_decode
    if mesh is None:
        h, cache = decode(cfg, blk["attn"], h, cache, positions)
    else:
        h, cache = decode(cfg, blk["attn"], h, cache, positions, mesh,
                          place=place, cache_spec=cache_spec)
    x = x + h
    if enc_mem is not None:
        h = _apply_norm(cfg, blk["ln_x"], x)
        x = x + ATT.gqa_train(cfg, blk["xattn"], h, positions, mesh=mesh,
                              causal=False, kv_override=enc_mem, place=place)
    h, _ = _ffn(cfg, blk, _apply_norm(cfg, blk["ln2"], x), mesh, place)
    return x + h, cache


def _mamba_block_decode(cfg, blk, x, cache, mesh=None, place=None):
    h = _apply_norm(cfg, blk["ln1"], x)
    h, cache = SSM.mamba_decode(cfg, blk["mamba"], h, cache, mesh,
                                place=place)
    x = x + h
    if "ffn" in blk:
        h, _ = _ffn(cfg, blk, _apply_norm(cfg, blk["ln2"], x), mesh, place)
        x = x + h
    return x, cache


def _layer(stacked, i):
    """Layer (or group) i of a stacked cache: views, written in place."""
    return type(stacked)(*(f[i] for f in stacked))


def _decode_blocks(cfg, blocks, x, stacked, positions, enc_mem=None,
                   **mesh_kw):
    ssm_kw = {k: v for k, v in mesh_kw.items() if k != "cache_spec"}
    for g, blk in enumerate(blocks):
        if cfg.family == "ssm":
            x, _ = _mamba_block_decode(cfg, blk, x, _layer(stacked, g),
                                       **ssm_kw)
        elif cfg.family == "hybrid":
            for i, kind in enumerate(cfg.hybrid_group):
                sub, c = blk[f"sub{i}"], _layer(stacked[f"sub{i}"], g)
                x, _ = (_mamba_block_decode(cfg, sub, x, c, **ssm_kw)
                        if kind == "m" else
                        _attn_block_decode(cfg, sub, x, c, positions,
                                           **mesh_kw))
        else:
            x, _ = _attn_block_decode(cfg, blk, x, _layer(stacked, g),
                                      positions, enc_mem, **mesh_kw)
    return x


def decode_step(cfg: ArchConfig, params, cache: DecodeCache, tokens,
                positions, mesh=None):
    """One decode step. tokens (B,1) int, positions (B,1) int, the same
    position for every row (for a vlm model it counts the patches).
    Returns (logits (B,1,V), cache), the cache updated in place.

    Under a mesh ``tokens`` and ``positions`` are global, ``cache`` is
    this rank's (``prefill``'s under the same mesh) and the logits are
    this rank's vocabulary block of its batch block."""
    _check_family(cfg)
    cd = torch_dtype(cfg.compute_dtype)
    mesh_kw = {}
    if mesh is not None:
        if cache.max_len is None:
            raise ValueError("a decode step under a mesh takes the cache "
                             "prefill made under it (DecodeCache.max_len)")
        B = tokens.shape[0]
        place = L.Placement.between_blocks(mesh, B, 1, cfg.d_model)
        b_ent = (L.entry_of(place.batch),)
        tokens = relayout(tokens, mesh, (), b_ent)
        positions = relayout(positions, mesh, (), b_ent)
        mesh_kw = dict(mesh=mesh, place=place, cache_spec=_layer_cache_spec(
            cfg, mesh, B, cache.max_len))
    x = L.embed(params["embed"], tokens, cfg.embed_scale,
                _table_sharding(cfg, mesh)).to(cd)
    if cfg.pos_embedding == "learned":
        pos = positions[0, :1].long()          # (1,), stays on the device
        x = x + params["pos_embed"]["table"][pos][None].to(cd)
    enc_mem = cache.enc_out["mem"].to(cd) if cache.enc_out else None
    if "dense_blocks" in params:
        x = _decode_blocks(cfg, params["dense_blocks"], x,
                           cache.dense_layers, positions, **mesh_kw)
    x = _decode_blocks(cfg, params["blocks"], x, cache.layers, positions,
                       enc_mem, **mesh_kw)
    x = _apply_norm(cfg, params["final_norm"], x)
    logits = L.unembed_logits(params["embed"], x, real_vocab=cfg.vocab,
                              sharding=_table_sharding(cfg, mesh))
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


def _place_piece(cfg, piece, mesh, place, max_len: int):
    """A stacked prefill piece (this rank's block, the whole sequence,
    padded to max_len; a hybrid dict piece by piece) moved to the
    cache's layout.  A Mamba piece is already in it, its batch block
    moved where the cache's batch axes differ from the activations'."""
    if isinstance(piece, dict):
        return {k: _place_piece(cfg, v, mesh, place, max_len)
                for k, v in piece.items()}
    B, S = place.B, place.S
    b = L.entry_of(place.batch)
    if isinstance(piece, SSM.MambaCache):
        s, _, nh, conv_dim = SSM._dims(cfg)
        blk = SSM._blocks(cfg, mesh)
        logical = SSM.mamba_cache_logical(cfg)
        conv = resolve_spec((B, s.d_conv - 1, conv_dim), logical.conv, mesh)
        state = resolve_spec((B, nh, s.head_dim, s.d_state), logical.state,
                             mesh)
        return SSM.MambaCache(
            conv=relayout(piece.conv, mesh, (None, b, None, blk.conv),
                          (None,) + tuple(conv)),
            state=relayout(piece.state, mesh, (None, b, blk.heads),
                           (None,) + tuple(state)))
    if cfg.mla:
        src = (None, b)
    else:
        src = (None,) + tuple(ATT.gqa_kv_spec(cfg, mesh, B, S))
    dst = (None,) + tuple(_layer_cache_spec(cfg, mesh, B, max_len))
    return type(piece)(*(relayout(f, mesh, src, dst) for f in piece))


def prefill(cfg: ArchConfig, params, tokens, max_len, mesh=None,
            enc_frames=None, extra_embeds=None):
    """Run the full prompt once, returning (last-token logits, a decode
    cache valid for positions < N, the next position N).  N is S, or
    P + S with P patch embeddings (``extra_embeds``) prepended: the
    cache holds them too.  (The reference returns S there; decoding
    from it overwrites a cached prompt entry.)  The KV / latent / Mamba
    pieces are captured in the same pass as the forward, the KV and
    latent ones left-aligned into max_len buffers, all in the compute
    dtype; an encdec model's encoder output goes into the cache.

    Under a mesh ``tokens`` is the global batch; the logits are this
    rank's vocabulary block of its batch block, and the cache its
    blocks as ``cache_logical`` lays them (the KV pieces gathered over
    the kv heads and split over the positions where the cache is
    sequence-sharded)."""
    B, S = tokens.shape[0], tokens.shape[1]
    x, _, (pieces, dense_pieces, enc_out) = forward_train(
        cfg, params, tokens, mesh, extra_embeds=extra_embeds,
        enc_frames=enc_frames, collect_cache=True)
    last = x[:, -1:]
    if mesh is not None:
        place = _placement(cfg, mesh, tokens, extra_embeds)
        if place.seq:    # the last position is the last sequence block's
            last = _mesh.all_gather(mesh, last, place.seq, 1)[:, -1:]
    logits = L.unembed_logits(params["embed"], last, real_vocab=cfg.vocab,
                              sharding=_table_sharding(cfg, mesh))
    cd = torch_dtype(cfg.compute_dtype)
    layers = _pad_piece(pieces, max_len, cd)
    dense = (_pad_piece(dense_pieces, max_len, cd)
             if dense_pieces is not None else None)
    enc = {"mem": enc_out.to(cd)} if enc_out is not None else None
    if mesh is not None:
        layers = _place_piece(cfg, layers, mesh, place, max_len)
        if dense is not None:
            dense = _place_piece(cfg, dense, mesh, place, max_len)
        if enc is not None:
            enc = {"mem": relayout(enc["mem"], mesh, (L.entry_of(
                place.batch),), resolve_spec(
                    (B,) + tuple(enc["mem"].shape[1:]),
                    cache_logical(cfg).enc_out["mem"], mesh))}
    nxt = S + (extra_embeds.shape[1] if extra_embeds is not None else 0)
    return logits, DecodeCache(layers=layers, dense_layers=dense,
                               enc_out=enc,
                               max_len=None if mesh is None else max_len), nxt
