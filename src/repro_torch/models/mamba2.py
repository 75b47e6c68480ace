"""Mamba-2 block via SSD (state-space duality, Dao & Gu 2024).  Port of
the reference's ``repro.models.mamba2``.

Train / prefill path: the chunked SSD, an intra-chunk quadratic
(attention-like) term plus an inter-chunk state recurrence (a Python
loop over the chunks, as the reference's ``lax.scan``).  Decode path:
the O(1) recurrent state update a token.  Both share parameters.

Shapes: d_inner = expand * d_model, nh = d_inner / head_dim heads,
state N = d_state, G groups (B / C shared by the heads of a group).

Precision, as the reference: the decay and cumsum math runs in fp32,
the heavy products in the compute dtype, the chunk states and their
recurrence in fp32; ``mamba_train`` returns the final state in the
compute dtype, and ``mamba_decode`` runs its step in fp32 and stores
the state back in the cache's dtype (a bf16 cache rounds the state at
every step, as the reference's does).  The reference repeats B and C
over the heads of a group (``jnp.repeat``); here each head reads its
group's B / C by broadcasting, which computes the same and at
Jamba's 256 heads saves 256 copies of each.  softplus is
``logaddexp(x, 0)``, as ``jax.nn.softplus`` (torch's ``softplus``
returns x itself above a threshold).

The reference has no Pallas kernel for the SSD: its einsums stay plain
torch products here, as the reference computes them outside any
kernel.  ``mamba_decode`` writes the new conv window and state into
the cache in place (the reference returns an updated copy), as
``attention.gqa_decode`` does.  ``mamba_cache_logical`` gives the
cache's logical axes and ``mamba_cache_abstract`` its shapes on the
meta device (the dry run's).

Under a mesh (explicit SPMD, ``launch.mesh``; the reference leaves its
``mesh`` argument unused and GSPMD shards by the constraints around
the block) each rank holds the parameter blocks ``resolve_spec`` gives
it, which the dry run holds to the reference's bytes: ``in_proj``'s
and ``conv_w``'s ``"mlp"`` axis is a contiguous block of the
concatenated ``[z|x|B|C|dt]`` and ``[x|B|C]`` columns, not a block of
heads.  So a rank:

  * projects its column block of ``in_proj`` and all-gathers the
    columns (the projection is small beside the SSD);
  * runs the depthwise conv on its own ``conv_w`` channel block (its
    conv cache block too) and all-gathers the conv output;
  * takes its block of heads (``"heads"`` over ``model`` where they
    divide it, else all of them): their x, z and dt columns, and B and
    C whole (one group serves every head), and runs the SSD on them;
  * takes the gated RMSNorm over the whole ``d_inner``: its sum of
    squares is summed over the heads' ranks;
  * multiplies its rows of ``out_proj`` (row-parallel over ``"mlp"``,
    the same block of ``d_inner`` as its heads) and reduces the partial
    sums as the attention's ``wo`` does (a reduce-scatter over the
    sequence under ``seq_sp``, else an all-reduce).

The cache follows ``mamba_cache_logical``: the conv inputs over
``"mlp"`` (the conv's channel block), the state over ``"heads"``.

The reference reshapes a prompt into ``S // chunk`` chunks of
``min(ssm.chunk, S)`` tokens, so a prompt longer than one chunk whose
length is not a multiple of it fails there; ``ssd_chunked`` raises a
ValueError for it (serving such a length would be a feature the
reference lacks).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.device import torch_dtype
from repro_torch.dist.sharding import relayout
from repro_torch.launch import mesh as _mesh
from repro_torch.models import layers as L
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import PAb, Placement


def _dims(cfg: ArchConfig):
    s = cfg.ssm
    di = s.expand * cfg.d_model
    nh = di // s.head_dim
    conv_dim = di + 2 * s.n_groups * s.d_state
    return s, di, nh, conv_dim


def mamba_ab(cfg: ArchConfig):
    s, di, nh, conv_dim = _dims(cfg)
    d = cfg.d_model
    sc = d ** -0.5
    return {
        "in_proj": PAb((d, 2 * di + 2 * s.n_groups * s.d_state + nh),
                       ("embed", "mlp"), "normal", sc),
        "conv_w": PAb((s.d_conv, conv_dim), ("conv", "mlp"), "normal", 0.1),
        "conv_b": PAb((conv_dim,), ("mlp",), "zeros"),
        "A_log": PAb((nh,), (None,), "zeros"),       # A = -exp(A_log) ~ -1
        "D": PAb((nh,), (None,), "ones"),
        "dt_bias": PAb((nh,), (None,), "zeros"),
        "norm": {"scale": PAb((di,), ("mlp",), "ones")},
        "out_proj": PAb((di, d), ("mlp", "embed"), "normal", di ** -0.5),
    }


def _split_proj(cfg, proj):
    """(z, x, B, C, dt) views of the in_proj output; x, B, C are
    adjacent (the conv's input is ``proj[..., di:2 di + 2 G N]``)."""
    s, di, nh, _ = _dims(cfg)
    gn = s.n_groups * s.d_state
    return torch.split(proj, [di, di, gn, gn, nh], dim=-1)


def _xbc(cfg, proj):
    """The conv's raw input: x, B and C side by side (a view)."""
    s, di, _, conv_dim = _dims(cfg)
    return proj[..., di:di + conv_dim]


def _softplus(x):
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def _causal_conv(cfg, params, xbc):
    """Depthwise causal conv1d + silu. xbc: (B, S, conv_dim)."""
    s = cfg.ssm
    w = params["conv_w"].to(xbc.dtype)                  # (d_conv, conv_dim)
    pad = F.pad(xbc, (0, 0, s.d_conv - 1, 0))
    S = xbc.shape[1]
    out = sum(pad[:, i: i + S, :] * w[i][None, None]
              for i in range(s.d_conv))
    return F.silu(out + params["conv_b"].to(xbc.dtype))


def _segsum(a):
    """a: (..., cs) -> (..., cs, cs): entry (i, j) is sum(a[j+1..i]) for
    j <= i (``cum_i - cum_j``, the reference's formula), -inf above the
    diagonal."""
    cs = a.shape[-1]
    cum = torch.cumsum(a, dim=-1)
    diff = cum[..., :, None] - cum[..., None, :]         # (..., i, j)
    ii = torch.arange(cs, device=a.device)
    return diff.masked_fill_(ii[:, None] < ii[None, :], float("-inf"))


def ssd_chunked(xh, dtA, Bh, Ch, chunk, init_state=None):
    """SSD scan. xh: (B,S,nh,hp) pre-scaled by dt; dtA: (B,S,nh) = dt*A
    (taken in fp32); Bh / Ch: (B,S,Gb,N) with Gb dividing nh (Gb = nh:
    the reference's per-head B / C; Gb = G: one row a group, head h
    reading group h // (nh / G)).  Mixed precision: decay / cumsum math
    in fp32, heavy products in xh's dtype, the chunk states and their
    recurrence in fp32.  Returns (y (B,S,nh,hp), final (B,nh,hp,N)
    fp32)."""
    Bsz, S, nh, hp = xh.shape
    Gb, N = Bh.shape[-2], Bh.shape[-1]
    if nh % Gb:
        raise ValueError(f"B / C have {Gb} heads, which do not divide "
                         f"the {nh} heads of x")
    if S % chunk:
        raise ValueError(
            f"a sequence of {S} tokens is not a whole number of chunks of "
            f"{chunk}: the SSD (as the reference's) takes S <= chunk or a "
            f"multiple of it")
    nc = S // chunk
    hpg = nh // Gb
    cd = xh.dtype
    f32 = torch.float32

    def r(t):  # (B,S,...) -> (B,nc,cs,...)
        return t.reshape(Bsz, nc, chunk, *t.shape[2:])

    xc, Ac, Bc, Cc = r(xh), r(dtA.to(f32)), r(Bh), r(Ch)
    Acs = torch.cumsum(Ac, dim=2)                         # (B,nc,cs,nh) f32

    # intra-chunk (diagonal blocks): the decay-masked quadratic term.
    # scores a group: (B,nc,Gb,cs,cs), broadcast over its heads
    # in place where no gradient is recorded (serving: the fp32 Lmat is
    # the SSD's largest transient), out of place under autograd, whose
    # backward reads exp's output and both factors of the product
    inplace = not torch.is_grad_enabled()
    scores = torch.einsum("bclgn,bcsgn->bcgls", Cc, Bc)
    Lmat = _segsum(Ac.permute(0, 1, 3, 2))                # (B,nc,nh,cs,cs)
    Lmat = Lmat.exp_() if inplace else Lmat.exp()
    M = Lmat.to(cd).view(Bsz, nc, Gb, hpg, chunk, chunk)
    del Lmat
    M = M.mul_(scores[:, :, :, None]) if inplace else M * scores[:, :, :, None]
    del scores
    y = torch.matmul(M.view(Bsz, nc, nh, chunk, chunk),
                     xc.permute(0, 1, 3, 2, 4))           # (B,nc,nh,cs,hp)
    del M

    # chunk states: each chunk's contribution to its end state, formed
    # in fp32 from the compute-dtype operands
    decay_states = torch.exp(Acs[:, :, -1:, :] - Acs)    # (B,nc,cs,nh)
    xs = xc.to(f32) * decay_states.to(cd).to(f32)[..., None]
    states = torch.einsum(
        "bcsgjp,bcsgn->bcgjpn",
        xs.view(Bsz, nc, chunk, Gb, hpg, hp), Bc.to(f32)).reshape(
            Bsz, nc, nh, hp, N)                           # (B,nc,nh,hp,N)
    del xs

    # inter-chunk recurrence (fp32 carry), emitting the state before
    # each chunk
    chunk_decay = torch.exp(Acs[:, :, -1, :])             # (B,nc,nh)
    carry = (torch.zeros((Bsz, nh, hp, N), dtype=f32, device=xh.device)
             if init_state is None else init_state.to(f32))
    prev = torch.empty((Bsz, nc, nh, hp, N), dtype=cd, device=xh.device)
    for c in range(nc):
        prev[:, c] = carry
        carry = carry * chunk_decay[:, c, :, None, None] + states[:, c]
    del states

    # inter-chunk output: C against the state entering the chunk
    state_decay = torch.exp(Acs).to(cd)                   # (B,nc,cs,nh)
    y_off = torch.einsum("bclgn,bcgjpn->bclgjp", Cc,
                         prev.view(Bsz, nc, Gb, hpg, hp, N))
    y_off = y_off.reshape(Bsz, nc, chunk, nh, hp) * state_decay[..., None]
    y = y.permute(0, 1, 3, 2, 4) + y_off
    return y.reshape(Bsz, S, nh, hp), carry


class _Blocks(NamedTuple):
    """Where a rank's blocks of one Mamba2 layer lie on a mesh."""
    proj: object       # spec entry of in_proj's columns
    conv: object       # of conv_w's / conv_b's channels (and the conv cache)
    heads: object      # of the heads this rank runs (and the state cache)
    norm: object       # of the gated norm's scale
    out: object        # of out_proj's rows
    h0: int            # this rank's first head
    nh: int            # its heads


def _blocks(cfg: ArchConfig, mesh) -> _Blocks:
    s, di, nh, conv_dim = _dims(cfg)
    d = cfg.d_model
    width = 2 * di + 2 * s.n_groups * s.d_state + nh
    heads = L.spec_entry((nh,), ("heads",), mesh, 0)
    n_local = nh // mesh.count(L.axes_of(heads))
    return _Blocks(
        proj=L.spec_entry((d, width), ("embed", "mlp"), mesh, 1),
        conv=L.spec_entry((s.d_conv, conv_dim), ("conv", "mlp"), mesh, 1),
        heads=heads,
        norm=L.spec_entry((di,), ("mlp",), mesh, 0),
        out=L.spec_entry((di, d), ("mlp", "embed"), mesh, 0),
        h0=mesh.index(L.axes_of(heads)) * n_local, nh=n_local)


def _head_cols(cfg, blk: _Blocks, z, xi, dt):
    """This rank's heads' columns of z and x (d_inner wide) and of dt."""
    hp = cfg.ssm.head_dim
    cols = slice(blk.h0 * hp, (blk.h0 + blk.nh) * hp)
    return (z[..., cols], xi[..., cols],
            dt[..., blk.h0:blk.h0 + blk.nh])


def _head_params(params, blk: _Blocks):
    """This rank's heads' A_log, D and dt_bias (whole on every rank)."""
    h = slice(blk.h0, blk.h0 + blk.nh)
    return params["A_log"][h], params["D"][h], params["dt_bias"][h]


def _groups_of_heads(cfg, blk: _Blocks, Bv, Cv):
    """B and C (..., G, N) narrowed to the groups this rank's heads read."""
    G = cfg.ssm.n_groups
    hpg = _dims(cfg)[2] // G
    g0 = blk.h0 // hpg
    g1 = max(g0 + 1, (blk.h0 + blk.nh) // hpg)
    return Bv[..., g0:g1, :], Cv[..., g0:g1, :]


def _gated_norm_mesh(cfg, params, y, z, mesh, blk: _Blocks, lead):
    """``rmsnorm(norm, y * silu(z))`` over the whole d_inner from this
    rank's heads' columns (its sum of squares summed over the heads'
    ranks), laid as ``out_proj``'s rows (``lead``: the spec entries of
    the dims before d_inner)."""
    di = _dims(cfg)[1]
    g = y * F.silu(z)
    sq = torch.sum(torch.square(g.to(torch.float32)), dim=-1, keepdim=True)
    if mesh.count(L.axes_of(blk.heads)) > 1:
        sq = _mesh.all_reduce(mesh, sq, L.axes_of(blk.heads))
    out = g * torch.rsqrt(sq / di + cfg.norm_eps).to(g.dtype)
    scale = relayout(params["norm"]["scale"], mesh, (blk.norm,),
                     (blk.heads,))
    out = out * scale.to(g.dtype)
    return relayout(out, mesh, lead + (blk.heads,), lead + (blk.out,))


def _mamba_train_mesh(cfg, params, x, mesh, return_state, place,
                      seq_out):
    s, di, nh, conv_dim = _dims(cfg)
    gn = s.n_groups * s.d_state
    cd = x.dtype
    Bsz, S = x.shape[:2]
    place = place or Placement.whole(mesh, Bsz, S)
    b = L.entry_of(place.batch)
    blk = _blocks(cfg, mesh)
    proj = relayout(x @ params["in_proj"].to(cd), mesh, (b, None, blk.proj),
                    (b, None, None))
    z, _, _, _, dt = _split_proj(cfg, proj)
    xbc_raw = relayout(_xbc(cfg, proj), mesh, (b, None, None),
                       (b, None, blk.conv))          # this rank's channels
    xbc = relayout(_causal_conv(cfg, params, xbc_raw), mesh,
                   (b, None, blk.conv), (b, None, None))
    xi, Bv, Cv = torch.split(xbc, [di, gn, gn], dim=-1)
    z, xi, dt = _head_cols(cfg, blk, z, xi, dt)
    A_log, Dp, dt_bias = _head_params(params, blk)
    dt = _softplus(dt.to(torch.float32) + dt_bias.to(torch.float32))
    A = -torch.exp(A_log.to(torch.float32))
    xh = xi.reshape(Bsz, S, blk.nh, s.head_dim)
    Bg, Cg = _groups_of_heads(
        cfg, blk, Bv.reshape(Bsz, S, s.n_groups, s.d_state),
        Cv.reshape(Bsz, S, s.n_groups, s.d_state))
    y, final_state = ssd_chunked(
        xh * dt[..., None].to(cd), dt * A, Bg, Cg, min(s.chunk, S))
    y = (y + Dp.to(cd)[None, None, :, None] * xh).reshape(Bsz, S, -1)
    y = _gated_norm_mesh(cfg, params, y, z, mesh, blk, (b, None))
    out = L.finish_row_parallel(y @ params["out_proj"].to(cd), mesh, place,
                                b, L.axes_of(blk.out), seq_out)
    if return_state:
        return out, MambaCache(
            conv=xbc_raw[:, -(s.d_conv - 1):, :].contiguous(),
            state=final_state.to(cd))
    return out


def mamba_train(cfg: ArchConfig, params, x, mesh=None,
                return_state: bool = False, *, place: Placement = None,
                seq_out: bool = False):
    """Full-sequence Mamba2. x: (B,S,D) -> (B,S,D); with return_state
    also the ``MambaCache`` the prompt leaves (the last d_conv - 1 raw
    conv inputs, the final state in the compute dtype).

    Under a mesh ``x`` is this rank's batch block as ``place`` lays it
    (default: the whole batch), the whole sequence; the output is this
    rank's block of the summed projection, its sequence split as
    ``place.seq`` when ``seq_out``, and the cache piece this rank's
    blocks as ``mamba_cache_logical`` lays them."""
    if mesh is not None:
        return _mamba_train_mesh(cfg, params, x, mesh, return_state, place,
                                 seq_out)
    s, di, nh, conv_dim = _dims(cfg)
    cd = x.dtype
    Bsz, S = x.shape[:2]
    proj = x @ params["in_proj"].to(cd)
    z, _, _, _, dt = _split_proj(cfg, proj)
    xbc_raw = _xbc(cfg, proj)
    xbc = _causal_conv(cfg, params, xbc_raw)
    gn = s.n_groups * s.d_state
    xi, Bv, Cv = torch.split(xbc, [di, gn, gn], dim=-1)

    dt = _softplus(dt.to(torch.float32)
                   + params["dt_bias"].to(torch.float32))   # (B,S,nh)
    A = -torch.exp(params["A_log"].to(torch.float32))        # (nh,)
    xh = xi.reshape(Bsz, S, nh, s.head_dim)
    Bg = Bv.reshape(Bsz, S, s.n_groups, s.d_state)
    Cg = Cv.reshape(Bsz, S, s.n_groups, s.d_state)

    y, final_state = ssd_chunked(
        xh * dt[..., None].to(cd), dt * A, Bg, Cg, min(s.chunk, S))
    y = y + params["D"].to(cd)[None, None, :, None] * xh
    y = y.reshape(Bsz, S, di)
    y = L.rmsnorm(params["norm"], y * F.silu(z), cfg.norm_eps)
    out = y @ params["out_proj"].to(cd)
    if return_state:
        conv_tail = xbc_raw[:, -(s.d_conv - 1):, :]      # rolling conv inputs
        return out, MambaCache(conv=conv_tail.contiguous(),
                               state=final_state.to(cd))
    return out


class MambaCache(NamedTuple):
    conv: torch.Tensor   # (B, d_conv-1, conv_dim) rolling conv inputs,
                         # or (L, B, ...) stacked
    state: torch.Tensor  # (B, nh, hp, N) SSM state


def mamba_init_cache(cfg, batch, dtype, device=None) -> MambaCache:
    s, di, nh, conv_dim = _dims(cfg)
    return MambaCache(
        conv=torch.zeros((batch, s.d_conv - 1, conv_dim), dtype=dtype,
                         device=device),
        state=torch.zeros((batch, nh, s.head_dim, s.d_state), dtype=dtype,
                          device=device))


def mamba_cache_abstract(cfg: ArchConfig, batch,
                         dtype=torch.bfloat16) -> MambaCache:
    """One layer's cache on the meta device: ``mamba_init_cache``'s
    shapes and dtype without storage."""
    return mamba_init_cache(cfg, batch, torch_dtype(dtype), "meta")


def mamba_cache_logical(cfg: ArchConfig) -> MambaCache:
    return MambaCache(conv=("cache_batch", None, "mlp"),
                      state=("cache_batch", "heads", None, None))


def mamba_decode(cfg: ArchConfig, params, x, cache: MambaCache, mesh=None,
                 *, place: Placement = None):
    """One-token recurrent step. x: (B,1,D).  Writes the new conv window
    and state into ``cache`` in place (in the cache's dtypes) and
    returns (out (B,1,D), cache).  Under a mesh ``x`` is this rank's
    batch block (``place``), ``cache`` its blocks as
    ``mamba_cache_logical`` lays them, and ``out`` the summed
    projection."""
    s, di, nh, conv_dim = _dims(cfg)
    cd = x.dtype
    f32 = torch.float32
    Bsz = x.shape[0]
    blk = b = None
    proj = x[:, 0] @ params["in_proj"].to(cd)             # (B, ...)
    if mesh is not None:
        place = place or Placement.whole(mesh, Bsz, 1)
        b = L.entry_of(place.batch)
        blk = _blocks(cfg, mesh)
        proj = relayout(proj, mesh, (b, blk.proj), (b, None))
    z, _, _, _, dt = _split_proj(cfg, proj)
    xbc_new = _xbc(cfg, proj)
    if mesh is not None:                    # this rank's conv channels
        xbc_new = relayout(xbc_new, mesh, (b, None), (b, blk.conv))

    # rolling causal conv, in the wider of the cache's and x's dtypes
    wd = torch.promote_types(cache.conv.dtype, cd)
    window = torch.cat([cache.conv.to(wd), xbc_new[:, None].to(wd)],
                       dim=1)                             # (B, d_conv, C)
    w = params["conv_w"].to(cd).to(wd)
    conv_out = torch.einsum("bkc,kc->bc", window, w) \
        + params["conv_b"].to(cd).to(wd)
    conv_out = F.silu(conv_out)
    if mesh is not None:
        conv_out = relayout(conv_out, mesh, (b, blk.conv), (b, None))
    gn = s.n_groups * s.d_state
    xi, Bv, Cv = torch.split(conv_out, [di, gn, gn], dim=-1)
    A_log, Dp, dt_bias = params["A_log"], params["D"], params["dt_bias"]
    if mesh is not None:                    # this rank's heads
        z, xi, dt = _head_cols(cfg, blk, z, xi, dt)
        A_log, Dp, dt_bias = _head_params(params, blk)
        nh = blk.nh
    Bg = Bv.reshape(Bsz, s.n_groups, s.d_state)
    Cg = Cv.reshape(Bsz, s.n_groups, s.d_state)
    if mesh is not None:
        Bg, Cg = _groups_of_heads(cfg, blk, Bg, Cg)
    G = Bg.shape[1]

    dt = _softplus(dt.to(f32) + dt_bias.to(f32))              # (B,nh)
    A = -torch.exp(A_log.to(f32))
    dA = torch.exp(dt * A)                                    # (B,nh)
    hpg = nh // G
    xh = xi.reshape(Bsz, nh, s.head_dim).to(f32)
    Bg = Bg.reshape(Bsz, G, 1, 1, s.d_state).to(f32)
    Cg = Cg.to(f32)

    dBx = ((dt[..., None] * xh).view(Bsz, G, hpg, s.head_dim)
           [..., None] * Bg).view(Bsz, nh, s.head_dim, s.d_state)
    state = cache.state.to(f32) * dA[:, :, None, None] + dBx
    y = torch.einsum("bgjpn,bgn->bgjp",
                     state.view(Bsz, G, hpg, s.head_dim, s.d_state),
                     Cg).reshape(Bsz, nh, s.head_dim)
    y = y + Dp.to(f32)[None, :, None] * xh
    y = y.reshape(Bsz, nh * s.head_dim).to(cd)
    if mesh is None:
        y = L.rmsnorm(params["norm"], y * F.silu(z), cfg.norm_eps)
        out = (y @ params["out_proj"].to(cd))[:, None]    # (B,1,D)
    else:
        y = _gated_norm_mesh(cfg, params, y, z, mesh, blk, (b,))
        out = L.finish_row_parallel((y @ params["out_proj"].to(cd))[:, None],
                                    mesh, place, b, L.axes_of(blk.out),
                                    False)
    cache.conv.copy_(window[:, 1:])
    cache.state.copy_(state)
    return out, cache
