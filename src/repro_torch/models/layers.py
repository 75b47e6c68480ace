"""Shared layers of the LM stack: parameters, norms, RoPE, MLPs and
embeddings.  Port of the reference's ``repro.models.layers``.

Parameters: every layer declares an abstract tree of ``PAb(shape,
logical, init, scale)`` with the reference's shapes and scales;
``logical`` names the axes, which ``spec_tree`` / ``pspec_tree`` resolve
to each leaf's ``NamedSharding`` / ``PartitionSpec`` on a mesh
(``dist.sharding.resolve_spec``).  ``ParamTree`` materializes such a
tree as an ``nn.Module`` from a ``torch.Generator`` on the device, under
a mesh each leaf as this rank's block of the global seeded tensor;
``tree["attn"]["wq"]`` reads a leaf as the reference's dict does, and
the ``state_dict`` keys join the path with dots (``named_specs`` gives
each key's sharding).  On the meta device it draws nothing: the dry
run's parameters are shapes (``shape_tree`` is the tree of global
shapes, ``count_params`` counts its elements).  The reference draws
from ``jax.random``, so the two packages' initial weights differ: the
tests carry the reference's weights across with
``convert.lm_state_dict`` (``convert.shard_state_dict`` cuts them to a
rank's blocks).

Under a mesh the embedding table is vocabulary-sharded (``"vocab"``
over ``model`` by DEFAULT_RULES): ``embed`` looks up the rows a rank
holds and sums over ``model`` (one rank holds each row, so the sum is
exact), ``unembed_logits`` returns a rank's block of the logits,
``vocab_argmax`` is the greedy pick across ranks (ties to the lowest
global index, as ``argmax``), and ``chunked_xent`` takes the
log-sum-exp across ranks.  Every collective they call has its adjoint
as its gradient (``launch.mesh``), so a train step differentiates
through them (``train.loop`` states the rule that makes each rank's
gradients the global ones).

``chunked_xent`` is the training loss: the mean next-token NLL over
sequence chunks, each chunk's logits recomputed in the backward
(``torch.utils.checkpoint``, as the reference wraps its scan body in
``jax.checkpoint``), so only one chunk's (B, chunk, V) logits exist.

Every function keeps the reference's cast points: a weight is cast to
the activations' dtype at its use (the parameters stay in
``params_dtype``), and RMSNorm and LayerNorm take their statistics in
fp32.
"""
from __future__ import annotations

import math
from typing import Iterator, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.device import torch_dtype
from repro_torch.dist.sharding import (AxisRules, NamedSharding,
                                       active_rules, resolve_spec)
from repro_torch.dist.sharding import relayout as _relayout
from repro_torch.launch import mesh as _mesh


class PAb(NamedTuple):
    shape: tuple
    logical: tuple
    init: str = "normal"      # normal | zeros | ones
    scale: float = 1.0


def init_leaf(ab: PAb, gen: Optional[torch.Generator],
              device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """One leaf drawn on ``device``.  On the meta device (the dry run's
    shapes) a normal leaf is a shape only: there is nothing to draw, and
    ``gen`` is None there."""
    if ab.init == "zeros":
        return torch.zeros(ab.shape, dtype=dtype, device=device)
    if ab.init == "ones":
        return torch.ones(ab.shape, dtype=dtype, device=device)
    out = torch.empty(ab.shape, dtype=dtype, device=device)
    if out.is_meta:
        return out
    return out.normal_(generator=gen).mul_(ab.scale)


class ParamTree(nn.Module):
    """A nested dict of ``PAb`` leaves (lists become ``nn.ModuleList``s)
    materialized as an ``nn.Module``.  The parameters are made frozen
    (``requires_grad=False``), so serving records no autograd graph; the
    train step turns the tree it trains trainable
    (``train.loop.make_train_step``: ``requires_grad_(True)``).

    With a ``mesh`` each leaf is this rank's block of the global tensor
    (its spec resolved under the active rule table, ``use_rules``): every
    rank draws every global leaf from the same generator in the same
    order and keeps its block, so the blocks of all ranks make up the
    meshless tree of the same seed."""

    def __init__(self, tree: dict, gen: torch.Generator,
                 device: torch.device, dtype: torch.dtype, mesh=None):
        super().__init__()
        for name, sub in tree.items():
            if isinstance(sub, PAb):
                t = init_leaf(sub, gen, device, dtype)
                if mesh is not None:
                    t = NamedSharding(mesh, resolve_spec(
                        sub.shape, sub.logical, mesh)).shard(t)
                self.register_parameter(name, nn.Parameter(
                    t, requires_grad=False))
            elif isinstance(sub, list):
                self.add_module(name, nn.ModuleList(
                    ParamTree(t, gen, device, dtype, mesh) for t in sub))
            else:
                self.add_module(name, ParamTree(sub, gen, device, dtype,
                                                mesh))

    def __getitem__(self, key: str):
        return getattr(self, key)

    def __contains__(self, key: str) -> bool:
        return key in self._parameters or key in self._modules


def axes_of(entry) -> Tuple[str, ...]:
    """The mesh axes of one PartitionSpec entry."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def spec_entry(shape, logical, mesh, i):
    """Entry i of the spec (shape, logical) resolves to on ``mesh``."""
    spec = tuple(resolve_spec(shape, logical, mesh)) + (None,) * len(shape)
    return spec[i]


def entry_of(axes) -> object:
    """The PartitionSpec entry of a tuple of mesh axes."""
    axes = tuple(axes)
    return None if not axes else (axes[0] if len(axes) == 1 else axes)


class Placement(NamedTuple):
    """How a forward's (B, S, D) activations lie on a mesh: the global
    batch B split over the ``batch`` axes, the global sequence S over
    the ``seq`` axes (empty: whole on every rank).  Between blocks the
    sequence is split as ``("batch", "seq_sp", None)`` resolves
    (``between_blocks``); inside a block, and for the whole-tensor
    inputs of a function called on its own (``whole``), it is not."""

    mesh: object
    batch: Tuple[str, ...]
    seq: Tuple[str, ...]
    B: int
    S: int

    @classmethod
    def whole(cls, mesh, B: int, S: int) -> "Placement":
        return cls(mesh, (), (), B, S)

    @classmethod
    def between_blocks(cls, mesh, B: int, S: int, D: int) -> "Placement":
        spec = resolve_spec((B, S, D), ("batch", "seq_sp", None),
                            mesh) + (None, None)
        return cls(mesh, axes_of(spec[0]), axes_of(spec[1]), B, S)

    def spec(self, seq: bool = True):
        """The (batch, seq) entries of this layout (seq whole if not
        ``seq``)."""
        return (entry_of(self.batch), entry_of(self.seq) if seq else None)

    def whole_seq(self) -> "Placement":
        return self._replace(seq=())


def finish_row_parallel(proj, mesh, place: Placement, b_entry,
                         sum_axes, seq_out: bool):
    """The row-parallel projection's (B', S, D) output, a partial sum
    over ``sum_axes`` with its batch as ``b_entry``, reduced and moved
    to ``place``'s layout: the sequence split over ``place.seq`` when
    ``seq_out`` (a reduce-scatter where it can), else whole."""
    want = (entry_of(place.batch), entry_of(place.seq) if seq_out else None)
    if sum_axes:
        if (seq_out and tuple(place.seq) == tuple(sum_axes)
                and axes_of(b_entry) == tuple(place.batch)):
            return _mesh.reduce_scatter(mesh, proj, sum_axes[0], dim=1)
        proj = _mesh.all_reduce(mesh, proj, sum_axes)
    return _relayout(proj, mesh, (b_entry, None), want)


def _map_pab(fn, tree):
    if isinstance(tree, PAb):
        return fn(tree)
    if isinstance(tree, list):
        return [_map_pab(fn, t) for t in tree]
    return {k: _map_pab(fn, t) for k, t in tree.items()}


def spec_tree(tree, mesh, rules: Optional[AxisRules] = None):
    """The ``NamedSharding`` of every leaf of an abstract tree on
    ``mesh`` (the tree's structure kept)."""
    rules = rules or active_rules()
    return _map_pab(lambda ab: NamedSharding(
        mesh, resolve_spec(ab.shape, ab.logical, mesh, rules)), tree)


def pspec_tree(tree, mesh, rules: Optional[AxisRules] = None):
    """The ``PartitionSpec`` of every leaf of an abstract tree."""
    rules = rules or active_rules()
    return _map_pab(lambda ab: resolve_spec(ab.shape, ab.logical, mesh,
                                            rules), tree)


def shape_tree(tree, dtype):
    """The tree of ``torch.empty(shape, dtype=dtype, device="meta")``
    over an abstract tree's leaves: the port's ``jax.ShapeDtypeStruct``
    tree, shapes and dtypes without storage."""
    dt = torch_dtype(dtype)
    return _map_pab(lambda ab: torch.empty(ab.shape, dtype=dt,
                                           device="meta"), tree)


def count_params(tree) -> int:
    """The elements of every leaf of an abstract tree (or of a tree of
    tensors, ``shape_tree``'s)."""
    return sum(math.prod(leaf.shape) for _, leaf in named_leaves(tree))


def named_leaves(tree, prefix: str = "") -> Iterator[Tuple[str, object]]:
    """(state_dict name, leaf) of a tree of dicts and lists, in the
    order ``ParamTree`` registers them."""
    if isinstance(tree, list):
        for i, t in enumerate(tree):
            yield from named_leaves(t, f"{prefix}{i}.")
    elif isinstance(tree, dict):
        for k, t in tree.items():
            yield from named_leaves(t, f"{prefix}{k}.")
    else:
        yield prefix[:-1], tree


# ---------------------------------------------------- vocabulary-sharded ops

def _vocab_block(sharding: Optional[NamedSharding], rows_local: int):
    """(axes the table's rows are sharded over, this rank's first row)."""
    if sharding is None or not sharding.spec or sharding.spec[0] is None:
        return (), 0
    e = sharding.spec[0]
    axes = (e,) if isinstance(e, str) else tuple(e)
    return axes, sharding.mesh.index(axes) * rows_local


def sum_over_ranks(t: torch.Tensor, mesh, axes) -> torch.Tensor:
    """The sum of ``t`` over the ranks along ``axes`` (``t`` itself
    without a mesh); its gradient is the sum of the ranks' gradients
    (``launch.mesh.all_reduce``'s adjoint)."""
    if mesh is None or mesh.count(axes) == 1:
        return t
    return _mesh.all_reduce(mesh, t, axes)


# ------------------------------------------------------------------ norms

def rmsnorm_ab(d):
    return {"scale": PAb((d,), ("embed",), "ones")}


def rmsnorm(params, x, eps=1e-6):
    var = torch.mean(torch.square(x.to(torch.float32)), dim=-1, keepdim=True)
    out = x * torch.rsqrt(var + eps).to(x.dtype)
    return out * params["scale"].to(x.dtype)


def layernorm_ab(d):
    return {"scale": PAb((d,), ("embed",), "ones"),
            "bias": PAb((d,), ("embed",), "zeros")}


def layernorm(params, x, eps=1e-5):
    """The mean and the population variance (``jnp.var``'s, not torch's
    unbiased default) in fp32, normalized and cast back to x's dtype,
    then scale and bias applied in x's dtype."""
    xf = x.to(torch.float32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, correction=0)
    out = ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype)
    return out * params["scale"].to(x.dtype) + params["bias"].to(x.dtype)


# ------------------------------------------------------------------- RoPE

def rope_angles(positions, dim, theta=10000.0):
    """positions (...,) -> (cos, sin) of shape (..., dim//2)."""
    freqs = 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                          device=positions.device) / dim))
    ang = positions[..., None].to(torch.float32) * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, positions, theta=10000.0, fraction=1.0):
    """x: (B, H, S, D); rotate the first ``fraction`` of D (split-halves
    convention).  fraction=0.5 gives chatglm3's 2d-RoPE layout."""
    D = x.shape[-1]
    rot = int(D * fraction)
    if rot == 0:
        return x
    xr, xp = x[..., :rot], x[..., rot:]
    cos, sin = rope_angles(positions, rot, theta)          # (B,S,rot/2)
    cos = cos[:, None, :, :]
    sin = sin[:, None, :, :]
    x1, x2 = xr[..., : rot // 2], xr[..., rot // 2:]
    rotated = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return torch.cat([rotated.to(x.dtype), xp], dim=-1)


# -------------------------------------------------------------------- MLP

def mlp_ab(d, f, gated=True):
    s_in = d ** -0.5
    s_out = f ** -0.5
    p = {"up": PAb((d, f), ("embed", "mlp"), "normal", s_in),
         "down": PAb((f, d), ("mlp", "embed"), "normal", s_out)}
    if gated:
        p["gate"] = PAb((d, f), ("embed", "mlp"), "normal", s_in)
    return p


def _act(z, act):
    if act == "silu":
        return F.silu(z)
    return F.gelu(z, approximate="tanh")     # jax.nn.gelu(approximate=True)


def mlp(params, x, act="silu", gated=True):
    h = x @ params["up"].to(x.dtype)
    if gated:
        h = _act(x @ params["gate"].to(x.dtype), act) * h
    else:
        h = _act(h, act)
    return h @ params["down"].to(x.dtype)


# ------------------------------------------------------------- embeddings

def embedding_ab(vocab, d, pad_to: int = 1):
    """pad_to > 1 rounds the vocab row count up (the reference shards the
    vocab dim over its model axis); padded rows are masked out of the
    logits in ``unembed_logits``."""
    if pad_to > 1:
        vocab = -(-vocab // pad_to) * pad_to
    return {"table": PAb((vocab, d), ("vocab", "embed"), "normal", 1.0)}


def embed(params, tokens, scale_by_dim=True,
          sharding: Optional[NamedSharding] = None):
    """The table's rows of ``tokens``; with the table's ``sharding``
    vocabulary-sharded, each rank looks up the rows it holds (zeros
    elsewhere) and the sum over the ranks gives every row."""
    tab = params["table"]
    axes, lo = _vocab_block(sharding, tab.shape[0])
    if axes:
        ids = tokens.long() - lo
        mine = (ids >= 0) & (ids < tab.shape[0])
        out = tab[ids.clamp(0, tab.shape[0] - 1)] * mine[..., None].to(
            tab.dtype)
        out = _mesh.all_reduce(sharding.mesh, out, axes)
    else:
        out = tab[tokens.long()]
    if scale_by_dim:
        out = out * (tab.shape[1] ** 0.5)
    return out


def unembed_logits(params, x, real_vocab: Optional[int] = None,
                   sharding: Optional[NamedSharding] = None):
    """x: (B,S,D) -> (B,S,V_pad) logits with the tied table; padded
    vocab rows masked to -1e30 so sampling can never pick them.  With
    the table vocabulary-sharded (``sharding``) this rank's block of the
    logits, (B,S,V_pad / ranks), its rows' global ids masked alike."""
    tab = params["table"]
    _, lo = _vocab_block(sharding, tab.shape[0])
    logits = x @ tab.T.to(x.dtype)
    if real_vocab is not None and real_vocab < lo + tab.shape[0]:
        pad = torch.arange(lo, lo + tab.shape[0], device=x.device) \
            >= real_vocab
        logits = logits + pad.to(logits.dtype) * torch.tensor(
            -1e30, dtype=logits.dtype, device=x.device)
    return logits


def vocab_argmax(logits, sharding: Optional[NamedSharding] = None):
    """The greedy token of each position of ``logits`` (..., V) or of
    this rank's vocabulary block of them: the global index of the
    largest logit, ties to the lowest index (``torch.argmax``'s pick),
    the same on every rank."""
    axes, lo = _vocab_block(sharding, logits.shape[-1])
    if not axes:
        return torch.argmax(logits, dim=-1)
    val, idx = torch.max(logits, dim=-1)
    idx = idx + lo
    mesh = sharding.mesh
    vals = _mesh.all_gather(mesh, val[None].float(), axes, 0)
    ids = _mesh.all_gather(mesh, idx[None], axes, 0)
    best = vals.max(0).values
    big = torch.iinfo(ids.dtype).max
    return torch.where(vals == best, ids, torch.full_like(ids, big)).min(0)[0]


def _xent_chunk_sharded(tab, x, labels, pad, mesh, axes, lo):
    """``_xent_chunk`` over a vocabulary-sharded table: the max, the sum
    of exponentials and the gold logit reduced across the ranks."""
    logits = (x @ tab.T.to(x.dtype)).to(torch.float32)
    if pad is not None:
        logits = logits + pad
    # the shift cancels in logz, so it takes no gradient
    top = _mesh.all_reduce(mesh, logits.detach().max(-1).values, axes, "max")
    sumexp = _mesh.all_reduce(
        mesh, torch.exp(logits - top[..., None]).sum(-1), axes)
    logz = top + torch.log(sumexp)
    lab = labels.long()
    ids = lab - lo
    mine = (ids >= 0) & (ids < tab.shape[0])
    gold = logits.gather(-1, ids.clamp(0, tab.shape[0] - 1)[..., None])[..., 0]
    gold = _mesh.all_reduce(mesh, gold * mine.to(torch.float32), axes)
    mask = (lab >= 0).to(torch.float32)
    return torch.sum((logz - gold) * mask), torch.sum(mask)


def _xent_chunk(tab, x, labels, pad):
    """(summed NLL, count) of one chunk: fp32 logits over the padded
    vocabulary (pad rows at -1e30), logsumexp minus the gold logit, over
    the labels >= 0."""
    logits = (x @ tab.T.to(x.dtype)).to(torch.float32)
    if pad is not None:
        logits = logits + pad
    logz = torch.logsumexp(logits, dim=-1)
    lab = labels.long()
    gold = logits.gather(-1, lab.clamp(min=0)[..., None])[..., 0]
    mask = (lab >= 0).to(torch.float32)
    return torch.sum((logz - gold) * mask), torch.sum(mask)


def chunked_xent(params, x, labels, chunk: int = 512,
                 real_vocab: Optional[int] = None,
                 sharding: Optional[NamedSharding] = None, mesh=None,
                 token_axes=()):
    """Cross-entropy without materializing the full (B,S,V) logits: the
    mean NLL over the labels >= 0 (-100 is masked), padded vocabulary
    rows (>= real_vocab) excluded from the softmax.  The sequence splits
    as the reference splits it, into ``max(S // chunk, 1)`` chunks of
    ``S // n_chunks``; the reference's reshape fails where those do not
    cover S (S = 1101, for one), and here that raises a ValueError.
    Each chunk's logits are recomputed in the backward.

    Under a mesh: ``x`` and ``labels`` are this rank's tokens, the
    table's ``sharding`` may shard the vocabulary (the max, the sum of
    exponentials and the gold logit then reduced across its ranks, each
    chunk still recomputed in the backward), and the NLL sum and the
    count are summed over ``token_axes``, the axes the tokens are split
    over, so every rank returns the mean over all of them."""
    tab = params["table"]
    B, S, _ = x.shape
    axes, lo = _vocab_block(sharding, tab.shape[0])
    V = lo + tab.shape[0]
    n_chunks = max(S // chunk, 1)
    chunk = S // n_chunks
    if n_chunks * chunk != S:
        raise ValueError(f"{S} positions do not split into {n_chunks} "
                         f"chunks of {chunk} (the reference's reshape fails "
                         "there too)")
    pad = None
    if real_vocab is not None and real_vocab < V:
        pad = (torch.arange(lo, V, device=x.device) >= real_vocab).to(
            torch.float32) * -1e30
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    for c in range(n_chunks):
        sl = slice(c * chunk, (c + 1) * chunk)
        if axes:
            t, n = checkpoint(_xent_chunk_sharded, tab, x[:, sl],
                              labels[:, sl], pad, sharding.mesh, axes, lo,
                              use_reentrant=False)
        else:
            t, n = checkpoint(_xent_chunk, tab, x[:, sl], labels[:, sl],
                              pad, use_reentrant=False)
        tot, cnt = tot + t, cnt + n
    if mesh is not None and mesh.count(token_axes) > 1:
        cnt = _mesh.all_reduce(mesh, cnt, token_axes)
        return sum_over_ranks(tot / torch.clamp(cnt, min=1.0), mesh,
                              token_axes)
    return tot / torch.clamp(cnt, min=1.0)
