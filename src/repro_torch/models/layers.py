"""Shared layers of the LM stack: parameters, norms, RoPE, MLPs and
embeddings.  Port of the reference's ``repro.models.layers``.

Parameters: every layer declares an abstract tree of ``PAb(shape,
logical, init, scale)`` with the reference's shapes and scales
(``logical`` names the axes, as in the reference; the port has no mesh
and does not read it).  ``ParamTree`` materializes such a tree as an
``nn.Module`` from a ``torch.Generator`` on the device; ``tree["attn"]
["wq"]`` reads a leaf as the reference's dict does, and the
``state_dict`` keys join the path with dots.  The reference draws from
``jax.random``, so the two packages' initial weights differ: the tests
carry the reference's weights across with ``convert.lm_state_dict``.

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

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint


class PAb(NamedTuple):
    shape: tuple
    logical: tuple
    init: str = "normal"      # normal | zeros | ones
    scale: float = 1.0


def init_leaf(ab: PAb, gen: torch.Generator, device: torch.device,
              dtype: torch.dtype) -> torch.Tensor:
    if ab.init == "zeros":
        return torch.zeros(ab.shape, dtype=dtype, device=device)
    if ab.init == "ones":
        return torch.ones(ab.shape, dtype=dtype, device=device)
    out = torch.empty(ab.shape, dtype=dtype, device=device)
    return out.normal_(generator=gen).mul_(ab.scale)


class ParamTree(nn.Module):
    """A nested dict of ``PAb`` leaves (lists become ``nn.ModuleList``s)
    materialized as an ``nn.Module``.  The parameters are made frozen
    (``requires_grad=False``), so serving records no autograd graph; the
    train step turns the tree it trains trainable
    (``train.loop.make_train_step``: ``requires_grad_(True)``)."""

    def __init__(self, tree: dict, gen: torch.Generator,
                 device: torch.device, dtype: torch.dtype):
        super().__init__()
        for name, sub in tree.items():
            if isinstance(sub, PAb):
                self.register_parameter(name, nn.Parameter(
                    init_leaf(sub, gen, device, dtype), requires_grad=False))
            elif isinstance(sub, list):
                self.add_module(name, nn.ModuleList(
                    ParamTree(t, gen, device, dtype) for t in sub))
            else:
                self.add_module(name, ParamTree(sub, gen, device, dtype))

    def __getitem__(self, key: str):
        return getattr(self, key)

    def __contains__(self, key: str) -> bool:
        return key in self._parameters or key in self._modules


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


def embed(params, tokens, scale_by_dim=True):
    tab = params["table"]
    out = tab[tokens.long()]
    if scale_by_dim:
        out = out * (tab.shape[1] ** 0.5)
    return out


def unembed_logits(params, x, real_vocab: Optional[int] = None):
    """x: (B,S,D) -> (B,S,V_pad) logits with the tied table; padded
    vocab rows masked to -1e30 so sampling can never pick them."""
    tab = params["table"]
    logits = x @ tab.T.to(x.dtype)
    if real_vocab is not None and real_vocab < tab.shape[0]:
        pad = torch.arange(tab.shape[0], device=x.device) >= real_vocab
        logits = logits + pad.to(logits.dtype) * torch.tensor(
            -1e30, dtype=logits.dtype, device=x.device)
    return logits


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
                 real_vocab: Optional[int] = None):
    """Cross-entropy without materializing the full (B,S,V) logits: the
    mean NLL over the labels >= 0 (-100 is masked), padded vocabulary
    rows (>= real_vocab) excluded from the softmax.  The sequence splits
    as the reference splits it, into ``max(S // chunk, 1)`` chunks of
    ``S // n_chunks``; the reference's reshape fails where those do not
    cover S (S = 1101, for one), and here that raises a ValueError.
    Each chunk's logits are recomputed in the backward."""
    tab = params["table"]
    B, S, _ = x.shape
    V = tab.shape[0]
    n_chunks = max(S // chunk, 1)
    chunk = S // n_chunks
    if n_chunks * chunk != S:
        raise ValueError(f"{S} positions do not split into {n_chunks} "
                         f"chunks of {chunk} (the reference's reshape fails "
                         "there too)")
    pad = None
    if real_vocab is not None and real_vocab < V:
        pad = (torch.arange(V, device=x.device) >= real_vocab).to(
            torch.float32) * -1e30
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    for c in range(n_chunks):
        sl = slice(c * chunk, (c + 1) * chunk)
        t, n = checkpoint(_xent_chunk, tab, x[:, sl], labels[:, sl], pad,
                          use_reentrant=False)
        tot, cnt = tot + t, cnt + n
    return tot / torch.clamp(cnt, min=1.0)
