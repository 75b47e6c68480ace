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

Every function keeps the reference's cast points: a weight is cast to
the activations' dtype at its use (the parameters stay in
``params_dtype``), and RMSNorm takes its variance in fp32.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn


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
    materialized as an ``nn.Module``.  The parameters need no gradient:
    this slice of the port serves, it does not train."""

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
