"""Mixture-of-Experts: the meshless path of the reference's
``repro.models.moe``.

Unified capacity-buffer dispatch (GShard-style dropping): the router
picks each token's top-k experts; every (token, slot) pair takes the
next place in its expert's queue, in (token, slot) order, and a pair
past the capacity ``C`` of its expert is dropped.  The kept pairs fill
an (E, C, D) buffer, dense per-expert products run over it
(``torch.bmm``, as the reference's einsums run outside any Pallas
kernel), and each token sums its experts' outputs under the router
weights.  The capacity is the reference's, over all B·S tokens pooled:
``C = max(ceil(T·top_k·cf / E), min(8, T))``.  The router aux is the
Switch load-balancing loss.

The reference writes the buffer and the output with scatter-adds
(``.at[].add``).  Kept (expert, slot) pairs are unique, so here the
dispatch is one ``index_put_`` into a flat (E·C + 1, D) buffer whose
last row takes the dropped pairs, and the combine is a gather summed
over each token's k slots: no atomics, the same bits run to run, and no
boolean-mask indexing (which would read a count back to the host at
every layer).

Top-k ties go to the lower expert index, as ``lax.top_k`` orders them
(a stable descending sort; ``torch.topk`` gives no order among ties,
and bf16 router logits do tie).

The mesh schedules (the EP / TP ``shard_map`` and the all-to-all
``_a2a_moe_block``) are not ported: ``moe_block(..., mesh=...)`` raises
NotImplementedError naming ROADMAP.md queue 1, item 17.7.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from repro_torch.models import layers as L
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import PAb

MESH_NOT_PORTED = ("the expert- and tensor-parallel MoE schedules (a mesh) "
                   "are not ported yet: ROADMAP.md queue 1, item 17.7 "
                   "(dist/sharding.py, launch/mesh.py) lists them")


def moe_ab(cfg: ArchConfig):
    d = cfg.d_model
    m = cfg.moe
    s = d ** -0.5
    p = {
        "router": PAb((d, m.n_experts), ("embed", None), "normal", s),
        "up": PAb((m.n_experts, d, m.d_expert), ("experts", "embed", "mlp"),
                  "normal", s),
        "gate": PAb((m.n_experts, d, m.d_expert), ("experts", "embed", "mlp"),
                    "normal", s),
        "down": PAb((m.n_experts, m.d_expert, d), ("experts", "mlp", "embed"),
                    "normal", m.d_expert ** -0.5),
    }
    if m.n_shared:
        p["shared"] = L.mlp_ab(d, m.d_expert * m.n_shared, gated=cfg.gated)
    return p


def _capacity(cfg, T):
    m = cfg.moe
    return max(int(math.ceil(T * m.top_k * m.capacity_factor / m.n_experts)),
               min(8, T))


def _top_k(probs, k):
    """The k largest of each row, ties to the lower index (lax.top_k's
    order)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def _router(cfg, router_w, x):
    """x: (T, D) -> (weights (T,k), ids (T,k), aux_loss)."""
    m = cfg.moe
    logits = (x @ router_w.to(x.dtype)).to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    weights, ids = _top_k(probs, m.top_k)
    if m.router_scale:
        weights = weights / torch.clamp(weights.sum(-1, keepdim=True),
                                        min=1e-9)
    T = x.shape[0]
    experts = torch.arange(m.n_experts, device=x.device)
    counts = (ids.reshape(-1, 1) == experts).sum(0)
    f = counts.to(torch.float32) / (T * m.top_k)
    pbar = probs.mean(0)
    aux = m.n_experts * torch.sum(f * pbar)
    return weights.to(x.dtype), ids, aux


def _dispatch_indices(cfg, ids, T, C, e_start, e_count):
    """Slot bookkeeping for the capacity buffer of local experts
    [e_start, e_start+e_count).  Returns (tok_idx, local_eid, slot, keep)
    all shaped (T*top_k,); local_eid is e_count (the trash lane) for an
    expert outside the range."""
    m = cfg.moe
    flat_ids = ids.reshape(-1).to(torch.int64)    # gather takes int64
    local = (flat_ids >= e_start) & (flat_ids < e_start + e_count)
    local_eid = torch.where(local, flat_ids - e_start,
                            torch.full_like(flat_ids, e_count))
    # position within each expert's queue, in (token, slot) order
    lanes = torch.arange(e_count + 1, device=ids.device)
    onehot = (local_eid[:, None] == lanes).to(torch.int32)
    pos = torch.cumsum(onehot, dim=0, dtype=torch.int32) - 1
    slot = pos.gather(1, local_eid[:, None])[:, 0]
    keep = local & (slot < C)
    tok_idx = torch.arange(flat_ids.shape[0], device=ids.device) // m.top_k
    return tok_idx, local_eid, slot, keep


def _expert_ffn(cfg, up, gate, down, xe):
    """xe: (E_loc, C, D) -> (E_loc, C, D); dense per-expert matmuls."""
    h = torch.bmm(xe, up.to(xe.dtype))
    if cfg.gated:
        h = L._act(torch.bmm(xe, gate.to(xe.dtype)), cfg.act) * h
    else:
        h = L._act(h, cfg.act)
    return torch.bmm(h, down.to(xe.dtype))


def _local_moe(cfg, x, router_w, up, gate, down, e_start, n_local, C):
    """MoE over x (T, D) for experts [e_start, +n_local)."""
    T, D = x.shape
    weights, ids, aux = _router(cfg, router_w, x)
    tok_idx, local_eid, slot, keep = _dispatch_indices(
        cfg, ids, T, C, e_start, n_local)

    # row of each pair in the flat (n_local*C + 1, D) buffer; the last
    # row takes every dropped pair and is never read
    trash = n_local * C
    dest = torch.where(keep, local_eid * C + slot,
                       torch.full_like(local_eid, trash))
    buf = x.new_zeros((trash + 1, D))
    buf.index_put_((dest,), x[tok_idx])
    xe = buf[:trash].view(n_local, C, D)

    ye = _expert_ffn(cfg, up, gate, down, xe).reshape(trash, D)

    # a dropped pair reads some row and weighs it by 0, as the reference
    # reads its clamped (expert, slot)
    w_flat = weights.reshape(-1)
    contrib = ye[torch.clamp(dest, max=trash - 1)] * (
        w_flat * keep.to(w_flat.dtype))[:, None]
    y = contrib.view(T, cfg.moe.top_k, D).sum(1)
    return y, aux


def moe_block(cfg: ArchConfig, params, x, mesh=None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B,S,D) -> ((B,S,D), aux)."""
    if mesh is not None:
        raise NotImplementedError(MESH_NOT_PORTED)
    m = cfg.moe
    B, S, D = x.shape
    xt = x.reshape(B * S, D)
    C = _capacity(cfg, B * S)
    y, aux = _local_moe(cfg, xt, params["router"], params["up"],
                        params["gate"], params["down"], e_start=0,
                        n_local=m.n_experts, C=C)
    if m.n_shared:
        y = y + L.mlp(params["shared"], xt, cfg.act, cfg.gated)
    return y.reshape(B, S, D), aux
