"""Mixture-of-Experts with the reference's three mesh schedules.
Port of ``repro.models.moe``.

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

Under a mesh with a ``model`` axis the reference runs a ``shard_map``
schedule chosen by divisibility; the port runs the same three over
``torch.distributed`` (``launch.mesh``), each rank holding its block of
the expert weights as ``resolve_spec`` lays them:

  * EP psum (``n_experts % model == 0``; and S == 1 or S % model != 0):
    experts sharded over ``model``; every rank holds its batch block's
    tokens whole, dispatches the pairs routed to its experts
    [e_start, +E/model) into an (E_local, C, D) buffer, and the partial
    outputs are summed over ``model``;
  * TP psum (experts not divisible): every expert local, d_expert
    sharded over ``model``; the same buffer, the same sum;
  * all-to-all (``_a2a_moe_block``; EP with S % model == 0, S > 1): the
    sequence is split over ``model``; each rank buckets its tokens'
    pairs by destination rank (``cap_out`` a peer), ships them, buckets
    the arrivals by local expert (capacity ``C2``, a trash lane for the
    empty slots), runs the experts and ships the results back.

Capacities are the reference's: ``C`` from the rank's tokens
``T_local``, the a2a path's ``cap_out`` and ``C2`` from its shard's, so
drops under a mesh differ from the meshless path's exactly as the
reference's do.  Shared experts (deepseek) ride inside the psum, their
d_ff sharded, or run locally on the a2a path with their weights
gathered.  The router aux is the mean over ``model`` (and the batch
axes).  A mesh without a ``model`` axis takes the meshless path, as the
reference's.  Where the sequence is split between blocks (``seq_sp``)
the psum becomes a reduce-scatter over the sequence.
"""
from __future__ import annotations

import contextlib
import math
from typing import Tuple

import torch

from repro_torch.dist.sharding import relayout
from repro_torch.launch import mesh as _mesh
from repro_torch.models import layers as L
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import PAb, Placement, entry_of


_DROPS = None


@contextlib.contextmanager
def record_drops():
    """Collect the (token, slot) pairs each MoE call drops into the
    yielded list, one device count a call: under a mesh this rank's
    (those routed to its experts past their capacity, or on the
    all-to-all path its buckets' in either stage)."""
    global _DROPS
    prev, _DROPS = _DROPS, []
    try:
        yield _DROPS
    finally:
        _DROPS = prev


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


def _slot_of(lane, n_lanes):
    """Each pair's place in its lane's queue, in pair order."""
    lanes = torch.arange(n_lanes, device=lane.device)
    pos = torch.cumsum((lane[:, None] == lanes).to(torch.int32), dim=0,
                       dtype=torch.int32) - 1
    return pos.gather(1, lane[:, None])[:, 0]


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
    slot = _slot_of(local_eid, e_count + 1)
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
    if _DROPS is not None:
        _DROPS.append(((local_eid < n_local) & ~keep).sum())

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


def moe_block(cfg: ArchConfig, params, x, mesh=None, *,
              place: Placement = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B,S,D) -> ((B,S,D), aux).

    Under a mesh with a ``model`` axis: ``x`` is this rank's block as
    ``place`` lays it (default: the whole (B, S, D) on every rank) and
    the result is the block of the output laid alike; aux is the
    mean over the ranks, the same on each."""
    m = cfg.moe
    if mesh is None or "model" not in mesh.shape:
        B, S, D = x.shape
        xt = x.reshape(B * S, D)
        C = _capacity(cfg, B * S)
        y, aux = _local_moe(cfg, xt, params["router"], params["up"],
                            params["gate"], params["down"], e_start=0,
                            n_local=m.n_experts, C=C)
        if m.n_shared:
            y = y + L.mlp(params["shared"], xt, cfg.act, cfg.gated)
        return y.reshape(B, S, D), aux

    place = place or Placement.whole(mesh, x.shape[0], x.shape[1])
    B, S, D = place.B, place.S, x.shape[2]
    model_n = mesh.shape["model"]
    batch_axes = tuple(a for a in ("pod", "data") if a in mesh.shape)
    batch_div = mesh.count(batch_axes)
    if B % batch_div:           # e.g. batch=1 long-context decode: replicate
        batch_axes = ()
    B_local = B // mesh.count(batch_axes)
    ep = m.n_experts % model_n == 0 and m.n_experts >= model_n
    n_local = m.n_experts // model_n if ep else m.n_experts
    src = place.spec()
    b_ent = entry_of(batch_axes)
    if ep and S % model_n == 0 and S > 1:
        xs = relayout(x, mesh, src, (b_ent, "model"))
        y, aux = _a2a_moe_block(cfg, params, xs, mesh, model_n, batch_axes,
                                n_local)
        return relayout(y, mesh, (b_ent, "model"), src), aux

    xs = relayout(x, mesh, (src[0], src[1]), (b_ent, None))
    T = xs.shape[0] * xs.shape[1]
    xt = xs.reshape(T, D)
    e_start = mesh.index("model") * n_local if ep else 0
    C = _capacity(cfg, B_local * S)
    y, aux = _local_moe(cfg, xt, params["router"], params["up"],
                        params["gate"], params["down"], e_start, n_local, C)
    shared, after = params["shared"] if m.n_shared else None, None
    if shared is not None:
        y_sh = L.mlp(shared, xt, cfg.act, cfg.gated)
        if _shared_is_split(shared, cfg):
            # d_ff split over model as the reference's P(None, "model"):
            # the partial output folds into the same sum (one collective
            # a layer)
            y = y + y_sh
        else:
            after = y_sh.reshape(xs.shape)
    y = y.reshape(xs.shape)
    aux = _pmean(mesh, aux, batch_axes)
    if src[1] == "model" and src[0] == b_ent and after is None:
        return _mesh.reduce_scatter(mesh, y, "model", dim=1), aux
    y = _mesh.all_reduce(mesh, y, "model")
    if after is not None:
        y = y + after
    return relayout(y, mesh, (b_ent, None), src), aux


def _shared_is_split(shared, cfg) -> bool:
    return shared["up"].shape[1] != cfg.moe.d_expert * cfg.moe.n_shared


def _pmean(mesh, aux, batch_axes):
    """The mean of each rank's aux over the batch axes and ``model``
    (its gradient each rank's share, ``layers.sum_over_ranks``)."""
    axes = tuple(batch_axes) + ("model",)
    return L.sum_over_ranks(aux, mesh, axes) / mesh.count(axes)


def _gathered_shared(mesh, shared, cfg):
    """The shared expert's weights whole (their d_ff gathered over
    ``model`` where it is sharded)."""
    if not _shared_is_split(shared, cfg):
        return shared
    return {k: _mesh.all_gather(mesh, shared[k], "model",
                                0 if k == "down" else 1)
            for k in ("up", "gate", "down") if k in shared}


def _a2a_moe_block(cfg, params, x, mesh, model_n, batch_axes, n_local):
    """Expert parallelism with all_to_all dispatch over seq-split x: x is
    this rank's (B_local, S / model, D) block.

    Stage 1 buckets each (token, slot) pair by destination rank
    (``cap_out`` a peer, in pair order; later pairs drop) and ships the
    buckets with the local expert id (+1; 0 marks an empty slot).
    Stage 2 buckets the arrivals by local expert (capacity ``C2``, the
    empty slots in a trash lane), runs the dense per-expert FFN, and the
    results take the reverse trip.  The shared expert (deepseek) runs
    locally on the rank's tokens with its weights whole."""
    m = cfg.moe
    B_l, S_l, D = x.shape
    T = B_l * S_l
    cap_out = max(int(math.ceil(T * m.top_k * m.capacity_factor / model_n)),
                  min(8, T * m.top_k))
    C2 = max(int(math.ceil(cap_out * model_n * m.capacity_factor
                           * 1.0 / n_local)), 8)
    xt = x.reshape(T, D)
    weights, ids, aux = _router(cfg, params["router"], xt)

    # ---- stage 1: bucket by destination rank
    flat_ids = ids.reshape(-1).to(torch.int64)
    dest = flat_ids // n_local
    slot = _slot_of(dest, model_n)
    keep = slot < cap_out
    tok_idx = torch.arange(flat_ids.shape[0], device=x.device) // m.top_k
    trash = model_n * cap_out
    row = torch.where(keep, dest * cap_out + slot,
                      torch.full_like(dest, trash))
    send = xt.new_zeros((trash + 1, D))
    send.index_put_((row,), xt[tok_idx])
    meta = torch.zeros(trash + 1, dtype=torch.int32, device=x.device)
    meta.index_put_((row,), (flat_ids % n_local + 1).to(torch.int32))
    recv = _mesh.all_to_all(mesh, send[:trash].view(model_n, cap_out, D),
                            "model")
    meta_r = _mesh.all_to_all(mesh, meta[:trash].view(model_n, cap_out),
                              "model")

    # ---- stage 2: bucket arrivals by local expert
    arr = recv.reshape(model_n * cap_out, D)
    eid = meta_r.reshape(-1).to(torch.int64)             # 0 = empty slot
    e1 = torch.where(eid > 0, eid - 1, torch.full_like(eid, n_local))
    slot2 = _slot_of(e1, n_local + 1)
    keep2 = (eid > 0) & (slot2 < C2)
    if _DROPS is not None:
        _DROPS.append((~keep).sum() + ((eid > 0) & ~keep2).sum())
    trash2 = n_local * C2
    row2 = torch.where(keep2, e1 * C2 + slot2, torch.full_like(e1, trash2))
    buf = arr.new_zeros((trash2 + 1, D))
    buf.index_put_((row2,), arr)
    ye = _expert_ffn(cfg, params["up"], params["gate"], params["down"],
                     buf[:trash2].view(n_local, C2, D)).reshape(trash2, D)
    back = torch.where(keep2[:, None], ye[row2.clamp(max=trash2 - 1)],
                       torch.zeros((), dtype=ye.dtype, device=ye.device))
    ret = _mesh.all_to_all(mesh, back.view(model_n, cap_out, D), "model")

    # ---- combine on the source rank
    w_flat = weights.reshape(-1)
    src_row = dest * cap_out + slot.clamp(max=cap_out - 1)
    contrib = ret.reshape(trash, D)[src_row] * (
        w_flat * keep.to(w_flat.dtype))[:, None]
    y = contrib.view(T, m.top_k, D).sum(1)
    if m.n_shared:
        y = y + L.mlp(_gathered_shared(mesh, params["shared"], cfg), xt,
                      cfg.act, cfg.gated)
    aux = _pmean(mesh, aux, batch_axes)
    return y.view(B_l, S_l, D), aux
