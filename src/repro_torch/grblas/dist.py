"""Distributed SpMM over ``torch.distributed``: a row-block partition
with a halo (remote-row) exchange.  Port of ``repro.grblas.dist``.

Row-block 1-D partition: rank d owns rows [d*R, (d+1)*R).
``make_row_partition`` precomputes on the host, from the ELL pattern,
the remote rows each shard's columns touch and a static send plan, so
``shard_mxm`` exchanges only those halo rows (one ``all_to_all_single``)
instead of all-gathering the multivector.  When the padded halo would
move more data than the gather (dense cuts, bad placement), the plan
falls back to the gather at build time (``HALO_FALLBACK_FRAC``).  The
plan is plain numpy and produces the reference's integers; its arrays
move to a rank's device only at execution (each rank takes its own
shard's, cached on the partition).

Graph-aware placement: an ``assignment`` (a cluster id per row, e.g.
from ``partition_for_mesh``) permutes rows so same-cluster rows share a
shard; the halo then holds only cut rows.  The permutation is internal:
X arrives and Y returns in the ORIGINAL row space.

``sellcs=True`` also slices each shard's rows as SELL-C-σ
(``DistSellCS``): a per-shard degree sort, C-row slices, widths maxed
across shards.  The "dist_sellcs" backend runs a shard's product through
the SELL-C-σ CUDA kernels (``kernels.sellcs_spmm.sellcs_shard_*``).

Execution is SPMD: one process a rank, each holding the same global X
and returning the same global Y.  A rank takes only its own row block
of X, reads every remote row through the planned exchange, computes its
(R, k) block and all-gathers the blocks.  ``init_distributed`` /
``device_mesh`` are the launch path: a guarded ``init_process_group``
and a 1-D ``launch.mesh.Mesh`` naming this rank, its device and the
collective backend (nccl when each rank has a card of its own, gloo
otherwise; gloo on CUDA ranks stages each collective's buffers through
pinned host memory).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as tdist

from repro_torch.device import DeviceLike
from repro_torch.grblas.containers import SparseMatrix
from repro_torch.launch import mesh as _mesh
from repro_torch.launch.mesh import (Mesh, init_distributed,
                                     is_distributed_initialized)
from repro_torch.grblas.semiring import (EdgeSemiring, Semiring, fast_paths,
                                         reals_ring)
from repro_torch.obs import metrics as _obs_metrics
from repro_torch.obs import trace as _obs_trace

# Build-time halo/gather decision: take the halo path only while the
# padded per-pair halo width H stays under this fraction of the shard
# row count R.  Per shard the halo moves (S-1)·H rows vs the gather's
# (S-1)·R, so the fraction is exactly the wire-byte ratio of the two.
HALO_FALLBACK_FRAC = 0.5


@dataclasses.dataclass
class DistSellCS:
    """Per-shard SELL-C-σ slicing of a row partition (host numpy).

    Every shard sorts its own R rows by degree, slices them into C-row
    blocks, and pads each slice to the *cross-shard* max width of that
    slice index, so all shards share one set of width runs.  Column ids
    index the shard's extended-local vector (locals then halo slots;
    global x under a gather-mode plan), ``own`` holds each packed row's
    local id, and ``inv`` un-sorts the packed output back to local row
    order.  Pad rows of the last slice (packed positions >= R) hold
    own = 0, col = 0 and val = 0.
    """

    run_cols: Tuple[np.ndarray, ...]   # per run (S, rows_r, w_r) int32
    run_vals: Tuple[np.ndarray, ...]   # per run (S, rows_r, w_r)
    run_own: Tuple[np.ndarray, ...]    # per run (S, rows_r) int32 local row
    inv: np.ndarray                    # (S, R) int32 local row -> packed pos
    sell_c: int
    n_pad_local: int                   # R rounded up to a multiple of C


class RowPartitionedMatrix:
    """ELL layout split into (n_shards, rows_per_shard, max_nnz) plus a
    static halo-exchange plan, all host numpy.

    ``mode`` is decided at build time: "halo" stores column ids remapped
    into each shard's extended-local space [0, R + S·H) plus the send
    plan; "gather" (the fallback) stores global column ids and
    all-gathers X.  A rank's arrays are copied to its device at its
    first product and kept (``_on_device``).
    """

    def __init__(self, ell_cols, ell_vals, n_rows, n_cols, n_shards,
                 perm=None, inv_perm=None, mode="gather", halo_width=0,
                 send_idx=None, halo_rows_true=0, sell=None):
        self.ell_cols = ell_cols    # (S, R, M) int32; extended-local ids in
        self.ell_vals = ell_vals    # (S, R, M)    halo mode, global in gather
        self.n_rows = n_rows        # original (unpadded) row count
        self.n_cols = n_cols
        self.n_shards = n_shards
        self.perm = perm            # (n,) position -> original row, or None
        self.inv_perm = inv_perm    # (n,) original row -> position, or None
        self.mode = mode            # "halo" | "gather"
        self.halo_width = halo_width        # H: padded rows per (dst, src) pair
        self.send_idx = send_idx            # (S, S*H) int32 local rows to ship
        self.halo_rows_true = halo_rows_true  # sum of true (unpadded) needs
        self.sell = sell            # DistSellCS or None
        self._on_device = {}        # (rank, device, what) -> device arrays

    @property
    def rows_per_shard(self) -> int:
        return self.ell_cols.shape[1]

    def wire_bytes(self, k: int = 1, itemsize: int = 4) -> dict:
        """Analytic per-call communication volume of each schedule.

        The all_to_all self-chunk and the gather's own shard never cross
        the wire, so both counts use (S-1) partners per shard.  On a plan
        that auto-fell back to the gather, "halo" reports what the
        rejected halo WOULD have moved; on a forced mode="gather" plan no
        halo was computed and "halo" is 0.  The all-gather of the output
        blocks (S·(S-1)·R·k·itemsize) is not counted, as in the
        reference.
        """
        S, R = self.n_shards, self.rows_per_shard
        return {
            "halo": S * (S - 1) * self.halo_width * k * itemsize,
            "gather": S * (S - 1) * R * k * itemsize,
            "halo_rows_true": int(self.halo_rows_true),
            "halo_width": int(self.halo_width),
        }


def _halo_plan(ell_cols: np.ndarray, n_shards: int, R: int):
    """Remote-row needs of each shard, from the partitioned ELL pattern.

    Returns (needed, H, total_true): ``needed[d][s]`` is the sorted array
    of global rows shard d reads from shard s (empty for s == d), H the
    max list length (the padded width), total_true the sum of all list
    lengths (the unpadded halo volume).
    """
    needed = []
    H = 0
    total = 0
    for d in range(n_shards):
        cols_d = np.unique(ell_cols[d])
        owner = cols_d // R
        per_src = []
        for s in range(n_shards):
            rows_s = cols_d[owner == s] if s != d else np.empty(0, np.int64)
            per_src.append(rows_s.astype(np.int64))
            H = max(H, len(rows_s))
            total += len(rows_s)
        needed.append(per_src)
    return needed, H, total


def _remap_local(ell_cols: np.ndarray, needed, n_shards: int, R: int,
                 H: int) -> np.ndarray:
    """Rewrite global column ids into each shard's extended-local space:
    local rows keep [0, R); the h-th row needed from shard s lands at
    R + s*H + h, exactly where the all_to_all deposits it."""
    out = np.empty_like(ell_cols)
    for d in range(n_shards):
        c = ell_cols[d].astype(np.int64)
        o = c // R
        loc = c - d * R
        for s in range(n_shards):
            if s == d:
                continue
            m = o == s
            if not m.any():
                continue
            pos = np.searchsorted(needed[d][s], c[m])
            loc[m] = R + s * H + pos
        out[d] = loc.astype(np.int32)
    return out


def _send_plan(needed, n_shards: int, R: int, H: int) -> np.ndarray:
    """(S, S*H) send plan: row block d of sender s lists the *local* row
    ids s ships to d (pad slots resend row 0; recipients never read
    them, their remap stops at the true list length)."""
    send = np.zeros((n_shards, n_shards * H), np.int32)
    for d in range(n_shards):
        for s in range(n_shards):
            rows = needed[d][s]
            send[s, d * H:d * H + len(rows)] = rows - s * R
    return send


def _build_dist_sellcs(ell_cols_x: np.ndarray, ell_vals: np.ndarray,
                       counts: np.ndarray, C: int) -> DistSellCS:
    """Per-shard SELL-C slicing of the partitioned ELL arrays.

    ``ell_cols_x`` is already in the execution index space (extended-
    local for halo plans, global for gather plans); ``counts`` holds the
    true per-row entry count (S, R) so pads are dropped, not repacked.
    Widths are maxed across shards per slice index.
    """
    S, R, M = ell_cols_x.shape
    C = max(int(C), 1)
    n_slices = -(-R // C)
    R_pad = n_slices * C

    orders = np.empty((S, R_pad), np.int64)
    widths = np.empty((S, n_slices), np.int64)
    for d in range(S):
        cnt = np.full(R_pad, -1, np.int64)
        cnt[:R] = counts[d]
        order = np.argsort(-cnt, kind="stable")    # σ = R: whole-shard sort
        orders[d] = order
        widths[d] = np.maximum(
            cnt[order].reshape(n_slices, C).max(axis=1), 1)
    slice_w = widths.max(axis=0)                   # cross-shard max per slice
    run_bounds = np.concatenate(
        [[0], np.flatnonzero(np.diff(slice_w)) + 1, [n_slices]])

    run_cols, run_vals, run_own = [], [], []
    for r in range(len(run_bounds) - 1):
        s0, s1 = int(run_bounds[r]), int(run_bounds[r + 1])
        w = int(slice_w[s0])
        rows_r = (s1 - s0) * C
        cols_r = np.empty((S, rows_r, w), np.int32)
        vals_r = np.zeros((S, rows_r, w), ell_vals.dtype)
        own_r = np.zeros((S, rows_r), np.int32)
        slot = np.arange(w)[None, :]
        for d in range(S):
            sel = orders[d, s0 * C:s1 * C]         # packed rows of this run
            real = sel < R
            safe = np.where(real, sel, 0)
            deg = np.where(real, counts[d][safe], 0)
            keep = slot < deg[:, None]
            cw = ell_cols_x[d][safe, :w] if w <= M else np.pad(
                ell_cols_x[d][safe], ((0, 0), (0, w - M)))
            vw = ell_vals[d][safe, :w] if w <= M else np.pad(
                ell_vals[d][safe], ((0, 0), (0, w - M)))
            own = np.where(real, sel, 0).astype(np.int32)
            cols_r[d] = np.where(keep, cw, own[:, None])
            vals_r[d] = np.where(keep, vw, 0)
            own_r[d] = own
        run_cols.append(cols_r)
        run_vals.append(vals_r)
        run_own.append(own_r)

    inv = np.empty((S, R_pad), np.int64)
    for d in range(S):
        inv[d, orders[d]] = np.arange(R_pad)
    return DistSellCS(run_cols=tuple(run_cols), run_vals=tuple(run_vals),
                      run_own=tuple(run_own),
                      inv=inv[:, :R].astype(np.int32),
                      sell_c=C, n_pad_local=R_pad)


def make_row_partition(A: SparseMatrix, n_shards: int,
                       assignment: Optional[np.ndarray] = None, *,
                       mode: str = "auto",
                       halo_threshold: float = HALO_FALLBACK_FRAC,
                       sellcs: bool = False,
                       sell_c: int = 32) -> RowPartitionedMatrix:
    """Split A's ELL rows into n_shards contiguous blocks and precompute
    the halo-exchange plan (all host-side).

    If ``assignment`` (a cluster id per row) is given, rows are permuted
    so same-cluster rows are contiguous; the permutation is internal to
    the layout.  ``mode``: "auto" builds the halo plan and falls back to
    the gather when the padded halo width exceeds ``halo_threshold * R``;
    "halo" / "gather" force a schedule.  ``sellcs=True`` adds the
    per-shard SELL-C-σ slicing (DistSellCS).
    """
    if A.ell_cols is None:
        raise ValueError("make_row_partition needs the ELL layout "
                         "(build_ell=True)")
    if mode not in ("auto", "halo", "gather"):
        raise ValueError(f"mode must be auto|halo|gather, got {mode!r}")
    ell_cols = A.ell_cols.cpu().numpy()
    ell_vals = A.ell_vals.cpu().numpy()
    n, m = ell_cols.shape
    square = A.n_rows == A.n_cols
    perm = inv = None
    if assignment is not None:
        if not square:
            raise ValueError(
                "graph-aware placement permutes rows and columns with one "
                "permutation and requires a square operator")
        perm = np.argsort(np.asarray(assignment), kind="stable")
        inv = np.empty_like(perm)
        inv[perm] = np.arange(n)
        # permute rows AND remap column ids into the permuted numbering
        ell_cols, ell_vals = inv[ell_cols[perm]].astype(np.int32), ell_vals[perm]
    pad = (-n) % n_shards
    if pad:
        # padded rows reference THEMSELVES with weight 0 (no-ops that
        # stay shard-local; column 0 would drag row 0 into every halo)
        self_cols = np.repeat(np.arange(n, n + pad, dtype=np.int32)[:, None],
                              m, axis=1)
        ell_cols = np.concatenate([ell_cols, self_cols])
        ell_vals = np.concatenate([ell_vals, np.zeros((pad, m), ell_vals.dtype)])
    R = (n + pad) // n_shards
    ell_cols = ell_cols.reshape(n_shards, R, m)
    ell_vals = ell_vals.reshape(n_shards, R, m)

    # true per-row entry counts in partitioned order (pads excluded):
    # the sellcs slicer sorts on these, not on the padded ELL width
    counts = None
    if sellcs:
        counts = np.bincount(A.host_coo()[0], minlength=n)
        if perm is not None:
            counts = counts[perm]
        counts = np.concatenate(
            [counts, np.zeros(pad, counts.dtype)]).reshape(n_shards, R)

    use_halo = square and n_shards > 1 and mode != "gather"
    H = total = 0
    if use_halo:
        needed, H, total = _halo_plan(ell_cols, n_shards, R)
        if mode == "auto" and H > halo_threshold * R:
            use_halo = False
            # a partition that planned a halo but ships the gather
            _obs_metrics.DEFAULT.counter("dist_gather_fallback_total").inc()
            _obs_trace.ACTIVE.instant(
                "dist.gather_fallback", n=A.n_rows, n_shards=n_shards,
                halo_width=int(H), rows_per_shard=int(R))
    if use_halo:
        cols_local = _remap_local(ell_cols, needed, n_shards, R, H)
        Ap = RowPartitionedMatrix(
            ell_cols=cols_local, ell_vals=ell_vals,
            n_rows=A.n_rows, n_cols=A.n_cols, n_shards=n_shards,
            perm=perm, inv_perm=inv, mode="halo", halo_width=H,
            send_idx=_send_plan(needed, n_shards, R, H),
            halo_rows_true=total)
        cols_x = cols_local
    else:
        if mode == "halo":
            raise ValueError(
                "mode='halo' requires a square operator and n_shards > 1 "
                "(the halo plan partitions one row == column space)")
        # an auto fallback keeps the computed (H, total) so wire_bytes
        # still reports what the rejected halo WOULD have moved
        Ap = RowPartitionedMatrix(
            ell_cols=ell_cols, ell_vals=ell_vals,
            n_rows=A.n_rows, n_cols=A.n_cols, n_shards=n_shards,
            perm=perm, inv_perm=inv, mode="gather", halo_width=H,
            halo_rows_true=total)
        cols_x = ell_cols
    if sellcs:
        Ap.sell = _build_dist_sellcs(cols_x, ell_vals, counts, sell_c)
    return Ap


# ---------------------------------------------------------------- the mesh

def device_mesh(axis: str = "data", n_shards: Optional[int] = None,
                device: DeviceLike = None) -> Mesh:
    """1-D mesh over every rank for the dist backends: ``launch.mesh``'s
    ``Mesh`` with the one axis ``axis``.

    Calls ``init_distributed`` first; in one process the mesh has one
    rank.  ``n_shards``, if given, must equal the number of ranks.  A
    CUDA rank's card becomes the current device.  Prints the mesh: its
    size, this rank's device and the collective backend."""
    init_distributed(device=device)
    size = tdist.get_world_size() if is_distributed_initialized() else 1
    if n_shards is not None and int(n_shards) != size:
        raise ValueError(f"device_mesh(n_shards={n_shards}) in a run of "
                         f"{size} rank(s): one shard a rank")
    mesh = _mesh.build_mesh((axis,), (size,), device)
    print(f"device_mesh: rank {mesh.rank} of {size} on {mesh.device}, "
          f"collectives over {mesh.backend or 'none (one process)'}"
          + (", buffers staged through pinned host memory"
             if mesh.staged else ""), flush=True)
    return mesh


def _all_to_all(mesh: Mesh, send: torch.Tensor) -> torch.Tensor:
    """Equal-split all_to_all_single along dim 0 over the mesh's axis
    (block s of the result is what rank s sent this rank)."""
    return _mesh.all_to_all(mesh, send, mesh.axis)


def _all_gather(mesh: Mesh, block: torch.Tensor) -> torch.Tensor:
    """(m, k) blocks of every rank, stacked in rank order: (S*m, k)."""
    return _mesh.all_gather(mesh, block, mesh.axis, 0)


# ----------------------------------------------------------------- execution

# Fault-injection seam (repro_torch.testing.faultinject): when set, the
# hook rewrites the received halo block after the exchange,
# fn(recv, Ap) -> recv.  Production leaves it None.
_HALO_FAULT_HOOK = None


def set_halo_fault_hook(hook) -> None:
    global _HALO_FAULT_HOOK
    _HALO_FAULT_HOOK = hook


def shard_mxm(Ap: RowPartitionedMatrix, X: torch.Tensor, mesh: Mesh,
              axis: str = "data",
              ring: Semiring | EdgeSemiring = reals_ring,
              layout: str = "ell") -> torch.Tensor:
    """Distributed SpMM: rows sharded over the mesh's ranks, halo rows
    exchanged (or X all-gathered under a gather plan).

    The execute hook of the "dist" / "dist_sellcs" backends.  X:
    (n_cols,) or (n_cols, k) in the ORIGINAL row space, the same on
    every rank; returns the global Y, the same on every rank, so
    dist == single-device for every plan.  Placement is applied
    internally and the output un-permuted (pads sliced first).
    """
    S = Ap.n_shards
    if int(mesh.shape[axis]) != S:
        raise ValueError(
            f"partition was built for {S} shards but mesh axis {axis!r} "
            f"has size {int(mesh.shape[axis])}: rebuild with "
            f"make_row_partition(A, {int(mesh.shape[axis])})")
    if layout not in ("ell", "sellcs"):
        raise ValueError(f"layout must be ell|sellcs, got {layout!r}")
    if layout == "sellcs" and Ap.sell is None:
        raise ValueError(
            "this RowPartitionedMatrix was built without the per-shard "
            "SELL-C-σ layout: pass sellcs=True to make_row_partition")
    if X.shape[0] != Ap.n_cols:
        raise ValueError(f"X has {X.shape[0]} rows, the operator "
                         f"{Ap.n_cols} columns")
    tr = _obs_trace.ACTIVE
    if tr.enabled and not _obs_trace.under_trace():
        k_eff = int(X.shape[1]) if X.ndim > 1 else 1
        wb = Ap.wire_bytes(k_eff, X.element_size())
        wire = int(wb["halo"] if Ap.mode == "halo" else wb["gather"])
        with tr.span("dist.shard_mxm", cat="dist", mode=Ap.mode,
                     n=Ap.n_rows, n_shards=S, k=k_eff,
                     halo_width=int(Ap.halo_width), wire_bytes=wire,
                     layout=layout) as sp:
            out = _shard_mxm_impl(Ap, X, mesh, ring, layout)
            sp.fence(out)
        _obs_metrics.DEFAULT.counter("dist_wire_bytes_total",
                                     mode=Ap.mode).inc(wire)
        _obs_metrics.DEFAULT.counter("dist_shard_mxm_total",
                                     mode=Ap.mode).inc()
        return out
    return _shard_mxm_impl(Ap, X, mesh, ring, layout)


def _on_device(Ap: RowPartitionedMatrix, d: int, device: torch.device,
               what: str, build):
    key = (d, str(device), what)
    if key not in Ap._on_device:
        Ap._on_device[key] = build()
    return Ap._on_device[key]


def _own_rows(Ap, X, d: int) -> torch.Tensor:
    """Rank d's row block of X after the placement permutation and the
    pad: positions [d*Lb, (d+1)*Lb) of the padded, permuted X, where
    Lb = R under a halo plan and L/S under a gather plan (L: X's rows
    rounded up to a multiple of S, at least S*R)."""
    S, R, n_x = Ap.n_shards, Ap.rows_per_shard, X.shape[0]
    L = S * R if Ap.mode == "halo" else max(-(-n_x // S) * S, S * R)
    Lb = L // S
    lo, hi = d * Lb, min((d + 1) * Lb, n_x)
    n_real = max(hi - lo, 0)
    if n_real == Lb and Ap.perm is None:
        return X[lo:hi]
    x_local = X.new_zeros((Lb, X.shape[1]))
    if n_real:
        if Ap.perm is None:
            x_local[:n_real] = X[lo:hi]
        else:
            take = _on_device(Ap, d, X.device, "take", lambda: torch.as_tensor(
                Ap.perm[lo:hi], dtype=torch.long, device=X.device))
            x_local[:n_real] = X[take]
    return x_local


def _shard_mxm_impl(Ap, X, mesh, ring, layout):
    d, dev = mesh.rank, X.device
    edge = isinstance(ring, EdgeSemiring)
    one_d = X.ndim == 1
    if one_d:
        X = X[:, None]
    x_local = _own_rows(Ap, X, d)
    if Ap.mode == "halo":
        x_src = x_local
        if Ap.halo_width:
            send = _on_device(Ap, d, dev, "send", lambda: torch.as_tensor(
                Ap.send_idx[d], dtype=torch.long, device=dev))
            recv = _all_to_all(mesh, x_local[send])   # block s: from rank s
            if _HALO_FAULT_HOOK is not None:
                recv = _HALO_FAULT_HOOK(recv, Ap)
            x_src = torch.cat([x_local, recv], dim=0)
    else:
        x_src = _all_gather(mesh, x_local)
    if layout == "sellcs":
        out = _shard_sellcs(Ap, d, x_src, ring, edge)
    else:
        out = _shard_ell(Ap, d, x_src, x_local, ring, edge)

    Y = _all_gather(mesh, out)[: Ap.n_rows]   # slice pads FIRST ...
    if Ap.inv_perm is not None:              # ... then un-permute
        inv = _on_device(Ap, d, dev, "inv_perm", lambda: torch.as_tensor(
            Ap.inv_perm, dtype=torch.long, device=dev))
        Y = Y[inv]
    return Y[:, 0] if one_d else Y


def _shard_ell(Ap, d, x_src, x_local, ring, edge):
    """Rank d's (R, k) block on the padded ELL rows: a gather and a sum
    (pad slots carry val = 0, which every ring the dist backends admit
    annihilates)."""
    cols, vals = _on_device(Ap, d, x_src.device, "ell", lambda: (
        torch.as_tensor(Ap.ell_cols[d], dtype=torch.long,
                        device=x_src.device),
        torch.as_tensor(Ap.ell_vals[d], device=x_src.device)))
    gathered = x_src[cols]                                # (R, M, k)
    v = vals[..., None]
    if edge:
        # x_i is this shard's own rows (edge rings are square-gated, so
        # the row and column spaces and their paddings coincide)
        contrib = ring.edge_mul(v, gathered, x_local[:, None, :])
    else:
        contrib = ring.mul(v, gathered)
    # pscheck: disable=pad-fold (pad slots carry val=0 and every ring the dist backends admit via _dist_supports annihilates zero contributions, so the width-axis fold is pad-sound by the capability gate)
    return torch.sum(contrib, dim=1)


def _shard_sellcs(Ap, d, x_src, ring, edge):
    """Rank d's block on its SELL-C-σ slices: the shard launches of the
    SELL-C-σ kernels for the reals ring and the p-Laplacian apply (their
    plain versions on a CPU rank); any other padded ring folds each run
    in plain PyTorch."""
    from repro_torch.kernels import sellcs_spmm as K

    sell = Ap.sell
    # under a gather plan x_src is the whole gathered vector and rank
    # d's own rows start at d*R
    row0 = 0 if Ap.mode == "halo" else d * Ap.rows_per_shard
    sh = _on_device(Ap, d, x_src.device, "sell", lambda: K.shard_layout(
        [c[d] for c in sell.run_cols], [v[d] for v in sell.run_vals],
        [o[d] for o in sell.run_own], sell.inv[d], sell.sell_c, row0,
        x_src.device))
    x_src = x_src.contiguous()
    if edge:
        p, eps = ring.params
        return K.sellcs_shard_plap_apply(sh, x_src, float(p), float(eps))
    if ring.name == "reals_+x":
        return K.sellcs_shard_spmm(sh, x_src)
    outs = [fast_paths(ring).padded(ring.mul(v[..., None], x_src[c.long()]))
            for c, v, _ in sh.runs]
    return torch.cat(outs, dim=0)[sh.inv]
