"""Graph coarsening: heavy-edge matching + Galerkin triple products
(port of ``repro.multilevel.coarsen``).

One coarsening step contracts a matching of the graph: matched pairs
(and joined leaves) become the coarse vertices, and the coarse operator
is the Galerkin triple product

    W_c = Pᵀ W P

with P the (n_fine × n_coarse) partition-of-unity prolongator (one entry
of value 1 per fine row).  Both products are ``grblas.api.mxm`` calls
through the host-side "spgemm" backend.  Self-loops created by
contraction are kept, so weighted degrees are preserved level to level
(the p-Laplacian ignores them: φ_p(0) = 0), and ``counts`` carries the
finest vertices per aggregate as Pᵀ 1.

Everything here is deterministic host numpy, the reference's own
algorithm, so aggregates, prolongators and coarse COO triples equal the
reference's; the levels' graphs, volumes and counts live on the fine
graph's device.  ``patch_hierarchy`` rebuilds a hierarchy for an edited
graph (the serve engine's churn path), re-matching only near the edits.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.grblas import api
from repro_torch.grblas.api import Descriptor
from repro_torch.grblas.containers import SparseMatrix

_T = Descriptor(transpose=True)


def heavy_edge_matching(W: SparseMatrix, rounds: int = 8,
                        max_agg: int = 4) -> np.ndarray:
    """Aggregate ids from handshake heavy-edge matching + leaf joining.

    Returns ``agg`` (n,) int64 with agg[i] in [0, n_coarse).

    1. handshake HEM (``rounds`` times): every live vertex prefers its
       heaviest incident edge (ties: lower neighbour degree, then lower
       id); mutual preferences contract into pairs.
    2. leaf joining: vertices the handshake left single join the
       aggregate of their heaviest neighbour, at most ``max_agg`` members
       per aggregate (accepted heaviest-first).
    """
    n = W.n_rows
    rows, cols, vals = W.host_coo()
    rows, cols = rows.astype(np.int64), cols.astype(np.int64)
    if vals.ndim != 1:
        raise ValueError("heavy_edge_matching needs scalar edge weights")
    off = rows != cols
    rows, cols, vals = rows[off], cols[off], vals[off]
    deg = np.bincount(rows, minlength=n)

    match = np.full(n, -1, np.int64)
    ids = np.arange(n, dtype=np.int64)
    for _ in range(max(int(rounds), 1)):
        live = (match[rows] < 0) & (match[cols] < 0)
        if not live.any():
            break
        r_l, c_l, v_l = rows[live], cols[live], vals[live]
        # per-row best edge by (weight desc, neighbour degree asc, id asc)
        order = np.lexsort((c_l, deg[c_l], -v_l, r_l))
        r_s = r_l[order]
        uniq_rows, first = np.unique(r_s, return_index=True)
        pref = np.full(n, -1, np.int64)
        pref[uniq_rows] = c_l[order[first]]
        ok = pref >= 0
        mutual = ids[ok][pref[pref[ok]] == ids[ok]]
        lo = mutual[mutual < pref[mutual]]     # each pair once, from its
        hi = pref[lo]                          # lower endpoint
        match[lo] = hi
        match[hi] = lo
    rep = np.where((match >= 0) & (match < ids), match, ids)

    # -- phase 2: singletons join their heaviest neighbour's aggregate
    single = match < 0
    if single.any() and max_agg > 2:
        cand = single[rows] & ~single[cols]    # edges singleton -> matched
        if cand.any():
            r_c, c_c, v_c = rows[cand], cols[cand], vals[cand]
            order = np.lexsort((c_c, -v_c, r_c))
            r_s = r_c[order]
            uniq_rows, first = np.unique(r_s, return_index=True)
            target = rep[c_c[order[first]]]    # aggregate representative
            sizes = np.bincount(rep, minlength=n)
            w_best = v_c[order[first]]
            by_tgt = np.lexsort((uniq_rows, -w_best, target))
            tgt_s = target[by_tgt]
            t_counts = np.bincount(tgt_s, minlength=n)
            t_starts = np.concatenate([[0], np.cumsum(t_counts)[:-1]])
            present = np.unique(tgt_s)
            rank = np.arange(len(tgt_s)) - np.repeat(t_starts[present],
                                                     t_counts[present])
            accept = rank < (max_agg - sizes)[tgt_s]
            rep[uniq_rows[by_tgt][accept]] = tgt_s[accept]

    _, agg = np.unique(rep, return_inverse=True)   # compact to [0, n_c)
    return agg


def prolongator_from_aggregates(agg: np.ndarray, n_coarse: int,
                                dtype=torch.float32,
                                device=None) -> SparseMatrix:
    """The partition-of-unity prolongator P (n_fine × n_coarse):
    P[i, agg[i]] = 1."""
    n = len(agg)
    return SparseMatrix.from_coo(np.arange(n), np.asarray(agg, np.int64),
                                 np.ones(n), (n, int(n_coarse)), dtype=dtype,
                                 device=device)


@dataclasses.dataclass
class CoarsenInfo:
    n_fine: int
    n_coarse: int
    agg: np.ndarray            # fine vertex -> aggregate id


@dataclasses.dataclass
class Level:
    W: SparseMatrix            # graph at this level (finest = level 0)
    vol: torch.Tensor          # finest weighted-degree mass per vertex
    counts: torch.Tensor       # finest vertices per vertex


@dataclasses.dataclass
class Hierarchy:
    levels: List[Level]                  # levels[0] is the finest
    prolongators: List[SparseMatrix]     # P[l]: level l+1 -> level l
    infos: List[CoarsenInfo]

    @property
    def n_levels(self) -> int:
        return len(self.levels)

    @property
    def coarsest(self) -> Level:
        return self.levels[-1]

    def aggregate_of_finest(self, level: int) -> np.ndarray:
        """Composed map: finest vertex -> its aggregate at ``level``."""
        agg = np.arange(self.levels[0].W.n_rows, dtype=np.int64)
        for info in self.infos[:level]:
            agg = info.agg[agg]
        return agg

    def prolong_labels(self, labels: np.ndarray) -> np.ndarray:
        """Coarsest labels -> finest labels (constant on aggregates)."""
        return np.asarray(labels)[self.aggregate_of_finest(self.n_levels - 1)]


def _sparsify_rowcap(rows, cols, vals, n, cap):
    """Per-row top-``cap`` edge filter with diagonal compensation: each
    row keeps its ``cap`` heaviest off-diagonal entries (union over both
    endpoint rows, so symmetry survives) and every dropped entry's weight
    moves to that row's self-loop, so row sums are preserved exactly.
    Ranking ties break by column id."""
    off = rows != cols
    ro, co, vo = rows[off], cols[off], vals[off]
    order = np.lexsort((co, -vo, ro))
    ro_s = ro[order]
    counts = np.bincount(ro_s, minlength=n)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    rank = np.arange(len(ro_s)) - np.repeat(starts, counts)
    keep_dir = np.empty(len(ro), bool)
    keep_dir[order] = rank < cap
    lo = np.minimum(ro, co)
    hi = np.maximum(ro, co)
    uniq, inv = np.unique(lo * n + hi, return_inverse=True)
    kept_pair = np.zeros(len(uniq), bool)
    np.logical_or.at(kept_pair, inv, keep_dir)
    keep = kept_pair[inv]
    lump = np.bincount(ro[~keep], weights=vo[~keep], minlength=n)
    diag_vals = np.bincount(rows[~off], weights=vals[~off], minlength=n) + lump
    dnz = np.nonzero(diag_vals)[0]
    return (np.concatenate([ro[keep], dnz]),
            np.concatenate([co[keep], dnz]),
            np.concatenate([vo[keep], diag_vals[dnz]]))


def coarsen_graph(W: SparseMatrix, rounds: int = 8,
                  layout_kwargs: Optional[dict] = None,
                  sparsify_cap: Optional[int] = None,
                  max_agg: int = 4,
                  ) -> Tuple[SparseMatrix, SparseMatrix, CoarsenInfo]:
    """One coarsening step: (P, W_c, info).

    W_c = Pᵀ (W P), both factors through ``api.mxm`` (spgemm), rebuilt
    with ``from_coo`` so the coarse graph gets the derived layouts a fine
    graph would (the auto policy, plus ``layout_kwargs``).
    ``sparsify_cap`` keeps at most this many off-diagonal entries per
    coarse row (``_sparsify_rowcap``); None = exact Galerkin operator."""
    agg = heavy_edge_matching(W, rounds=rounds, max_agg=max_agg)
    n_coarse = int(agg.max()) + 1 if len(agg) else 0
    P = prolongator_from_aggregates(agg, n_coarse, dtype=W.dtype,
                                    device=W.device)
    WP = api.mxm(W, P)                          # spgemm: (n_f × n_c)
    Wc = api.mxm(P, WP, desc=_T)                # spgemm: Pᵀ (W P)
    rows, cols, vals = Wc.host_coo()
    rows, cols = rows.astype(np.int64), cols.astype(np.int64)
    if sparsify_cap is not None:
        rows, cols, vals = _sparsify_rowcap(rows, cols, vals, n_coarse,
                                            int(sparsify_cap))
    kw = dict(layout_kwargs or {})
    kw.setdefault("dtype", W.dtype)
    kw.setdefault("device", W.device)
    Wc = SparseMatrix.from_coo(rows, cols, vals, (n_coarse, n_coarse), **kw)
    return P, Wc, CoarsenInfo(n_fine=W.n_rows, n_coarse=n_coarse, agg=agg)


def auto_sparsify_cap(W: SparseMatrix) -> int:
    """Degree cap for coarse-level sparsification: the finest graph's
    mean stored degree, floored at 12."""
    mean_deg = W.nnz / max(W.n_rows, 1)
    return max(int(np.ceil(mean_deg)), 12)


def _sparsify_cap(W: SparseMatrix, sparsify) -> Optional[int]:
    """The coarse-row degree cap ``sparsify`` names: "auto" for
    ``auto_sparsify_cap(W)``, None/False for none, or an explicit int."""
    if sparsify == "auto":
        return auto_sparsify_cap(W)
    if sparsify is None or sparsify is False:
        return None
    cap = int(sparsify)
    if cap < 1:
        raise ValueError(f"sparsify cap must be >= 1, got {cap}")
    return cap


def patch_hierarchy(hier: Hierarchy, W_new: SparseMatrix,
                    touched: np.ndarray, rounds: int = 8,
                    max_agg: int = 4,
                    layout_kwargs: Optional[dict] = None,
                    sparsify="auto") -> Tuple[Hierarchy, List[dict]]:
    """Rebuild a hierarchy for an edited graph, reusing the old matching
    wherever the edit cannot have reached.

    ``touched`` lists the finest vertices incident to pattern edits.  At
    every level only vertices within distance 1 of a touched vertex are
    re-matched (on their induced subgraph); every aggregate holding none
    of them keeps its members, its prolongator rows equal up to the id
    compaction.  The Galerkin products Pᵀ W P are recomputed at every
    level (the weights changed); the multi-round matching, the host
    cost of ``build_hierarchy``, is what is saved, and aggregate ids
    stay stable on the untouched region so a cached embedding restricts
    onto it coherently.  Aggregates born from a re-match are touched at
    the next level up, so the dirty set contracts with the graph.

    Returns (hierarchy, records): per level, the vertex and coarse
    counts, the dirty and re-matched vertices and the kept aggregates.
    """
    cap = _sparsify_cap(W_new, sparsify)
    if W_new.n_rows != hier.levels[0].W.n_rows:
        raise ValueError("patch_hierarchy: vertex count changed; rebuild "
                         "the hierarchy instead")
    W = W_new
    vol = W.row_sums()
    counts = torch.ones(W.n_rows, dtype=W.dtype, device=W.device)
    levels = [Level(W=W, vol=vol, counts=counts)]
    prolongators: List[SparseMatrix] = []
    infos: List[CoarsenInfo] = []
    records: List[dict] = []
    kw = dict(layout_kwargs or {})
    kw.setdefault("dtype", W.dtype)
    kw.setdefault("device", W.device)

    touched = np.unique(np.asarray(touched, np.int64))
    new2old = np.arange(W.n_rows, dtype=np.int64)   # level-l new -> old id
    for info in hier.infos:
        n = W.n_rows
        rows, cols, vals = W.host_coo()
        rows, cols = rows.astype(np.int64), cols.astype(np.int64)
        dirty = np.zeros(n, bool)
        dirty[touched] = True
        dirty[cols[dirty[rows]]] = True             # distance-1 closure
        dirty |= new2old < 0                        # freshly born vertices

        # dissolve every old aggregate with a dirty (or vanished) member
        old_agg = info.agg
        bad = np.zeros(info.n_coarse, bool)
        present = np.zeros(info.n_fine, bool)
        present[new2old[new2old >= 0]] = True
        bad[old_agg[~present]] = True
        bad[old_agg[new2old[dirty & (new2old >= 0)]]] = True
        has_old = new2old >= 0
        dirty[has_old] |= bad[old_agg[new2old[has_old]]]

        # clean vertices keep their old aggregate (compacted ids first)
        kept_old = np.unique(old_agg[new2old[~dirty]]) if (~dirty).any() \
            else np.empty(0, np.int64)
        remap = np.full(info.n_coarse, -1, np.int64)
        remap[kept_old] = np.arange(len(kept_old))
        agg = np.empty(n, np.int64)
        agg[~dirty] = remap[old_agg[new2old[~dirty]]]

        # dirty vertices re-match on their induced subgraph (host only:
        # the matching reads nothing but the host COO)
        d_ids = np.nonzero(dirty)[0]
        n_new_aggs = 0
        if len(d_ids):
            sub_id = np.full(n, -1, np.int64)
            sub_id[d_ids] = np.arange(len(d_ids))
            both = dirty[rows] & dirty[cols]
            Wsub = SparseMatrix.from_coo(
                sub_id[rows[both]], sub_id[cols[both]], vals[both],
                (len(d_ids), len(d_ids)), dtype=W.dtype, device="cpu",
                build_ell=False, build_sellcs=False)
            agg_sub = heavy_edge_matching(Wsub, rounds=rounds,
                                          max_agg=max_agg)
            n_new_aggs = int(agg_sub.max()) + 1 if len(agg_sub) else 0
            agg[d_ids] = len(kept_old) + agg_sub
        n_coarse = len(kept_old) + n_new_aggs

        P = prolongator_from_aggregates(agg, n_coarse, dtype=W.dtype,
                                        device=W.device)
        WP = api.mxm(W, P)
        Wc = api.mxm(P, WP, desc=_T)
        r2, c2, v2 = Wc.host_coo()
        r2, c2 = r2.astype(np.int64), c2.astype(np.int64)
        if cap is not None:
            r2, c2, v2 = _sparsify_rowcap(r2, c2, v2, n_coarse, cap)
        Wc = SparseMatrix.from_coo(r2, c2, v2, (n_coarse, n_coarse), **kw)
        cur = levels[-1]
        levels.append(Level(W=Wc, vol=api.mxm(P, cur.vol, desc=_T),
                            counts=api.mxm(P, cur.counts, desc=_T)))
        prolongators.append(P)
        infos.append(CoarsenInfo(n_fine=n, n_coarse=n_coarse, agg=agg))
        records.append({"n": n, "n_coarse": n_coarse,
                        "n_dirty": int(dirty.sum()),
                        "n_rematched": len(d_ids),
                        "n_kept_aggregates": len(kept_old)})

        # next level: kept aggregates are old coarse ids, re-matched
        # ones are new pattern, touched there
        new2old = np.concatenate(
            [kept_old, np.full(n_new_aggs, -1, np.int64)])
        touched = np.arange(len(kept_old), n_coarse, dtype=np.int64)
        W = Wc
    return Hierarchy(levels=levels, prolongators=prolongators,
                     infos=infos), records


def build_hierarchy(W: SparseMatrix, coarse_size: int = 2048,
                    max_levels: int = 12, min_reduction: float = 0.9,
                    rounds: int = 8,
                    layout_kwargs: Optional[dict] = None,
                    sparsify="auto", max_agg: int = 4) -> Hierarchy:
    """Coarsen repeatedly until at most ``coarse_size`` vertices,
    ``max_levels`` levels, or a step that keeps more than
    ``min_reduction`` of the vertices (matching stagnated).

    ``sparsify``: "auto" caps coarse row degrees at
    ``auto_sparsify_cap(W)``; None/False exact Galerkin at every level;
    an int is an explicit cap.  Volumes and counts are carried as Pᵀ v,
    mxm calls like everything else."""
    cap = _sparsify_cap(W, sparsify)
    vol = W.row_sums()
    counts = torch.ones(W.n_rows, dtype=W.dtype, device=W.device)
    levels = [Level(W=W, vol=vol, counts=counts)]
    prolongators: List[SparseMatrix] = []
    infos: List[CoarsenInfo] = []
    while (levels[-1].W.n_rows > coarse_size
           and len(levels) < max(int(max_levels), 1)):
        cur = levels[-1]
        P, Wc, info = coarsen_graph(cur.W, rounds=rounds,
                                    layout_kwargs=layout_kwargs,
                                    sparsify_cap=cap, max_agg=max_agg)
        if info.n_coarse >= min_reduction * info.n_fine:
            break                                # matching stagnated
        levels.append(Level(W=Wc, vol=api.mxm(P, cur.vol, desc=_T),
                            counts=api.mxm(P, cur.counts, desc=_T)))
        prolongators.append(P)
        infos.append(info)
    return Hierarchy(levels=levels, prolongators=prolongators, infos=infos)
