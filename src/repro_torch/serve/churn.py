"""Incremental re-clustering under edge churn (port of
``repro.serve.churn``).

A deployed clustering index sees the same graph drifting: edges
reweighted, a few inserted or deleted.  This module turns a delta into
the cheapest valid re-solve:

  * weight-only deltas (every edited pair already stored, including a
    down-weight to an explicit zero): the pattern is unchanged, so
    ``SparseMatrix.with_vals`` reuses every layout, SELL-C-σ included,
    and the cached embedding warm-starts the solver at the schedule
    tail;
  * pattern deltas (inserted pairs, or removals with ``drop_removed``):
    the graph is rebuilt with the layouts the old one had, and on the
    multilevel path the cached hierarchy is patched
    (``coarsen.patch_hierarchy``) before a refine-only V-cycle from the
    cached U (``vcycle.refine_cluster``).

The churn path never runs LOBPCG and never descends the p schedule from
2.  The delta is merged on the host (a ``searchsorted`` over the stored
COO keys), as in the reference.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.grblas.containers import SparseMatrix


@dataclasses.dataclass(frozen=True)
class EdgeDelta:
    """A batch of undirected edge edits: pair (rows[i], cols[i]) gets
    weight ``vals[i]`` (0.0 = remove).  Each pair is applied to both
    directed copies; self-loops are rejected."""

    rows: np.ndarray
    cols: np.ndarray
    vals: np.ndarray

    def __post_init__(self):
        r = np.asarray(self.rows, np.int64)
        c = np.asarray(self.cols, np.int64)
        v = np.asarray(self.vals, np.float64)
        if not (len(r) == len(c) == len(v)):
            raise ValueError("EdgeDelta arrays must have equal length")
        if (r == c).any():
            raise ValueError("EdgeDelta does not accept self-loops")
        object.__setattr__(self, "rows", r)
        object.__setattr__(self, "cols", c)
        object.__setattr__(self, "vals", v)

    @property
    def touched(self) -> np.ndarray:
        """Vertices incident to any edited pair (the dirty seed of
        ``patch_hierarchy``)."""
        return np.unique(np.concatenate([self.rows, self.cols]))


class DeltaResult(NamedTuple):
    W: SparseMatrix              # the edited graph
    touched: np.ndarray          # vertices incident to edits
    pattern_changed: bool        # False: the with_vals path was taken


def _directed_keys(rows, cols, n_cols: int) -> np.ndarray:
    return rows.astype(np.int64) * n_cols + cols.astype(np.int64)


def apply_edge_delta(W: SparseMatrix, delta: EdgeDelta,
                     drop_removed: bool = False) -> DeltaResult:
    """Apply ``delta`` to ``W``.

    If every edited pair is stored in W and ``drop_removed`` is False,
    the edit is weight-only: the new graph shares every layout of W
    through ``with_vals`` (removals become explicit zeros, and the
    pattern digest is unchanged, so the warm cache sees a pattern-tier
    hit).  Otherwise the graph is rebuilt from the merged COO
    (insertions appended, removals dropped under ``drop_removed``) with
    W's layouts.  Later edits of one directed pair win."""
    if (delta.rows >= W.n_rows).any() or (delta.cols >= W.n_cols).any() \
            or (delta.rows < 0).any() or (delta.cols < 0).any():
        raise ValueError("EdgeDelta indices out of range")
    rows, cols, vals = W.host_coo()
    rows, cols = rows.astype(np.int64), cols.astype(np.int64)
    vals = vals.copy()              # host_coo of a CPU tensor is a view
    # both directed copies of each undirected edit
    dr = np.concatenate([delta.rows, delta.cols])
    dc = np.concatenate([delta.cols, delta.rows])
    dv = np.concatenate([delta.vals, delta.vals])
    keys = _directed_keys(rows, cols, W.n_cols)        # sorted (from_coo)
    dkeys = _directed_keys(dr, dc, W.n_cols)
    pos = np.searchsorted(keys, dkeys)
    pos_c = np.minimum(pos, len(keys) - 1) if len(keys) else pos
    hit = np.zeros(len(dkeys), bool) if not len(keys) else \
        keys[pos_c] == dkeys
    touched = delta.touched
    removing = dv == 0.0

    if hit.all() and not (drop_removed and removing.any()):
        # weight-only: same pattern, every layout reused
        vals[pos_c[hit]] = dv[hit]
        return DeltaResult(
            W=W.with_vals(torch.as_tensor(vals, device=W.device)),
            touched=touched, pattern_changed=False)

    # pattern path: updates overwrite, inserts append, removals drop
    vals[pos_c[hit]] = dv[hit]
    keep = np.ones(len(keys), bool)
    if drop_removed:
        keep[pos_c[hit & removing]] = False
    ins = ~hit & ~removing
    r2 = np.concatenate([rows[keep], dr[ins]])
    c2 = np.concatenate([cols[keep], dc[ins]])
    v2 = np.concatenate([vals[keep], dv[ins]])
    W2 = SparseMatrix.from_coo(r2, c2, v2, (W.n_rows, W.n_cols),
                               **W.layout_kwargs())
    return DeltaResult(W=W2, touched=touched, pattern_changed=True)


def incremental_recluster(W_new: SparseMatrix, touched: np.ndarray,
                          pattern_changed: bool, U0, cfg, ml=None,
                          hierarchy=None
                          ) -> Tuple[object, Optional[object], list]:
    """Re-cluster the edited graph from the cached embedding ``U0``.

    Flat path (``ml`` None): the warm entry at the schedule tail through
    ``PSCConfig.init_U``.  Multilevel path: patch the cached hierarchy
    against ``W_new`` (the dirty seed is empty for a weight-only delta,
    so every aggregate is kept and only the Galerkin products rebuild;
    with no cached hierarchy one is built), then the refine-only
    V-cycle.  Returns (PSCResult, the new hierarchy or None, the patch
    records)."""
    from repro_torch.core import psc as _psc

    if ml is None:
        warm_cfg = dataclasses.replace(cfg, init_U=U0, multilevel=None)
        return _psc.p_spectral_cluster(W_new, warm_cfg), None, []

    from repro_torch.multilevel import (build_hierarchy, patch_hierarchy,
                                        refine_cluster)
    from repro_torch.multilevel.vcycle import _layout_kwargs

    records: list = []
    if hierarchy is None:
        hierarchy = build_hierarchy(
            W_new, coarse_size=ml.coarse_size, max_levels=ml.max_levels,
            min_reduction=ml.min_reduction, rounds=ml.match_rounds,
            layout_kwargs=_layout_kwargs(cfg), sparsify=ml.sparsify,
            max_agg=ml.match_max_agg)
    else:
        seed = touched if pattern_changed else np.empty(0, np.int64)
        hierarchy, records = patch_hierarchy(
            hierarchy, W_new, seed, rounds=ml.match_rounds,
            max_agg=ml.match_max_agg, layout_kwargs=_layout_kwargs(cfg),
            sparsify=ml.sparsify)
    flat_cfg = dataclasses.replace(cfg, multilevel=None)
    res = refine_cluster(W_new, flat_cfg, ml, hierarchy, U0)
    return res, hierarchy, records
