"""Input validation and degenerate-graph handling (port of
``repro.graphs.validate``).

The pipeline assumes a finite, non-negative, symmetric, connected graph;
a violation does not crash, it silently produces garbage cuts (one NaN
weight poisons the whole continuation; a disconnected graph hands kmeans
an indicator-degenerate embedding).  This module makes the contract
checkable and, where possible, repairable:

  * ``validate_graph`` — reject (``GraphValidationError`` listing every
    violation with a hint) or repair (drop non-finite / negative
    entries, symmetrize by the elementwise max) a graph; the repaired
    graph is built on W's device, in W's dtype, with W's layouts.
  * ``connected_components`` — GraphBLAS BFS: each hop is one
    ``api.mxv`` plus one ``api.vxm`` over the boolean ring on ``coo``
    (x = W |.& f).  The frontier and the visited set stay on W's device;
    each hop reads one flag back (is the frontier empty?).  Isolated
    vertices short-circuit to singleton components without a BFS each.
  * ``cluster_components`` — the disconnected-graph contract: each
    component is clustered on its own with ``allocate_k``'s proportional
    k split, labels re-assembled in the caller's vertex order, metrics
    computed on the whole graph.

Wired into the pipeline by ``PSCConfig(validate=True | ValidateConfig)``.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from repro_torch.grblas import api
from repro_torch.grblas.api import Descriptor
from repro_torch.grblas.containers import SparseMatrix
from repro_torch.grblas.semiring import boolean_ring

_COO = Descriptor(backend="coo")


class GraphValidationError(ValueError):
    """The graph violates the pipeline contract.  ``issues`` lists every
    violation found (not just the first)."""

    def __init__(self, issues):
        self.issues = list(issues)
        super().__init__("invalid graph: " + "; ".join(self.issues))


@dataclasses.dataclass(frozen=True)
class ValidateConfig:
    """``repair=False`` raises GraphValidationError; ``repair=True``
    drops non-finite/negative entries and symmetrizes by elementwise
    max.  ``sym_tol`` is the relative weight asymmetry tolerated before
    W != W^T counts as a violation."""

    repair: bool = False
    check_symmetry: bool = True
    sym_tol: float = 1e-6


def coerce_validate(v) -> ValidateConfig:
    if v is None or v is True:
        return ValidateConfig()
    if isinstance(v, ValidateConfig):
        return v
    raise TypeError(f"PSCConfig.validate must be None, True or a "
                    f"ValidateConfig, got {type(v).__name__}")


# ------------------------------------------------------------------ checking

def _find_issues(W: SparseMatrix, vcfg: ValidateConfig):
    rows, cols, vals = W.host_coo()
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    vals = np.asarray(vals, np.float64)
    issues: List[str] = []
    nonfinite = ~np.isfinite(vals)
    if nonfinite.any():
        issues.append(
            f"{int(nonfinite.sum())} non-finite edge weight(s) (NaN/Inf) — "
            f"a single NaN poisons the whole continuation; drop or re-fetch "
            f"these edges (repair=True drops them)")
    negative = np.isfinite(vals) & (vals < 0)
    if negative.any():
        issues.append(
            f"{int(negative.sum())} negative edge weight(s) — the "
            f"p-Laplacian functional needs W >= 0; negative affinities "
            f"make F_p unbounded below (repair=True drops them)")
    asym = False
    if vcfg.check_symmetry and W.n_rows == W.n_cols:
        n = max(W.n_cols, 1)
        k_fwd = rows * n + cols
        k_rev = cols * n + rows
        o_fwd = np.argsort(k_fwd, kind="stable")
        o_rev = np.argsort(k_rev, kind="stable")
        if not np.array_equal(k_fwd[o_fwd], k_rev[o_rev]):
            asym = True
            issues.append(
                "asymmetric pattern: some edge (i, j) has no stored "
                "(j, i) — the pipeline treats W as undirected; "
                "symmetrize first (repair=True uses max(W, W^T))")
        else:
            scale = float(np.abs(vals).max()) if len(vals) else 0.0
            dv = np.abs(vals[o_fwd] - vals[o_rev])
            if len(vals) and dv.max() > vcfg.sym_tol * (scale + 1e-300):
                asym = True
                issues.append(
                    f"asymmetric weights: max |W_ij - W_ji| = "
                    f"{dv.max():.3g} exceeds sym_tol * max|W| — "
                    f"symmetrize first (repair=True uses max(W, W^T))")
    return issues, (rows, cols, vals), asym


def validate_graph(W: SparseMatrix,
                   vcfg: Optional[ValidateConfig] = None) -> SparseMatrix:
    """Check (or repair) W against the pipeline contract.  Returns W
    unchanged when healthy, the repaired graph under ``repair=True``,
    and raises :class:`GraphValidationError` otherwise."""
    vcfg = coerce_validate(vcfg)
    issues, (rows, cols, vals), asym = _find_issues(W, vcfg)
    if not issues:
        return W
    if not vcfg.repair:
        raise GraphValidationError(issues)
    keep = np.isfinite(vals) & (vals >= 0)
    rows, cols, vals = rows[keep], cols[keep], vals[keep]
    if vcfg.check_symmetry and W.n_rows == W.n_cols:
        # symmetrize by elementwise max: stack both directed copies and
        # keep the larger weight per directed key (max(W, W^T) preserves
        # every surviving edge, unlike the average, which halves
        # one-sided insertions)
        r2 = np.concatenate([rows, cols])
        c2 = np.concatenate([cols, rows])
        v2 = np.concatenate([vals, vals])
        keys = r2 * max(W.n_cols, 1) + c2
        order = np.lexsort((-v2, keys))     # per key: largest val first
        keys, r2, c2, v2 = keys[order], r2[order], c2[order], v2[order]
        first = np.ones(len(keys), bool)
        first[1:] = keys[1:] != keys[:-1]
        rows, cols, vals = r2[first], c2[first], v2[first]
    return SparseMatrix.from_coo(rows, cols, vals, (W.n_rows, W.n_cols),
                                 **W.layout_kwargs())


def quick_check(W: SparseMatrix) -> Optional[str]:
    """The cheap admission-time check (serve path): one finiteness and
    one sign pass, no symmetry sort.  Returns the issue or None."""
    vals = np.asarray(W.host_coo()[2], np.float64)
    nonfinite = int((~np.isfinite(vals)).sum())
    if nonfinite:
        return (f"{nonfinite} non-finite edge weight(s) (NaN/Inf) in the "
                f"submitted graph")
    negative = int((vals < 0).sum())
    if negative:
        return f"{negative} negative edge weight(s) in the submitted graph"
    return None


# ---------------------------------------------------------------- components

@dataclasses.dataclass(frozen=True)
class Components:
    """Connected-component labeling: ``labels[v]`` is v's component id
    (0..n_components-1, discovery order), ``sizes[c]`` its vertex
    count; ``hops`` counts the BFS frontier expansions (each one
    ``mxv`` and one ``vxm``)."""

    labels: np.ndarray
    n_components: int
    sizes: np.ndarray
    hops: int = 0


def isolated_vertices(W: SparseMatrix) -> np.ndarray:
    """Vertices with no off-diagonal incident edge (self-loops don't
    connect anything)."""
    rows, cols, _ = W.host_coo()
    rows = np.asarray(rows)
    cols = np.asarray(cols)
    off = rows != cols
    has = np.zeros(W.n_rows, bool)
    has[rows[off]] = True
    has[cols[off]] = True
    return np.where(~has)[0]


def connected_components(W: SparseMatrix,
                         desc: Descriptor = _COO) -> Components:
    """Connected components by GraphBLAS BFS: each frontier expansion is
    one ``api.mxv`` (plus ``api.vxm``, in case the caller hands us an
    asymmetric pattern) over the boolean semiring — the classic
    x = W |.& f frontier product.  Host loop over components; isolated
    vertices are labeled without any BFS."""
    n = W.n_rows
    iso = isolated_vertices(W)
    labels = np.full(n, -1, np.int64)
    labels[iso] = np.arange(len(iso))
    comp = len(iso)
    hops = 0
    while True:
        unvisited = np.where(labels < 0)[0]
        if not len(unvisited):
            break
        members = torch.zeros(n, dtype=torch.bool, device=W.device)
        members[int(unvisited[0])] = True
        frontier = members.clone()
        while True:
            nxt = api.mxv(W, frontier, boolean_ring, desc=desc)
            nxt |= api.vxm(frontier, W, boolean_ring, desc=desc)
            frontier = nxt & ~members
            hops += 1
            if not bool(frontier.any()):
                break
            members |= frontier
        labels[members.cpu().numpy()] = comp
        comp += 1
    return Components(labels=labels, n_components=comp,
                      sizes=np.bincount(labels, minlength=comp), hops=hops)


def allocate_k(sizes, k: int) -> np.ndarray:
    """Split a cluster budget k across components proportionally to
    their vertex counts: every component gets at least 1 (a cluster can
    never span two components), no component more clusters than
    vertices, remaining units go to the largest proportional deficit.
    Raises ValueError when no valid allocation exists."""
    sizes = np.asarray(sizes, np.int64)
    c = len(sizes)
    n = int(sizes.sum())
    if k < c:
        raise ValueError(
            f"k={k} but the graph has {c} connected components — a "
            f"p-spectral cluster cannot span two components, so every "
            f"component needs its own cluster: raise k to >= {c}, drop "
            f"isolated vertices, or repair connectivity first")
    if k > n:
        raise ValueError(f"k={k} exceeds the number of vertices n={n}")
    alloc = np.ones(c, np.int64)
    quota = k * sizes / max(n, 1)
    for _ in range(k - c):
        deficit = quota - alloc
        deficit[alloc >= sizes] = -np.inf
        alloc[int(np.argmax(deficit))] += 1
    return alloc


def cluster_components(W: SparseMatrix, cfg,
                       comps: Optional[Components] = None):
    """Cluster a disconnected graph per component (the ``PSCConfig.
    validate`` dispatch): extract each component's induced subgraph,
    run the pipeline with its ``allocate_k`` share, and re-assemble
    labels/U in the caller's vertex order.  Metrics are computed on the
    FULL graph (cross-component cut is zero by construction).  Each
    component keeps W's device, dtype and layouts; U comes back on W's
    device."""
    import dataclasses as _dc

    from repro_torch.core import metrics as _metrics
    from repro_torch.core import psc as _psc

    if comps is None:
        comps = connected_components(W)
    rows, cols, vals = W.host_coo()
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    vals = np.asarray(vals)
    n, k = W.n_rows, cfg.k
    alloc = allocate_k(comps.sizes, k)
    labels_out = np.zeros(n, np.int64)
    U_out = torch.zeros((n, k), dtype=W.vals.dtype, device=W.device)
    summaries: List[dict] = []
    p_path: List[float] = []
    fvals: List[float] = []
    hvps: List[int] = []
    reports: List[object] = []
    offset = 0
    for c in range(comps.n_components):
        idx = np.where(comps.labels == c)[0]
        nc, kc = len(idx), int(alloc[c])
        if kc >= nc or kc == 1:
            # closed-form degenerate split within the component
            labels_out[idx] = offset + (np.arange(nc) if kc >= nc else 0)
            span = np.arange(min(kc, nc))
            tidx = torch.as_tensor(idx, device=W.device)
            U_out[tidx[span], offset + torch.as_tensor(span, device=W.device)] \
                = 1.0
            if kc == 1:
                U_out[tidx, offset] = 1.0 / np.sqrt(nc)
            summaries.append({"n": nc, "k": kc, "rcut": None})
        else:
            inv = np.full(n, -1, np.int64)
            inv[idx] = np.arange(nc)
            m = comps.labels[rows] == c
            Wc = SparseMatrix.from_coo(inv[rows[m]], inv[cols[m]], vals[m],
                                       (nc, nc), **W.layout_kwargs())
            sub_cfg = _dc.replace(cfg, k=kc, validate=None, init_U=None)
            res = _psc.p_spectral_cluster(Wc, sub_cfg)
            labels_out[idx] = np.asarray(res.labels) + offset
            U_out[torch.as_tensor(idx, device=W.device),
                  offset:offset + kc] = res.U.to(U_out.dtype)
            summaries.append({"n": nc, "k": kc, "rcut": res.rcut})
            p_path += list(res.p_path)
            fvals += list(res.fvals)
            hvps += list(res.hvp_counts)
            reports += list(res.reports or [])
        offset += kc
    rcut = float(_metrics.rcut(W, labels_out, k))
    ncut = float(_metrics.ncut(W, labels_out, k))
    return _psc.PSCResult(
        labels=labels_out, U=U_out,
        rcut=rcut, ncut=ncut, p_path=p_path, fvals=fvals,
        hvp_counts=hvps, init_labels=None, init_rcut=float("nan"),
        reports=reports, components=summaries)
