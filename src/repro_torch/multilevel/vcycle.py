"""Hierarchical p-spectral solve: coarsest-level continuation, then
prolong / re-orthonormalize / refine up the hierarchy (port of
``repro.multilevel.vcycle``).

  1. run the whole flat pipeline (p=2 eigenvectors and the full
     p-continuation) on the coarsest graph;
  2. walking back up, prolong U through the partition-of-unity
     prolongator (one ``api.mxm``), and on the levels with
     n >= ``refine_top_frac`` x n_finest re-orthonormalize it (thin QR,
     the Grassmann retraction) and re-run the last ``refine_p_steps``
     values of the p schedule with a small Newton budget;
  3. discretize and score on the finest graph, like the flat solver.

Every level is built with the layout the configured backend needs
(``_layout_kwargs``): with ``backend="edge_pallas"`` or ``"bsr_pallas"``
each coarse graph gets its BSR tiles, so the refinement on every level
runs the BSR kernels.  The coarsest solve and the refinements each take
any registered driver (``MultilevelConfig.coarse_solver`` /
``refine_solver``; None keeps the config's own).  Under tracing, the
coarse solve is a ``multilevel.coarse_solve`` span, each level of the
walk up a ``multilevel.refine`` span and the finest discretization a
``kmeans`` span.  Entry point: ``PSCConfig(multilevel=...)``, routed by
``core.psc.p_spectral_cluster``.  ``refine_cluster`` is the serve
layer's refine-only cycle: restrict a cached embedding down a (patched)
hierarchy, warm-enter the coarse driver at the schedule tail and walk
back up.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.grblas import api
from repro_torch.grblas.api import Descriptor
from repro_torch.grblas.containers import SparseMatrix
from repro_torch.multilevel.coarsen import build_hierarchy
from repro_torch.obs import trace as _obs_trace

_T = Descriptor(transpose=True)


@dataclasses.dataclass(frozen=True)
class MultilevelConfig:
    """V-cycle shape: hierarchy caps + per-level refinement budget."""

    coarse_size: int = 2048         # stop coarsening at this many vertices
    max_levels: int = 12            # hierarchy depth cap (incl. finest)
    min_reduction: float = 0.9      # stop when a step keeps more than
                                    # this fraction of the vertices
    match_rounds: int = 8           # handshake-HEM rounds per level
    match_max_agg: int = 4          # leaf-joining aggregate size cap
    refine_newton_iters: int = 5    # RTR iterations per refined level
    refine_tcg_iters: int = 8       # inner tCG budget during refinement
    refine_p_steps: int = 2         # tail of the p schedule re-run per
                                    # refined level
    coarse_solver: Optional[str] = None   # driver of the coarsest solve
                                          # (None = the config's own)
    refine_solver: Optional[str] = None   # driver of the refinements
    refine_top_frac: float = 0.25   # refine only levels with
                                    # n >= frac x n_finest
    sparsify: Any = "auto"          # coarse-level degree cap ("auto" |
                                    # None | int), coarsen._sparsify_rowcap


def coerce(value) -> MultilevelConfig:
    """A MultilevelConfig from ``PSCConfig.multilevel`` (True means the
    defaults).  A level driver that is not registered raises
    SolverUnavailableError."""
    from repro_torch.core.solvers import resolve_solver

    ml = value if isinstance(value, MultilevelConfig) else MultilevelConfig()
    for name in ("coarse_solver", "refine_solver"):
        if getattr(ml, name) is not None:
            resolve_solver(getattr(ml, name))
    return ml


def _layout_kwargs(cfg) -> Optional[dict]:
    """Coarse graphs carry whatever layout the named backend needs;
    "auto" relies on the from_coo auto policy."""
    if cfg.backend == "sellcs":
        return {"build_sellcs": True}
    if cfg.backend in ("bsr_pallas", "edge_pallas"):
        return {"build_bsr": True}
    if cfg.backend == "ell":
        return {"build_ell": True}
    return None


def _refine_cfg(cfg, ml: MultilevelConfig):
    return dataclasses.replace(
        cfg, multilevel=None, newton_iters=ml.refine_newton_iters,
        tcg_iters=ml.refine_tcg_iters, reorder="none",
        solver=ml.refine_solver or cfg.solver)


def _walk_up(hier, U, cfg, ml: MultilevelConfig, rec: dict):
    """From the coarsest-level iterate ``U``, prolong through every level
    and, on levels with n >= refine_top_frac x n_finest, retract and
    re-run the tail of the p schedule.  ``rec`` collects p_path / fvals /
    hvps / reports / levels in place; returns the finest orthonormal U."""
    from repro_torch.core import solvers

    tail = solvers.p_schedule(cfg)[-max(int(ml.refine_p_steps), 1):]
    refine_cfg = _refine_cfg(cfg, ml)
    n_fine = hier.levels[0].W.n_rows
    for lev in range(hier.n_levels - 2, -1, -1):
        Wl = hier.levels[lev].W
        refined = Wl.n_rows >= ml.refine_top_frac * n_fine
        with _obs_trace.ACTIVE.span("multilevel.refine", cat="multilevel",
                                    level=lev, n=Wl.n_rows, nnz=Wl.nnz,
                                    refined=refined,
                                    solver=refine_cfg.solver) as sp:
            U = api.mxm(hier.prolongators[lev], U)    # prolong: (n_lev, k)
            if not refined:
                continue
            refine_cfg.validate_backend(Wl)
            U = torch.linalg.qr(U)[0]                 # Grassmann retraction
            for p in tail:
                res = solvers.minimize_at_p(Wl, U, p, refine_cfg)
                U = res.U
                rec["p_path"].append(p)
                rec["fvals"].append(float(res.fval))
                rec["hvps"].append(int(res.n_apply))
                rec["reports"].append(res)
                rec["levels"].append({
                    "level": lev, "n_levels": hier.n_levels, "n": Wl.n_rows,
                    "nnz": Wl.nnz, "p": p, "fval": float(res.fval),
                    "n_hvp": int(res.n_apply), "iters": int(res.iters),
                    "solver": refine_cfg.solver})
            sp.fence(U)
    return torch.linalg.qr(U)[0]


def _finalize(W: SparseMatrix, U, cfg, rec: dict, init_labels, init_rcut,
              seconds: dict, hierarchy: list):
    """Finest-level discretization and metrics: the flat solver's stage 3
    with its final-kmeans generator."""
    from repro_torch.core import metrics
    from repro_torch.core import psc as _psc

    t0 = time.perf_counter()
    _, g_final = _psc.stage_generators(cfg.seed, W.device)
    with _obs_trace.ACTIVE.span("kmeans", cat="psc", n=W.n_rows,
                                k=cfg.k) as sp:
        labels = _psc.discretize(U, cfg.k, g_final,
                                 restarts=cfg.kmeans_restarts,
                                 iters=cfg.kmeans_iters)
        sp.fence(labels)
        rcut = float(metrics.rcut(W, labels, cfg.k))
        ncut = float(metrics.ncut(W, labels, cfg.k))
    seconds["kmeans"] = time.perf_counter() - t0
    return _psc.PSCResult(
        labels=labels.cpu().numpy(), U=U, rcut=rcut, ncut=ncut,
        p_path=rec["p_path"], fvals=rec["fvals"], hvp_counts=rec["hvps"],
        init_labels=init_labels, init_rcut=init_rcut, levels=rec["levels"],
        reports=rec["reports"], stage_seconds=seconds, hierarchy=hierarchy)


def _hierarchy_records(hier) -> list:
    return [{"level": i, "n": lv.W.n_rows, "nnz": lv.W.nnz,
             "bsr_tiles": (None if lv.W.bsr_blocks is None
                           else int(lv.W.bsr_blocks.shape[0]))}
            for i, lv in enumerate(hier.levels)]


def multilevel_cluster(W: SparseMatrix, cfg, ml) -> Any:
    """Run the V-cycle under the flat config ``cfg`` (a PSCConfig whose
    ``multilevel`` field routed here; ``ml`` is that field).  Returns a PSCResult on W, with
    the per-level refinement records in ``levels``, the shape of the
    hierarchy in ``hierarchy`` and host seconds per stage ("hierarchy",
    "coarse_solve", "walk_up", "kmeans") in ``stage_seconds``."""
    from repro_torch.core import metrics
    from repro_torch.core import psc as _psc

    ml = coerce(ml)
    seconds = {}
    t0 = time.perf_counter()
    hier = build_hierarchy(W, coarse_size=ml.coarse_size,
                           max_levels=ml.max_levels,
                           min_reduction=ml.min_reduction,
                           rounds=ml.match_rounds,
                           layout_kwargs=_layout_kwargs(cfg),
                           sparsify=ml.sparsify, max_agg=ml.match_max_agg)
    seconds["hierarchy"] = time.perf_counter() - t0
    if hier.n_levels == 1:          # nothing to coarsen: flat solve
        return _psc.p_spectral_cluster(
            W, dataclasses.replace(cfg, multilevel=None))
    hierarchy = _hierarchy_records(hier)

    # -- coarsest level: the whole flat pipeline; its labels, prolonged,
    # are the fine graph's init_labels
    t0 = time.perf_counter()
    flat_cfg = dataclasses.replace(cfg, multilevel=None,
                                   solver=ml.coarse_solver or cfg.solver)
    with _obs_trace.ACTIVE.span("multilevel.coarse_solve", cat="multilevel",
                                n=hier.coarsest.W.n_rows,
                                nnz=hier.coarsest.W.nnz,
                                solver=flat_cfg.solver):
        res_c = _psc.p_spectral_cluster(hier.coarsest.W, flat_cfg)
    rec = {"p_path": list(res_c.p_path), "fvals": list(res_c.fvals),
           "hvps": list(res_c.hvp_counts),
           "reports": list(res_c.reports or []), "levels": []}
    seconds["coarse_solve"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    U = _walk_up(hier, res_c.U, cfg, ml, rec)
    init_labels = hier.prolong_labels(np.asarray(res_c.labels))
    init_rcut = float(metrics.rcut(W, init_labels, cfg.k))
    seconds["walk_up"] = time.perf_counter() - t0
    return _finalize(W, U, cfg, rec, init_labels, init_rcut, seconds,
                     hierarchy)


def refine_cluster(W: SparseMatrix, cfg, ml: MultilevelConfig, hier,
                   U0) -> Any:
    """Refine-only V-cycle: re-cluster ``W`` from an earlier solve's
    finest embedding ``U0`` (n, k) instead of the coarsest-level flat
    pipeline — the serve engine's churn path.

    The cached U is restricted to the coarsest level (Pᵀ U, the
    aggregate sums: one ``api.mxm`` a level), re-orthonormalized, and
    enters the coarse driver at the end of the p schedule
    (``solvers.warm_start``, ``refine_p_steps`` levels); the walk back up
    is the V-cycle's own.  No LOBPCG and no descent from p = 2.  ``hier``
    must be a hierarchy of ``W`` itself (patched or freshly built).
    Returns a PSCResult with ``init_labels=None`` and ``init_rcut`` NaN;
    ``stage_seconds`` has "restrict", "coarse_solve", "walk_up" and
    "kmeans"."""
    from repro_torch.core import solvers

    ml = coerce(ml)
    U = U0 if torch.is_tensor(U0) else torch.as_tensor(np.asarray(U0))
    U = U.to(device=W.device, dtype=W.dtype)
    if tuple(U.shape) != (W.n_rows, cfg.k):
        raise ValueError(f"refine_cluster: U0 shape {tuple(U.shape)} != "
                         f"({W.n_rows}, {cfg.k})")
    if hier.levels[0].W.n_rows != W.n_rows:
        raise ValueError("refine_cluster: hierarchy does not match W")
    rec = {"p_path": [], "fvals": [], "hvps": [], "reports": [],
           "levels": []}
    seconds = {}

    # -- restrict: Pᵀ U per level, then the Grassmann retraction
    t0 = time.perf_counter()
    with _obs_trace.ACTIVE.span("multilevel.restrict", cat="multilevel",
                                n_levels=hier.n_levels) as sp:
        for P in hier.prolongators:
            U = api.mxm(P, U.contiguous(), desc=_T)
        U = torch.linalg.qr(U)[0]
        sp.fence(U)
    seconds["restrict"] = time.perf_counter() - t0

    # -- coarsest level: warm entry at the end of the p schedule
    t0 = time.perf_counter()
    coarse_cfg = dataclasses.replace(
        cfg, multilevel=None, reorder="none", init_U=None,
        solver=ml.coarse_solver or cfg.solver)
    coarse_cfg.validate_backend(hier.coarsest.W)
    with _obs_trace.ACTIVE.span("multilevel.coarse_solve", cat="multilevel",
                                n=hier.coarsest.W.n_rows,
                                nnz=hier.coarsest.W.nnz, warm=True,
                                solver=coarse_cfg.solver):
        U, p_path, fvals, hvps, reports = solvers.warm_start(
            hier.coarsest.W, U, coarse_cfg,
            steps=max(int(ml.refine_p_steps), 1))
    rec["p_path"] += p_path
    rec["fvals"] += fvals
    rec["hvps"] += hvps
    rec["reports"] += reports
    seconds["coarse_solve"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    U = _walk_up(hier, U, cfg, ml, rec)
    seconds["walk_up"] = time.perf_counter() - t0
    return _finalize(W, U, cfg, rec, None, float("nan"), seconds,
                     _hierarchy_records(hier))
