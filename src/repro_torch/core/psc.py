"""GrB-pGrass: the end-to-end p-spectral clustering pipeline.

Port of ``repro.core.psc``:

  1. p=2 start: smallest-k eigenvectors of the graph Laplacian (LOBPCG,
     dense eigh for n <= 1024).
  2. p-continuation: for p_t = max(p_target, 2.0 * 0.9^t), minimize
     F_{p_t}(U) over Gr(k,n) with the driver ``PSCConfig.solver`` names
     ("newton", the paper's; "scf"; "inverse_power", which reaches p = 1;
     "guarded"), warm-started from the previous level.
  3. Discretize the k nonlinear eigenvectors with kmeans++.

Everything runs on the graph's device.  Randomness follows a seeded
``torch.Generator`` discipline in place of the reference's
``stage_keys``: the eigensolver's start block is drawn from a generator
seeded with ``cfg.seed``, and the two kmeans stages from generators
seeded with two words that ``numpy.random.SeedSequence(cfg.seed)``
derives.  The streams differ from ``jax.random``'s, so the port matches
the reference in quality (accuracy, RCut), not label for label.

Two routes around the flat path, as in the reference:
``multilevel`` (a ``MultilevelConfig``, or True for the defaults) runs
the V-cycle of ``repro_torch.multilevel``; ``reorder`` ("rcm" |
"degree") relabels the graph first (``graphs.reorder``) and un-permutes
labels, init_labels and U before the result is returned.

Three wrappers, as in the reference: ``guard`` (True or a
``solvers.GuardConfig``; or ``solver="guarded"``) runs the continuation
under per-level health checks and the recovery ladder and puts the
``RecoveryReport`` in ``PSCResult.recovery``; ``validate`` (True or a
``graphs.validate.ValidateConfig``) checks (or repairs) the graph first
and clusters a disconnected graph component by component
(``PSCResult.components``); ``trace`` (True, an ``obs.TraceConfig`` or an
``obs.Tracer``) runs the solve under a span session rooted at "psc" and
puts an ``obs.Telemetry`` in ``PSCResult.telemetry``.

``init_U`` (an (n, k) embedding from an earlier solve: the warm start
the serve layer feeds) skips stage 1 and the descent from p = 2: it is
permuted under ``reorder``, orthonormalized by QR and enters the driver
at the last ``warm_p_steps`` values of the p schedule
(``solvers.warm_start``, or ``resilient_warm_start`` under ``guard``);
``init_labels`` is then None and ``init_rcut`` NaN.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core import kmeans as km
from repro_torch.core import lobpcg, metrics, solvers
from repro_torch.grblas import api as grb_api
from repro_torch.grblas.api import Descriptor
from repro_torch.grblas.containers import SparseMatrix
from repro_torch.obs import trace as _obs_trace

@dataclasses.dataclass
class PSCConfig:
    k: int = 4                      # number of clusters / eigenvectors
    p_target: float = 1.2           # final p
    p_factor: float = 0.9           # continuation ratio
    eps: float = 1e-8               # phi_p smoothing
    newton_iters: int = 30          # outer RTR iterations per p level
    tcg_iters: int = 20             # inner truncated-CG iterations
    grad_tol: float = 1e-5
    kmeans_restarts: int = 8
    kmeans_iters: int = 50
    hvp_mode: str = "graphblas"     # "graphblas" (Alg.1) | "matrix_free"
    normalized_init: bool = False
    seed: int = 0
    # the per-p driver (core.solvers registry): "newton" | "scf" |
    # "inverse_power" | "guarded"; an unknown name or a schedule outside
    # the driver's p range raises here
    solver: str = "newton"
    # scf: max reweight/eigensolve sweeps per level and the subspace-drift
    # stopping tolerance
    scf_sweeps: int = 12
    scf_tol: float = 1e-5
    # inverse_power: projected-gradient steps per column, first step size
    ipm_iters: int = 200
    ipm_lr0: float = 0.5
    # grblas backend of the hot loop (grblas/backends.py).  The loop
    # issues p-Laplacian edge-ring SpMMs, which "coo", "sellcs" (with the
    # SELL-C-σ layout built) and "edge_pallas" (with the BSR layout
    # built) serve; "auto" takes the first capable backend in the order
    # sellcs, ell, bsr_pallas, edge_pallas, coo.  Stage 1's reals SpMM
    # takes the named backend only where it serves the reals ring, else
    # auto.  A backend that cannot execute raises
    # BackendUnavailableError before any work is done.
    backend: str = "auto"
    # vertex relabeling before stage 1: "none" | "rcm" | "degree"
    reorder: str = "none"
    # None/False = flat solve; True or a MultilevelConfig = V-cycle
    multilevel: object = None
    # warm start: an (n, k) embedding of an earlier solve; the solve
    # skips stage 1 and runs only the last ``warm_p_steps`` levels
    init_U: object = None
    warm_p_steps: int = 1
    # None (off) | True | solvers.GuardConfig: health checks + recovery
    guard: object = None
    # None (off) | True (strict) | graphs.validate.ValidateConfig
    validate: object = None
    # None/False (off) | True | obs.TraceConfig | obs.Tracer
    trace: object = None

    def __post_init__(self):
        if self.trace is not None \
                and not isinstance(self.trace, _obs_trace.Tracer):
            _obs_trace.coerce(self.trace)   # raises on bad values now
        if self.multilevel:
            from repro_torch.multilevel import vcycle

            vcycle.coerce(self.multilevel)
        if self.hvp_mode not in ("graphblas", "matrix_free"):
            raise ValueError(f"hvp_mode={self.hvp_mode!r}: expected "
                             "'graphblas' or 'matrix_free'")
        solvers.validate_config(self)
        if self.k < 1:
            raise ValueError(f"k={self.k} must be >= 1")
        if self.guard or self.solver == "guarded":
            solvers.guard.validate_guard(self)
        if self.validate:
            from repro_torch.graphs import validate as _validate

            _validate.coerce_validate(self.validate)

    def descriptor(self) -> Descriptor:
        return Descriptor(backend=self.backend)

    def validate_backend(self, W: SparseMatrix) -> None:
        """Shape-only capability probe: fail before any work is done."""
        desc = self.descriptor()
        if desc.backend == "auto":
            return
        from repro_torch.grblas import backends as _backends
        from repro_torch.grblas.semiring import (plap_edge_semiring,
                                                 plap_hvp_edge_semiring)

        probe = torch.empty((W.n_rows, self.k), dtype=W.vals.dtype,
                            device="meta")
        _backends.select_backend(W, probe,
                                 plap_edge_semiring(2.0, self.eps), desc)
        if self.hvp_mode == "matrix_free":
            _backends.select_backend(W, (probe, probe),
                                     plap_hvp_edge_semiring(2.0, self.eps),
                                     desc)


@dataclasses.dataclass
class PSCResult:
    labels: np.ndarray
    U: torch.Tensor                 # final p-eigenvectors (n,k)
    rcut: float
    ncut: float
    p_path: list
    fvals: list                     # F_p at the end of each p level
    hvp_counts: list                # Hessian applies per level
    init_labels: Optional[np.ndarray] = None  # p=2 (Spec) labels
    init_rcut: float = float("nan")
    reports: Optional[list] = None  # SolverReport per level
    # host wall seconds per stage: "init" (eigensolve + Spec kmeans),
    # "continuation", "kmeans" (discretize + metrics); each stage ends
    # in a value read back from the device.  Multilevel runs: "hierarchy",
    # "coarse_solve", "walk_up", "kmeans".
    stage_seconds: Optional[dict] = None
    # multilevel runs only: per-level refinement records (level, n, nnz,
    # p, fval, n_hvp, iters), and the hierarchy (level, n, nnz, bsr_tiles)
    levels: Optional[list] = None
    hierarchy: Optional[list] = None
    # guarded runs: the solvers.RecoveryReport (what diverged, which rung
    # brought the solve home)
    recovery: Optional[object] = None
    # per-component runs (validate on a disconnected graph): one
    # {"n", "k", "rcut"} per connected component, in component order
    components: Optional[list] = None
    # traced runs: the obs.Telemetry of this solve (None when tracing is
    # off or an outer session owns the timeline)
    telemetry: Optional[object] = None


def stage_generators(seed: int, device) -> Tuple[torch.Generator,
                                                 torch.Generator]:
    """(init kmeans generator, final kmeans generator) for ``seed``."""
    s_init, s_final = np.random.SeedSequence(seed).generate_state(2)
    dev = torch.device(device)
    return (torch.Generator(device=dev).manual_seed(int(s_init)),
            torch.Generator(device=dev).manual_seed(int(s_final)))


def discretize(U: torch.Tensor, k: int, gen: torch.Generator,
               restarts: int = 8, iters: int = 50) -> torch.Tensor:
    """Stage 3: row-normalize (scale-invariant coordinates) and kmeans++
    the nonlinear eigenvectors."""
    Xn = U / torch.clamp(torch.linalg.norm(U, dim=1, keepdim=True), min=1e-12)
    labels, _ = km.kmeans(gen, Xn, k, restarts=restarts, iters=iters)
    return labels


def _trivial_result(W: SparseMatrix, cfg: PSCConfig) -> PSCResult:
    """k=1: the all-ones cluster; k=n: every vertex its own cluster."""
    n, k = W.n_rows, cfg.k
    if k == 1:
        labels = np.zeros(n, np.int64)
        U = torch.full((n, 1), 1.0 / np.sqrt(max(n, 1)), dtype=W.vals.dtype,
                       device=W.device)
    else:
        labels = np.arange(n, dtype=np.int64)
        U = torch.eye(n, dtype=W.vals.dtype, device=W.device)
    rcut = float(metrics.rcut(W, labels, k))
    ncut = float(metrics.ncut(W, labels, k))
    return PSCResult(labels=labels, U=U, rcut=rcut, ncut=ncut, p_path=[],
                     fvals=[], hvp_counts=[], init_labels=labels.copy(),
                     init_rcut=rcut, reports=[])


def p_spectral_cluster(W: SparseMatrix, cfg: PSCConfig) -> PSCResult:
    """Run the GrB-pGrass pipeline on graph W, on W's device.

    With ``cfg.trace`` set (and no outer tracer active) the solve runs
    under a span session rooted at "psc" and the result carries
    ``telemetry``; the coarse-level call of a multilevel solve reuses the
    outer session, so one timeline covers the whole V-cycle."""
    with _obs_trace.session(cfg.trace) as owner:
        with _obs_trace.ACTIVE.span("psc", cat="psc", n=W.n_rows,
                                    nnz=W.nnz, k=cfg.k, solver=cfg.solver,
                                    backend=cfg.backend,
                                    multilevel=bool(cfg.multilevel)):
            res = _cluster_impl(W, cfg)
        if owner is not None:
            res.telemetry = _obs_trace.Telemetry.from_tracer(owner)
    return res


def _cluster_impl(W: SparseMatrix, cfg: PSCConfig) -> PSCResult:
    n = W.n_rows
    if n == 0:
        raise ValueError("cannot cluster an empty graph (n_rows == 0)")
    if cfg.k > n:
        raise ValueError(f"k={cfg.k} exceeds the number of vertices n={n}")
    if cfg.validate:
        from repro_torch.graphs import validate as _validate

        W = _validate.validate_graph(W, _validate.coerce_validate(
            cfg.validate))
        if 1 < cfg.k < n:
            comps = _validate.connected_components(W)
            if comps.n_components > 1:
                return _validate.cluster_components(W, cfg, comps)
    if cfg.k == 1 or cfg.k == n:
        return _trivial_result(W, cfg)
    if cfg.multilevel:
        from repro_torch.multilevel import vcycle

        return vcycle.multilevel_cluster(W, cfg, cfg.multilevel)
    inv = perm = None
    if cfg.reorder != "none":
        from repro_torch.graphs.reorder import reorder

        W, perm, inv = reorder(W, method=cfg.reorder)
    cfg.validate_backend(W)
    g_init, g_final = stage_generators(cfg.seed, W.device)
    seconds = {}
    recovery = None
    guarded = cfg.guard or cfg.solver == "guarded"
    span = _obs_trace.ACTIVE.span

    if cfg.init_U is not None:
        # -- warm start: an earlier embedding is a feasible Grassmann
        # point; skip stage 1 and the descent, enter at the schedule tail
        U = cfg.init_U
        U = (U if torch.is_tensor(U) else torch.as_tensor(np.asarray(U))
             ).to(device=W.device, dtype=W.vals.dtype)
        if tuple(U.shape) != (W.n_rows, cfg.k):
            raise ValueError(f"init_U shape {tuple(U.shape)} != "
                             f"({W.n_rows}, {cfg.k})")
        if perm is not None:
            U = U[torch.as_tensor(perm, device=W.device)]
        U = torch.linalg.qr(U)[0].contiguous()
        init_labels, init_rcut = None, float("nan")
        t0 = time.perf_counter()
        with span("continuation", cat="psc", warm=True,
                  solver=cfg.solver) as sp:
            if guarded:
                U, p_path, fvals, hvps, reports, recovery = \
                    solvers.resilient_warm_start(W, U, cfg)
            else:
                U, p_path, fvals, hvps, reports = solvers.warm_start(
                    W, U, cfg, steps=cfg.warm_p_steps)
            sp.fence(U)
            sp.set(levels=len(p_path))
        seconds["continuation"] = time.perf_counter() - t0
    else:
        # -- stage 1: linear (p=2) spectral start; the reals-ring matvec
        # gets the configured descriptor only where that backend can
        # serve it
        t0 = time.perf_counter()
        with span("init", cat="psc", n=W.n_rows, k=cfg.k) as sp:
            stage1_desc = grb_api.capable_desc(W, desc=cfg.descriptor(),
                                               k=cfg.k, dtype=W.vals.dtype)
            _, U = lobpcg.smallest_eigvecs(W, cfg.k,
                                           normalized=cfg.normalized_init,
                                           seed=cfg.seed, desc=stage1_desc)
            U = torch.linalg.qr(U)[0].contiguous()
            init_labels, _ = km.kmeans(g_init, U, cfg.k,
                                       restarts=cfg.kmeans_restarts,
                                       iters=cfg.kmeans_iters)
            init_rcut = float(metrics.rcut(W, init_labels, cfg.k))
            sp.set(init_rcut=init_rcut)
        seconds["init"] = time.perf_counter() - t0

        # -- stage 2: p-continuation under the registered driver (the
        # guarded path adds per-level health checks and the recovery
        # ladder)
        t0 = time.perf_counter()
        with span("continuation", cat="psc", solver=cfg.solver) as sp:
            if guarded:
                U, p_path, fvals, hvps, reports, recovery = \
                    solvers.resilient_continuation(W, U, cfg)
            else:
                U, p_path, fvals, hvps, reports = solvers.p_continuation(
                    W, U, cfg)
            sp.fence(U)
            sp.set(levels=len(p_path))
        seconds["continuation"] = time.perf_counter() - t0

    # -- stage 3: kmeans discretization and the cut metrics
    t0 = time.perf_counter()
    with span("kmeans", cat="psc", n=W.n_rows, k=cfg.k) as sp:
        labels = discretize(U, cfg.k, g_final, restarts=cfg.kmeans_restarts,
                            iters=cfg.kmeans_iters)
        sp.fence(labels)
        rcut = float(metrics.rcut(W, labels, cfg.k))  # relabeling-invariant
        ncut = float(metrics.ncut(W, labels, cfg.k))
        sp.set(rcut=rcut)
    seconds["kmeans"] = time.perf_counter() - t0

    labels = labels.cpu().numpy()
    if init_labels is not None:
        init_labels = init_labels.cpu().numpy()
    if inv is not None:             # back to the caller's vertex ids
        labels = labels[inv]
        if init_labels is not None:
            init_labels = init_labels[inv]
        U = U[torch.as_tensor(inv, device=U.device)]
    return PSCResult(labels=labels, U=U, rcut=rcut, ncut=ncut,
                     p_path=p_path, fvals=fvals, hvp_counts=hvps,
                     init_labels=init_labels, init_rcut=init_rcut,
                     reports=reports, stage_seconds=seconds,
                     recovery=recovery)


def spectral_cluster(W: SparseMatrix, k: int, seed: int = 0,
                     normalized: bool = False) -> Tuple[np.ndarray, float]:
    """Baseline `Spec`: classical p=2 spectral clustering."""
    _, U = lobpcg.smallest_eigvecs(W, k, normalized=normalized, seed=seed)
    gen = torch.Generator(device=W.device).manual_seed(seed)
    labels, _ = km.kmeans(gen, U, k)
    return labels.cpu().numpy(), float(metrics.rcut(W, labels, k))
