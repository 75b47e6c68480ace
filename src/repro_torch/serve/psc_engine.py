"""Clustering as a service: the batched, warm-started PSC serve engine
(port of ``repro.serve.psc_engine``).

``serve/engine.py`` serves an LM by reusing one decode step for every
token of every request.  This module is the clustering counterpart for a
stream of graph requests:

  * **shape-bucketed batching** — requests pad onto a power-of-two
    (n, nnz, k) bucket lattice (``serve.bucketing``) and the whole
    Newton / SCF p-continuation runs on a batch of a bucket at once
    (``grassmann.rtr_minimize_batched``, the reference's ``jax.vmap``).
  * **warm-start cache** — an LRU on graph fingerprints
    (``serve.warm_cache``).  A hit skips the p=2 eigensolve and the
    descent: the cached embedding re-enters the registry at the end of
    the p schedule (``solvers.warm_start``).
  * **incremental re-clustering** — ``update()`` takes an
    :class:`~repro_torch.serve.churn.EdgeDelta` against a served graph:
    weight-only deltas ride ``with_vals`` and a warm solve; pattern
    deltas on the multilevel lane patch the cached hierarchy and run a
    refine-only V-cycle (``serve.churn``).
  * **admission and metrics** — a queue with per-bucket batches under a
    max-wait deadline, per-request :class:`ServeStats` and engine
    counters, all views over one ``obs.metrics.MetricsRegistry``.

Graphs above ``max_bucket_n`` vertices take the *solo* lane: the flat
(or multilevel) pipeline per request, with the same cache and churn
machinery.

**One build per bucket.**  PyTorch runs eagerly, so nothing is traced
or compiled; the port's contract is one *build* per (bucket key, solver
signature), memoized by ``registry.memoized`` and counted by
``registry.mark_trace`` (``obs.retrace.RetraceDetector.serve_buckets``
reads it as the reference's does).  A build fixes every shape of the
batched solve: the batch padded to ``max_batch`` (a partial batch
replicates its last request), n_b, nnz_b and k, the block-diagonal
index offsets b·n_b and the element index of every entry, and the p
schedule (Python floats: p reaches every op as a runtime argument, as
on the flat path).  No later batch of the bucket builds or allocates a
new plan; a batch of another size or on another device builds once
more under the same key, which the detector reports as a rebuild.

A batch runs as ONE block-diagonal COO ``SparseMatrix`` over B·n_b
vertices, element b's indices offset by b·n_b and its entries at
[b·nnz_b, (b+1)·nnz_b), under ``Descriptor(backend="coo")``: its SpMMs
are the fixed-order ``segment_sum`` on the card.  The rows are sorted
stably once a batch, which only moves each element's pad entries
(0, 0, 0.0) to just after its row 0's real entries, so every row sum
adds the same terms.  The dense scatters (the p=2 Laplacian, the SCF
sweep's reweighted one) collide only on pads, which add +0.0.

Determinism: stage 3 draws from a fresh ``psc.stage_generators(cfg.seed)``
per request, as the flat pipeline does, and RCut/NCut are taken on the
caller's own graph, so a padded, batched request returns the labels of
``p_spectral_cluster`` on the bare graph.

Failures: the engine turns a failed solve into a per-request structured
error (quarantine), except ``KeyboardInterrupt``, ``SystemExit`` and a
device fault — ``kernels.nvcc.KernelError`` (a kernel that failed to
build or launch) or ``torch.AcceleratorError`` — which reach the caller.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import metrics, plap
from repro_torch.core import psc as _psc
from repro_torch.core.grassmann import rtr_minimize_batched
from repro_torch.core.psc import PSCConfig
from repro_torch.core.solvers import registry
from repro_torch.core.solvers.guard import SolverDivergence
from repro_torch.grblas.api import Descriptor
from repro_torch.grblas.backends import BackendUnavailableError
from repro_torch.grblas.containers import GraphFingerprint, SparseMatrix
from repro_torch.kernels.nvcc import KernelError
from repro_torch.kernels.segment_sum import csr_pointers
from repro_torch.obs import metrics as _obs_metrics
from repro_torch.obs import trace as _obs_trace
from repro_torch.serve.bucketing import (BucketBatch, BucketSpec,
                                         assemble_batch, bucket_for,
                                         pad_embeddings)
from repro_torch.serve.churn import (EdgeDelta, apply_edge_delta,
                                     incremental_recluster)
from repro_torch.serve.warm_cache import CacheEntry, WarmCache

# Spectral shift of the pad vertices' diagonals in the batched dense
# eigensolves: it lifts their null space far above every graph
# eigenvalue, so the smallest-k selection sees only the real spectrum.
_PAD_SHIFT = 1.0e6

_COO = Descriptor(backend="coo")

# Exceptions never quarantined: they reach the engine's caller.
_PASS_THROUGH = (KeyboardInterrupt, SystemExit, KernelError) + (
    (torch.AcceleratorError,) if hasattr(torch, "AcceleratorError") else ())

# Fault-injection seams (``repro_torch.testing.faultinject``): when set,
# called right before a bucket batch solve / a churn re-solve.  Raising
# from them drives the quarantine-bisect and retry paths.
_SOLVE_FAULT = None     # fn(pends: List[_Pending]) -> None
_CHURN_FAULT = None     # fn(pend: _Pending, attempt: int) -> None


# --------------------------------------------------------------- stats types

@dataclasses.dataclass
class ServeStats:
    """Per-request accounting, returned with every result."""

    req_id: int
    n: int
    nnz: int
    k: int
    lane: str                    # "bucket" | "solo" | "admission"
    mode: str                    # "cold" | "warm" | "churn"
    cache_tier: Optional[str]    # None | "exact" | "pattern"
    bucket: Optional[tuple]      # BucketSpec key (bucket lane only)
    batch_size: int
    queue_s: float
    solve_s: float
    trace_new: bool              # this request's batch made a new build
    p_final: float
    degrade: int = 0             # 0 none | 1 schedule-tail-only | 2 p=2-init
    retries: int = 0             # churn retries before success
    failure_kind: Optional[str] = None   # taxonomy key (failed requests)
    error: Optional[str] = None          # failure detail


@dataclasses.dataclass
class ServeResult:
    req_id: int
    labels: Optional[np.ndarray]
    U: Optional[torch.Tensor]    # (n, k) on the graph's device
    rcut: float
    ncut: float
    stats: ServeStats
    # a failed request carries its structured error here (labels and U
    # None, rcut and ncut NaN)
    error: Optional[str] = None

    @property
    def ok(self) -> bool:
        return self.error is None


@dataclasses.dataclass
class _Pending:
    req_id: int
    W: SparseMatrix
    k: int
    fp: Optional[GraphFingerprint]
    spec: Optional[BucketSpec]
    mode: str                       # "cold" | "warm"
    cache_tier: Optional[str]
    warm_U: object
    arrival: float
    churn: bool = False
    touched: Optional[np.ndarray] = None
    pattern_changed: bool = False
    hierarchy: object = None
    degrade: int = 0                # deadline degradation level (0/1/2)


# ------------------------------------------------------ batched solver build

class _BucketGraph(NamedTuple):
    """One batch of a bucket on the device: the block-diagonal COO
    matrix, the pad mask and each entry's (element, local row, local
    column) for the dense scatters."""

    W: SparseMatrix                 # B·n_b vertices, B·nnz_b entries
    mask: torch.Tensor              # (B, n_b) 1.0 on real vertices
    b_idx: torch.Tensor             # (B·nnz_b,) element of each entry
    lrows: torch.Tensor             # (B·nnz_b,) row within its element
    lcols: torch.Tensor


def _dense(G: _BucketGraph, vals: torch.Tensor) -> torch.Tensor:
    """(B, n_b, n_b) dense matrices of the batch with entry values
    ``vals``; only pad entries collide, adding +0.0."""
    nb, n = G.mask.shape
    d = torch.zeros((nb, n, n), dtype=vals.dtype, device=vals.device)
    return d.index_put_((G.b_idx, G.lrows, G.lcols), vals, accumulate=True)


def _dense_smallest(L: torch.Tensor, mask: torch.Tensor, k: int):
    """Smallest-k eigenvectors of padded dense operators (B, n_b, n_b):
    pad diagonals get ``_PAD_SHIFT`` so the isolated vertices' null space
    sorts above every real eigenvalue; pad rows of the result are zeroed
    again (eigh leaves rounding dust there)."""
    L = L + torch.diag_embed((1.0 - mask) * _PAD_SHIFT)
    _, evecs = torch.linalg.eigh(L)
    return evecs[..., :k] * mask[..., None]


def _batched_init(G: _BucketGraph, k: int, cfg):
    """Stage 1 of the flat pipeline on a batch: the dense-eigh path of
    ``lobpcg.smallest_eigvecs`` (buckets stop at the n where the flat
    solver goes dense too)."""
    dense = _dense(G, G.W.vals)
    deg = torch.sum(dense, dim=-1)
    L = torch.diag_embed(deg) - dense
    if cfg.normalized_init:
        dih = torch.rsqrt(torch.clamp(deg, min=1e-12))
        L = dih[..., :, None] * L * dih[..., None, :]
    return torch.linalg.qr(_dense_smallest(L, G.mask, k))[0]


def _make_level_step(cfg):
    """One continuation level of the batched solve: (G, U, p) ->
    (U', fval (B,)).

    newton: ``rtr_minimize_batched``, each graph of the batch on its own
    trust-region trajectory, with the HVP ``cfg.hvp_mode`` names.  scf:
    ``scf_sweeps`` fixed sweeps of the reweighted dense eigensolve (the
    flat ≤ 1024-vertex path) with a per-element freeze: an element whose
    drift fell below ``scf_tol`` stops updating, as the flat driver's
    early exit does; nothing is read back."""
    eps = cfg.eps
    if cfg.solver == "newton":
        hvp = (plap.batched_hess_eta_graphblas if cfg.hvp_mode == "graphblas"
               else plap.batched_hess_eta_matrix_free)

        def step(G, U, p):
            W = G.W
            f = lambda V: plap.batched_value(W, V, p, eps, desc=_COO)
            g = lambda V: plap.batched_euc_grad(W, V, p, eps, desc=_COO)
            h = lambda V, eta: hvp(W, V, eta, p, eps, desc=_COO)
            res = rtr_minimize_batched(f, g, h, U,
                                       max_iters=cfg.newton_iters,
                                       tcg_iters=cfg.tcg_iters,
                                       grad_tol=cfg.grad_tol)
            return res.U, res.fval

        return step

    if cfg.solver == "scf":
        sweeps, tol = max(int(cfg.scf_sweeps), 1), cfg.scf_tol

        def step(G, U, p):
            nb, n, k = U.shape
            rows, cols = G.W.rows.long(), G.W.cols.long()
            done = torch.zeros(nb, dtype=torch.bool, device=U.device)
            for _ in range(sweeps):
                Uf = U.reshape(nb * n, k)
                d = Uf[rows] - Uf[cols]
                g2 = torch.sum(d * d, dim=-1)
                dense = _dense(G, G.W.vals * (g2 + eps) ** ((p - 2.0) / 2.0))
                L = torch.diag_embed(torch.sum(dense, dim=-1)) - dense
                V = torch.linalg.qr(_dense_smallest(L, G.mask, k))[0]
                drift = k - torch.sum(torch.bmm(V.transpose(1, 2), U) ** 2,
                                      dim=(1, 2))
                U = torch.where(done[:, None, None], U, V)
                done = done | (drift < tol)
            return U, plap.batched_value(G.W, U, p, eps, desc=_COO)

        return step

    raise ValueError(
        f"bucket lane supports solvers 'newton' and 'scf', not "
        f"{cfg.solver!r} (route larger drivers through the solo lane)")


def _solver_sig(cfg) -> tuple:
    return (cfg.solver, cfg.hvp_mode, cfg.eps, cfg.newton_iters,
            cfg.tcg_iters, cfg.grad_tol, cfg.scf_sweeps, cfg.scf_tol,
            cfg.normalized_init, cfg.p_target, cfg.p_factor,
            cfg.warm_p_steps)


class _BucketPlan(NamedTuple):
    """What a build fixes for one batch size on one device."""

    offsets: torch.Tensor           # (B, 1) int64: b·n_b
    b_idx: torch.Tensor             # (B·nnz_b,) int64


class _BucketSolve:
    """The batched solve of one bucket spec under one solver signature.

    Cold: the dense p=2 init, then every level of the p schedule.  Warm:
    the last ``cfg.warm_p_steps`` levels from the supplied embeddings.
    Called with (rows, cols, vals, mask, U0) tensors on the device, each
    with a leading batch axis (U0 is ignored when cold); returns
    (U (B, n_b, k), fvals (B, levels))."""

    def __init__(self, spec: BucketSpec, cfg, key: tuple):
        self.spec, self.key = spec, key
        ps = registry.p_schedule(cfg)
        if spec.mode != "cold":
            ps = ps[-max(int(cfg.warm_p_steps), 1):]
        self.p_schedule = tuple(float(p) for p in ps)
        self.cfg = cfg
        self._step = _make_level_step(cfg)
        self._plans: Dict[Tuple[int, torch.device], _BucketPlan] = {}

    def _plan(self, batch: int, device: torch.device) -> _BucketPlan:
        plan = self._plans.get((batch, device))
        if plan is None:
            registry.mark_trace(self.key)
            ids = torch.arange(batch, device=device)
            plan = _BucketPlan(
                offsets=(ids * self.spec.n)[:, None],
                b_idx=ids.repeat_interleave(self.spec.nnz))
            self._plans[(batch, device)] = plan
        return plan

    def graph(self, rows, cols, vals, mask) -> _BucketGraph:
        """The batch as one block-diagonal COO matrix, rows sorted
        stably (element blocks stay in place; pads move to just after
        their row 0's real entries)."""
        nb = rows.shape[0]
        plan = self._plan(nb, rows.device)
        n_all = nb * self.spec.n
        grow, order = torch.sort((rows.long() + plan.offsets).reshape(-1),
                                 stable=True)
        gcol = (cols.long() + plan.offsets).reshape(-1)[order]
        W = SparseMatrix(n_rows=n_all, n_cols=n_all, nnz=int(grow.shape[0]),
                         rows=grow.int(), cols=gcol.int(),
                         vals=vals.reshape(-1)[order],
                         row_ptr=csr_pointers(grow, n_all))
        base = plan.b_idx * self.spec.n
        return _BucketGraph(W=W, mask=mask, b_idx=plan.b_idx,
                            lrows=grow - base, lcols=gcol - base)

    def __call__(self, rows, cols, vals, mask, U0=None):
        G = self.graph(rows, cols, vals, mask)
        if self.spec.mode == "cold":
            U = _batched_init(G, self.spec.k, self.cfg)
        else:
            U = torch.linalg.qr(U0 * mask[..., None])[0]
        fvals = []
        for p in self.p_schedule:
            U, fv = self._step(G, U, p)
            fvals.append(fv)
        return U, torch.stack(fvals, dim=1)


def _bucket_solver(spec: BucketSpec, cfg):
    """The memoized batched solve of ``spec`` under ``cfg``'s solver
    signature, and its memo key ``spec.key + _solver_sig(cfg)``."""
    key = spec.key + _solver_sig(cfg)
    return registry.memoized(key, lambda: _BucketSolve(spec, cfg, key)), key


# ------------------------------------------------------------------- engine

class EngineStats:
    """Engine counters as live views over the engine's
    :class:`~repro_torch.obs.metrics.MetricsRegistry`.

    Every counter attribute reads one metric family, and
    ``stats.field += 1`` forwards the delta to that monotonic counter.
    ``n_failed`` and ``failures`` both derive from the labeled
    ``serve_failed_total`` family.  ``solve_s`` and ``graphs_per_s`` are
    plain floats (derived timings)."""

    # attribute -> counter family backing it
    _VIEWS = {
        "n_requests": "serve_requests_total",
        "n_results": "serve_results_total",
        "n_batches": "serve_batches_total",
        "n_solo": "serve_solo_total",
        "n_churn": "serve_churn_total",
        "traces": "serve_traces_total",          # bucket-lane builds
        "n_degraded": "serve_degraded_total",    # served at degrade >= 1
        "n_retried": "serve_churn_retries_total",
        "n_quarantined": "serve_quarantined_total",
        "n_quarantine_splits": "serve_quarantine_splits_total",
    }

    def __init__(self, registry: Optional[_obs_metrics.MetricsRegistry] = None):
        self.registry = registry if registry is not None \
            else _obs_metrics.MetricsRegistry()
        self.solve_s = 0.0
        self.graphs_per_s = 0.0

    def record_failure(self, kind: str) -> None:
        """The one write path of the failure taxonomy."""
        self.registry.counter("serve_failed_total", kind=kind).inc()

    @property
    def n_failed(self) -> int:
        """Requests that returned a structured error (any kind)."""
        return int(self.registry.total("serve_failed_total"))

    @property
    def failures(self) -> Dict[str, int]:
        """The failure taxonomy's histogram, from the ``kind`` label of
        ``serve_failed_total``."""
        vals = self.registry.labeled_values("serve_failed_total", "kind")
        return {k: int(v) for k, v in vals.items()}

    def as_dict(self) -> dict:
        out = {name: getattr(self, name)
               for name in ("n_requests", "n_results", "n_batches",
                            "n_solo", "n_churn", "traces")}
        out["solve_s"] = self.solve_s
        out["graphs_per_s"] = self.graphs_per_s
        for name in ("n_failed", "n_degraded", "n_retried",
                     "n_quarantined", "n_quarantine_splits"):
            out[name] = getattr(self, name)
        out["failures"] = self.failures
        return out

    def exposition(self) -> str:
        """Prometheus text exposition of the whole engine registry."""
        return self.registry.exposition()


def _stat_view(metric: str) -> property:
    def fget(self):
        return int(self.registry.value(metric))

    def fset(self, value):
        self.registry.counter(metric).inc(value - self.registry.value(metric))

    return property(fget, fset)


for _field, _metric in EngineStats._VIEWS.items():
    setattr(EngineStats, _field, _stat_view(_metric))
del _field, _metric


def _classify(err) -> str:
    """The failure-taxonomy key of an exception."""
    if isinstance(err, BackendUnavailableError):
        return "backend_error"
    if isinstance(err, SolverDivergence):
        return "solver_divergence"
    from repro_torch.graphs.validate import GraphValidationError

    if isinstance(err, GraphValidationError):
        return "invalid_input"
    if isinstance(err, BaseException):
        return "exception"
    return "nonfinite_result"


def _qr(U: torch.Tensor) -> torch.Tensor:
    return torch.linalg.qr(U)[0]


class ClusterServeEngine:
    """Batched, warm-started p-spectral clustering server.

    >>> eng = ClusterServeEngine(PSCConfig(k=4))
    >>> rid = eng.submit(W)
    >>> res = eng.flush()[rid]           # labels, rcut, ServeStats

    ``submit`` enqueues; a batch launches when its bucket holds
    ``max_batch`` requests or its oldest request has waited
    ``max_wait_s`` (``poll`` drives the clock; ``flush`` drains
    everything).  Requests above ``max_bucket_n`` vertices take the solo
    lane — the flat pipeline, or the multilevel V-cycle when ``ml`` is
    given — with the same cache semantics.  Each request runs on its
    graph's device.
    """

    def __init__(self, cfg: Optional[PSCConfig] = None, *,
                 cache_capacity: int = 64, max_batch: int = 8,
                 max_wait_s: float = 0.05, max_bucket_n: int = 1024,
                 min_bucket_n: int = 64, min_bucket_nnz: int = 128,
                 ml=None, weight_quant: float = 1e-6,
                 deadline_s: Optional[float] = None,
                 tail_frac: float = 0.5, churn_retries: int = 2,
                 retry_backoff_s: float = 0.01,
                 validate_inputs: bool = False):
        self.cfg = cfg if cfg is not None else PSCConfig()
        if self.cfg.reorder != "none":
            raise ValueError("the serve engine owns vertex order; use "
                             "reorder='none' in the template config")
        # one registry for engine and cache: EngineStats and
        # WarmCache.stats() are views over it
        self.metrics = _obs_metrics.MetricsRegistry()
        self.cache = WarmCache(cache_capacity, metrics=self.metrics)
        self.max_batch = int(max_batch)
        self.max_wait_s = float(max_wait_s)
        self.max_bucket_n = int(max_bucket_n)
        self.min_bucket_n = int(min_bucket_n)
        self.min_bucket_nnz = int(min_bucket_nnz)
        self.ml = ml
        self.weight_quant = float(weight_quant)
        # a request older than ``tail_frac * deadline_s`` degrades to a
        # schedule-tail-only solve (level 1), older than ``deadline_s``
        # to p=2-init labels (level 2); churn re-solves retry
        # ``churn_retries`` times with exponential backoff, then fall
        # back to a cold solve
        self.deadline_s = None if deadline_s is None else float(deadline_s)
        self.tail_frac = float(tail_frac)
        self.churn_retries = int(churn_retries)
        self.retry_backoff_s = float(retry_backoff_s)
        self.validate_inputs = bool(validate_inputs)
        self._sleep = time.sleep          # test seam (no real sleeps)
        self._buckets: Dict[tuple, List[_Pending]] = {}
        self._solo: List[_Pending] = []
        self._results: Dict[int, ServeResult] = {}
        self._next_id = 0
        self.stats = EngineStats(self.metrics)
        self._bucketable = self.cfg.solver in ("newton", "scf")

    def exposition(self) -> str:
        """Prometheus text exposition of the engine's registry (engine
        and warm-cache counters, queue and occupancy instruments)."""
        return self.metrics.exposition()

    def _note_queue(self) -> None:
        depth = sum(len(q) for q in self._buckets.values()) + len(self._solo)
        self.metrics.gauge("serve_queue_depth").set(depth)

    # ------------------------------------------------------------ admission

    def submit(self, W: SparseMatrix, k: Optional[int] = None) -> int:
        """Enqueue a clustering request; returns its request id."""
        return self._admit(W, k=k)

    def update(self, base: SparseMatrix, delta: EdgeDelta,
               k: Optional[int] = None) -> int:
        """Enqueue an incremental re-cluster of ``base`` under ``delta``.

        With a cached solve of ``base`` this is the churn path (a warm
        solve on the edited weights; a hierarchy patch and a refine-only
        V-cycle on the multilevel lane).  Without one it is a cold solve
        of the edited graph."""
        d = apply_edge_delta(base, delta)
        entry = self.cache.peek(base.fingerprint(self.weight_quant))
        return self._admit(d.W, k=k, churn=True, churn_entry=entry,
                           touched=d.touched,
                           pattern_changed=d.pattern_changed)

    def _admit(self, W: SparseMatrix, k: Optional[int], churn: bool = False,
               churn_entry: Optional[CacheEntry] = None,
               touched=None, pattern_changed: bool = False) -> int:
        k = int(k) if k is not None else self.cfg.k
        if k < 1 or k > max(W.n_rows, 1):
            raise ValueError(f"k={k} invalid for an n={W.n_rows} graph "
                             f"(need 1 <= k <= n)")
        rid = self._next_id
        self._next_id += 1
        self.stats.n_requests += 1
        if self.validate_inputs:
            from repro_torch.graphs.validate import quick_check

            issue = quick_check(W)
            if issue is not None:
                # refused at admission: the request resolves with its
                # structured error and never reaches a batch
                pend = _Pending(req_id=rid, W=W, k=k, fp=None, spec=None,
                                mode="cold", cache_tier=None, warm_U=None,
                                arrival=time.monotonic(), churn=churn)
                self._fail(pend, issue, kind="invalid_input",
                           lane="admission")
                return rid
        fp = W.fingerprint(self.weight_quant)

        if churn:
            tier, warm_U, hier = None, None, None
            if churn_entry is not None and len(churn_entry.labels) == W.n_rows:
                tier, warm_U = "exact", churn_entry.U
                hier = churn_entry.hierarchy
        else:
            entry, tier = self.cache.lookup(fp)
            warm_U = entry.U if entry is not None else None
            hier = entry.hierarchy if entry is not None else None
            if warm_U is not None and len(warm_U) != W.n_rows:
                warm_U, tier, hier = None, None, None   # size collision
        mode = "warm" if warm_U is not None else "cold"

        pend = _Pending(req_id=rid, W=W, k=k, fp=fp, spec=None, mode=mode,
                        cache_tier=tier, warm_U=warm_U,
                        arrival=time.monotonic(), churn=churn,
                        touched=touched, pattern_changed=pattern_changed,
                        hierarchy=hier)
        # k == 1 and k == n take the solo lane, which answers them in
        # closed form; the batched solve assumes 1 < k < n
        if self._bucketable and W.n_rows <= self.max_bucket_n \
                and 1 < k < W.n_rows \
                and not (churn and self.ml is not None):
            pend.spec = bucket_for(W, k, mode, self.min_bucket_n,
                                   self.min_bucket_nnz)
            self._buckets.setdefault(pend.spec.key, []).append(pend)
        else:
            self._solo.append(pend)
        self._note_queue()
        return rid

    # ------------------------------------------------------------- draining

    def poll(self, now: Optional[float] = None) -> Dict[int, ServeResult]:
        """Launch every due batch (bucket full, or its oldest request
        past ``max_wait_s``) and every solo request; return the results
        so far (cumulative)."""
        now = time.monotonic() if now is None else now
        self._apply_deadlines(now)
        for bkey in list(self._buckets):
            q = self._buckets[bkey]
            while q and (len(q) >= self.max_batch
                         or now - q[0].arrival >= self.max_wait_s):
                take, self._buckets[bkey] = q[:self.max_batch], \
                    q[self.max_batch:]
                q = self._buckets[bkey]
                self._run_bucket(take)
            if not q:
                del self._buckets[bkey]
        while self._solo:
            self._run_solo(self._solo.pop(0))
        self._note_queue()
        return dict(self._results)

    def flush(self) -> Dict[int, ServeResult]:
        """Drain every queued request regardless of deadlines."""
        self._apply_deadlines(time.monotonic())
        for bkey in list(self._buckets):
            q = self._buckets.pop(bkey)
            for i in range(0, len(q), self.max_batch):
                self._run_bucket(q[i:i + self.max_batch])
        while self._solo:
            self._run_solo(self._solo.pop(0))
        self._note_queue()
        return dict(self._results)

    def serve(self, graphs, k: Optional[int] = None) -> List[ServeResult]:
        """Submit every graph, flush, and return the results in
        submission order."""
        rids = [self.submit(W, k=k) for W in graphs]
        done = self.flush()
        return [done[r] for r in rids]

    def take(self, req_id: int) -> ServeResult:
        return self._results.pop(req_id)

    # ------------------------------------------------------------ deadlines

    def _degrade_level(self, elapsed: float) -> int:
        """0 = full solve, 1 = schedule tail only (p=2 eigensolve and one
        tail level), 2 = p=2-init labels (no continuation)."""
        if self.deadline_s is None:
            return 0
        if elapsed >= self.deadline_s:
            return 2
        if elapsed >= self.tail_frac * self.deadline_s:
            return 1
        return 0

    def _apply_deadlines(self, now: float) -> None:
        """Move deadline-pressed cold bucket requests to the solo lane
        with their degrade level pinned (a degraded solve has another
        schedule, so it cannot share the bucket's build)."""
        if self.deadline_s is None:
            return
        for bkey in list(self._buckets):
            keep: List[_Pending] = []
            for pend in self._buckets[bkey]:
                lvl = self._degrade_level(now - pend.arrival)
                if lvl > 0 and pend.mode == "cold" and not pend.churn:
                    pend.degrade = lvl
                    pend.spec = None
                    self._solo.append(pend)
                else:
                    keep.append(pend)
            if keep:
                self._buckets[bkey] = keep
            else:
                del self._buckets[bkey]

    # ------------------------------------------------------------ execution

    def _fail(self, pend: _Pending, err, *, kind: str, lane: str) -> None:
        """Resolve a request with a structured failure: no labels, never
        cached, its batch neighbours untouched."""
        msg = f"{type(err).__name__}: {err}" if isinstance(
            err, BaseException) else str(err)
        st = ServeStats(
            req_id=pend.req_id, n=pend.W.n_rows, nnz=pend.W.nnz, k=pend.k,
            lane=lane, mode="churn" if pend.churn else pend.mode,
            cache_tier=pend.cache_tier,
            bucket=pend.spec.key if pend.spec else None, batch_size=0,
            queue_s=time.monotonic() - pend.arrival, solve_s=0.0,
            trace_new=False, p_final=float("nan"), degrade=pend.degrade,
            failure_kind=kind, error=msg)
        self._results[pend.req_id] = ServeResult(
            req_id=pend.req_id, labels=None, U=None, rcut=float("nan"),
            ncut=float("nan"), stats=st, error=msg)
        self.stats.n_results += 1
        self.stats.record_failure(kind)
        _obs_trace.ACTIVE.instant("serve.fail", cat="serve",
                                  req_id=pend.req_id, kind=kind, lane=lane)

    def _solve_bucket(self, pends: List[_Pending], spec) -> tuple:
        """The batched solve itself (``_run_bucket`` owns quarantine).
        Returns (U (max_batch, n_b, k), per-element finiteness, whether
        this batch made a new build, seconds)."""
        t0 = time.monotonic()
        solver, key = _bucket_solver(spec, self.cfg)
        n_traces0 = registry.SOLVER_TRACES.count(key)
        if _SOLVE_FAULT is not None:
            _SOLVE_FAULT(pends)
        batch: BucketBatch = assemble_batch([p.W for p in pends], spec)
        U0 = pad_embeddings([p.warm_U for p in pends], spec) \
            if spec.mode == "warm" else None
        # pad the batch axis to max_batch (replicating the last request)
        # so a partial batch reuses the full batch's build
        fill = self.max_batch - len(pends)
        dev = pends[0].W.device

        def _fill(a):
            a = a if fill <= 0 else \
                np.concatenate([a, np.repeat(a[-1:], fill, axis=0)])
            return torch.as_tensor(a, device=dev)

        with _obs_trace.ACTIVE.span("serve.bucket_solve", cat="serve",
                                    bucket=str(spec.key), mode=spec.mode,
                                    batch=len(pends), n=spec.n,
                                    nnz=spec.nnz, k=spec.k) as sp:
            U, fvals = solver(_fill(batch.rows), _fill(batch.cols),
                              _fill(batch.vals), _fill(batch.mask),
                              None if U0 is None else _fill(U0))
            sp.fence(U)
            trace_new = registry.SOLVER_TRACES.count(key) > n_traces0
            sp.set(trace_new=trace_new)
        # an element is healthy when its U and its F_p of every level are
        # finite (a NaN weight can leave eigh's vectors finite on the
        # host, never the energies)
        finite = (torch.isfinite(U).flatten(1).all(dim=1)
                  & torch.isfinite(fvals).all(dim=1)).tolist()
        return U, finite, trace_new, time.monotonic() - t0

    def _run_bucket(self, pends: List[_Pending]) -> None:
        spec = pends[0].spec
        self.metrics.histogram("serve_batch_occupancy",
                               buckets=(1, 2, 4, 8, 16, 32)
                               ).observe(len(pends))
        try:
            U, finite, trace_new, solve_s = self._solve_bucket(pends, spec)
        except _PASS_THROUGH:
            raise
        except Exception as exc:            # noqa: BLE001 — quarantined
            if len(pends) == 1:
                # bisection bottomed out: this request is the poison
                self.stats.n_quarantined += 1
                self._fail(pends[0], exc, kind=_classify(exc),
                           lane="bucket")
                return
            # a thrown batch names no culprit: bisect, the survivors
            # re-run, the poisoned half recurses down to one request
            self.stats.n_quarantine_splits += 1
            _obs_trace.ACTIVE.instant("serve.quarantine_split", cat="serve",
                                      batch=len(pends),
                                      bucket=str(spec.key))
            mid = len(pends) // 2
            self._run_bucket(pends[:mid])
            self._run_bucket(pends[mid:])
            return
        if trace_new:
            self.stats.traces += 1
        self.stats.n_batches += 1
        self.stats.solve_s += solve_s
        p_final = float(registry.p_schedule(self.cfg)[-1])
        for b, pend in enumerate(pends):
            if not finite[b]:
                # the batch's elements are numerically independent, so a
                # NaN here is this request's own divergence
                self.stats.n_quarantined += 1
                self._fail(pend, "non-finite embedding or energy from "
                                 "the batched solve (request-local "
                                 "divergence)",
                           kind="nonfinite_result", lane="bucket")
                continue
            self._finish(pend, U[b, :pend.W.n_rows].clone(), lane="bucket",
                         batch_size=len(pends), solve_s=solve_s,
                         trace_new=trace_new, p_final=p_final,
                         hierarchy=None)

    def _churn_solve(self, pend: _Pending, cfg) -> tuple:
        """The churn re-solve with retry and backoff: a transient fault
        retries up to ``churn_retries`` times; then a cold solve of the
        edited graph (correct, slower)."""
        last = None
        for attempt in range(self.churn_retries + 1):
            try:
                if _CHURN_FAULT is not None:
                    _CHURN_FAULT(pend, attempt)
                res, hierarchy, _ = incremental_recluster(
                    pend.W, pend.touched, pend.pattern_changed,
                    pend.warm_U, cfg, ml=self.ml,
                    hierarchy=pend.hierarchy)
                return res, hierarchy, attempt
            except _PASS_THROUGH:
                raise
            except Exception as exc:        # noqa: BLE001 — retried
                last = exc
                if attempt < self.churn_retries:
                    self.stats.n_retried += 1
                    _obs_trace.ACTIVE.instant(
                        "serve.retry", cat="serve", req_id=pend.req_id,
                        attempt=attempt, error=type(exc).__name__)
                    self._sleep(self.retry_backoff_s * (2.0 ** attempt))
        # retries exhausted: a cold solve of the edited graph
        cold = dataclasses.replace(cfg, init_U=None, multilevel=self.ml)
        try:
            res = _psc.p_spectral_cluster(pend.W, cold)
        except _PASS_THROUGH:
            raise
        except Exception:
            raise last if last is not None else RuntimeError(
                "churn fallback failed")
        return res, None, self.churn_retries + 1

    def _run_solo(self, pend: _Pending) -> None:
        with _obs_trace.ACTIVE.span(
                "serve.solo_solve", cat="serve", req_id=pend.req_id,
                n=pend.W.n_rows, nnz=pend.W.nnz, k=pend.k,
                mode="churn" if pend.churn else pend.mode) as sp:
            self._run_solo_impl(pend, sp)

    def _keep_hierarchy(self, W: SparseMatrix, cfg):
        """The multilevel hierarchy of ``W``, built again after a cold
        V-cycle so churn can patch it."""
        from repro_torch.multilevel import build_hierarchy
        from repro_torch.multilevel.vcycle import _layout_kwargs

        return build_hierarchy(
            W, coarse_size=self.ml.coarse_size,
            max_levels=self.ml.max_levels,
            min_reduction=self.ml.min_reduction,
            rounds=self.ml.match_rounds, layout_kwargs=_layout_kwargs(cfg),
            sparsify=self.ml.sparsify, max_agg=self.ml.match_max_agg)

    def _run_solo_impl(self, pend: _Pending, sp) -> None:
        t0 = time.monotonic()
        self.stats.n_solo += 1
        cfg = dataclasses.replace(self.cfg, k=pend.k)
        hierarchy = None
        retries = 0
        if self.deadline_s is not None and not pend.churn \
                and pend.mode == "cold":
            pend.degrade = max(pend.degrade,
                               self._degrade_level(t0 - pend.arrival))
        sp.set(degrade=pend.degrade)
        try:
            if pend.churn and pend.warm_U is not None:
                res, hierarchy, retries = self._churn_solve(pend, cfg)
            elif pend.degrade == 2:
                # level 2: p=2-init labels, one eigensolve, no descent
                from repro_torch.core import lobpcg

                _, U0 = lobpcg.smallest_eigvecs(
                    pend.W, pend.k, normalized=cfg.normalized_init,
                    seed=cfg.seed)
                self.stats.n_degraded += 1
                _obs_trace.ACTIVE.instant("serve.degrade", cat="serve",
                                          req_id=pend.req_id, level=2)
                solve_s = time.monotonic() - t0
                self.stats.solve_s += solve_s
                self._finish(pend, _qr(U0), lane="solo", batch_size=1,
                             solve_s=solve_s, trace_new=False, p_final=2.0,
                             hierarchy=None)
                return
            else:
                if pend.degrade == 1:
                    # level 1: the p=2 eigensolve in, one warm level at
                    # p_target out
                    from repro_torch.core import lobpcg

                    _, U0 = lobpcg.smallest_eigvecs(
                        pend.W, pend.k, normalized=cfg.normalized_init,
                        seed=cfg.seed)
                    cfg = dataclasses.replace(cfg, init_U=_qr(U0),
                                              warm_p_steps=1,
                                              multilevel=None)
                    self.stats.n_degraded += 1
                    _obs_trace.ACTIVE.instant("serve.degrade", cat="serve",
                                              req_id=pend.req_id, level=1)
                elif pend.warm_U is not None:
                    cfg = dataclasses.replace(cfg, init_U=pend.warm_U,
                                              multilevel=None)
                elif self.ml is not None:
                    cfg = dataclasses.replace(cfg, multilevel=self.ml)
                res = _psc.p_spectral_cluster(pend.W, cfg)
                if self.ml is not None and pend.warm_U is None \
                        and pend.degrade == 0:
                    hierarchy = self._keep_hierarchy(pend.W, cfg)
        except _PASS_THROUGH:
            raise
        except Exception as exc:            # noqa: BLE001 — isolated
            self._fail(pend, exc, kind=_classify(exc), lane="solo")
            return
        if not (bool(torch.isfinite(res.U).all())
                and np.isfinite(res.fvals).all()):
            self._fail(pend, "non-finite embedding or energy from the solo "
                             "solve",
                       kind="nonfinite_result", lane="solo")
            return
        solve_s = time.monotonic() - t0
        self.stats.solve_s += solve_s
        sp.set(retries=retries)
        p_final = res.p_path[-1] if res.p_path else \
            float(registry.p_schedule(self.cfg)[-1])
        self._finish(pend, res.U, lane="solo", batch_size=1,
                     solve_s=solve_s, trace_new=False, p_final=p_final,
                     hierarchy=hierarchy, precomputed=res, retries=retries)

    def _finish(self, pend: _Pending, U: torch.Tensor, *, lane: str,
                batch_size: int, solve_s: float, trace_new: bool,
                p_final: float, hierarchy, precomputed=None,
                retries: int = 0) -> None:
        """Stage 3 and the metrics on the caller's own graph, the cache
        store and the stats."""
        W, k = pend.W, pend.k
        if precomputed is not None:
            labels = np.asarray(precomputed.labels)
            rcut, ncut = precomputed.rcut, precomputed.ncut
        else:
            _, g_final = _psc.stage_generators(self.cfg.seed, W.device)
            labels = _psc.discretize(
                U, k, g_final,
                restarts=self.cfg.kmeans_restarts,
                iters=self.cfg.kmeans_iters).cpu().numpy()
            rcut = float(metrics.rcut(W, labels, k))
            ncut = float(metrics.ncut(W, labels, k))
        self.cache.store(CacheEntry(
            U=U, labels=labels, p_final=p_final, rcut=rcut,
            fingerprint=pend.fp, hierarchy=hierarchy))
        done = time.monotonic()
        st = ServeStats(
            req_id=pend.req_id, n=W.n_rows, nnz=W.nnz, k=k, lane=lane,
            mode="churn" if pend.churn else pend.mode,
            cache_tier=pend.cache_tier,
            bucket=pend.spec.key if pend.spec else None,
            batch_size=batch_size, queue_s=done - pend.arrival - solve_s,
            solve_s=solve_s, trace_new=trace_new, p_final=p_final,
            degrade=pend.degrade, retries=retries)
        self._results[pend.req_id] = ServeResult(
            req_id=pend.req_id, labels=labels, U=U, rcut=rcut, ncut=ncut,
            stats=st)
        self.stats.n_results += 1
        if pend.churn:
            self.stats.n_churn += 1
        if self.stats.solve_s > 0:
            self.stats.graphs_per_s = self.stats.n_results / \
                self.stats.solve_s
