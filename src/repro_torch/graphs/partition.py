"""Graph partitioning for device placement — the framework-level use of
the paper's own algorithm (port of ``repro.graphs.partition``).

``partition(W, n_parts)`` runs GrB-pGrass to get a balanced min-RCut
assignment; ``cut_edges`` counts the stored entries it cuts (the halo
volume a distributed SpMM would exchange under that placement);
``partition_for_mesh`` builds the distributed row partition
(``grblas.dist``) from it, same-cluster rows on one shard.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import numpy as np

from repro_torch.core import metrics
from repro_torch.core.psc import PSCConfig, p_spectral_cluster
from repro_torch.grblas.containers import SparseMatrix

# device-placement partitioning is setup-time work on graphs that can be
# huge (the 8M-node regime): above this size the multilevel V-cycle
# (repro_torch.multilevel) replaces the flat solve under multilevel="auto"
MULTILEVEL_AUTO_THRESHOLD = 20_000


def partition(W: SparseMatrix, n_parts: int, p_target: float = 1.4,
              seed: int = 0, balance: bool = True,
              cfg: Optional[PSCConfig] = None,
              multilevel: Union[bool, str] = "auto",
              solver: str = "newton") -> Tuple[np.ndarray, dict]:
    """Balanced min-RCut partition of graph W into n_parts.

    Returns (assignment (n,), info) where info carries the cut metrics
    and the per-part sizes.  ``balance=True`` rebalances overfull parts
    by moving their lowest-margin nodes (greedy, keeps near-equal sizes
    as required for device placement).

    ``multilevel``: True forces the V-cycle fast path, False forces the
    flat solve, "auto" (default) picks the V-cycle once the graph
    crosses MULTILEVEL_AUTO_THRESHOLD vertices — big graphs stop paying
    full-graph solve cost just to be placed on devices.  ``solver``
    names the continuation driver (core.solvers registry: "newton" |
    "scf" | "inverse_power") — placement is setup-time work, so the
    cheap SCF driver is a reasonable pick on big graphs.  An explicit
    ``cfg`` wins: its own ``multilevel``/``solver`` fields are left
    untouched.
    """
    if cfg is None:
        cfg = PSCConfig(k=n_parts, p_target=p_target, seed=seed,
                        newton_iters=15, tcg_iters=10, kmeans_restarts=4,
                        solver=solver)
        use_ml = (multilevel is True
                  or (multilevel == "auto"
                      and W.n_rows >= MULTILEVEL_AUTO_THRESHOLD))
        if use_ml:
            from repro_torch.multilevel import MultilevelConfig

            cfg = dataclasses.replace(cfg, multilevel=MultilevelConfig())
    res = p_spectral_cluster(W, cfg)
    labels = np.asarray(res.labels).copy()

    if balance:
        n = W.n_rows
        target = -(-n // n_parts)
        U = res.U.cpu().numpy()
        # margin: distance to the assigned cluster's centroid
        for _ in range(n_parts):
            sizes = np.bincount(labels, minlength=n_parts)
            over = np.argmax(sizes)
            under = np.argmin(sizes)
            if sizes[over] <= target or sizes[under] >= target:
                break
            movable = np.nonzero(labels == over)[0]
            cen_over = U[labels == over].mean(0)
            cen_under = U[labels == under].mean(0)
            # move the nodes closest to the underfull centroid
            gain = (np.linalg.norm(U[movable] - cen_over, axis=1)
                    - np.linalg.norm(U[movable] - cen_under, axis=1))
            k_move = min(sizes[over] - target, target - sizes[under])
            labels[movable[np.argsort(-gain)[:k_move]]] = under

    info = {
        "rcut": float(metrics.rcut(W, labels, n_parts)),
        "ncut": float(metrics.ncut(W, labels, n_parts)),
        "sizes": np.bincount(labels, minlength=n_parts).tolist(),
        "p_path": res.p_path,
    }
    return labels, info


def cut_edges(W: SparseMatrix, labels: np.ndarray) -> int:
    """Number of (directed) nnz crossing the partition — the halo volume
    of the distributed SpMM under this placement."""
    r, c, _ = W.host_coo()
    return int(np.sum(labels[r] != labels[c]))


def partition_for_mesh(W: SparseMatrix, n_shards: int, *,
                       p_target: float = 1.4, seed: int = 0,
                       cfg: Optional[PSCConfig] = None,
                       multilevel: Union[bool, str] = "auto",
                       solver: str = "newton",
                       mode: str = "auto", sellcs: bool = False,
                       sell_c: int = 32):
    """Cluster W with its own algorithm, then build the halo-exchange
    row partition with cluster-aligned placement.

    Runs :func:`partition` (balanced min-RCut assignment, the V-cycle on
    big graphs), hands the assignment to
    ``grblas.dist.make_row_partition`` so same-cluster rows share a
    shard, and returns ``(Ap, labels, info)``; ``info`` adds the halo
    plan's stats (mode, halo width, wire bytes of a k=1 call) to the cut
    metrics.  ``mode``/``sellcs``/``sell_c`` pass through to the
    partition builder.
    """
    from repro_torch.grblas.dist import make_row_partition

    labels, info = partition(W, n_shards, p_target=p_target, seed=seed,
                             cfg=cfg, multilevel=multilevel, solver=solver)
    Ap = make_row_partition(W, n_shards, assignment=labels, mode=mode,
                            sellcs=sellcs, sell_c=sell_c)
    info = dict(info)
    info["halo"] = {"mode": Ap.mode, **Ap.wire_bytes(k=1)}
    return Ap, labels, info
