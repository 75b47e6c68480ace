"""Graph generators reproducing the paper's test families.

A numpy/scipy copy of ``repro.graphs.generators``: the same seeds give the
same edge lists.  Keyword arguments pass through to
``SparseMatrix.from_coo`` (``device=``, ``dtype=``, ``build_sellcs=``,
``sell_c=``, ``build_bsr=``, ``block_size=`` ...); the default device is
``cuda``.

The paper evaluates on SuiteSparse `delaunay_nXX` graphs: Delaunay
triangulations of 2^r uniform points in the unit square (n=2^r nodes,
m ~= 3*2^r undirected edges => ~6*2^r stored nnz).  ``delaunay_graph(r)``
regenerates that family with scipy.spatial.Delaunay.

Also: planted-partition generators (SBM, ring-of-cliques, gaussian-blob
kNN) with known ground truth for quality tests.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from repro_torch.grblas.containers import SparseMatrix


def _symmetrize(rows, cols, vals, n):
    """Make the edge list symmetric, drop self loops and duplicates."""
    keep = rows != cols
    rows, cols, vals = rows[keep], cols[keep], vals[keep]
    r = np.concatenate([rows, cols])
    c = np.concatenate([cols, rows])
    v = np.concatenate([vals, vals])
    key = r.astype(np.int64) * n + c
    _, idx = np.unique(key, return_index=True)
    return r[idx], c[idx], v[idx]


def _to_matrix(rows, cols, vals, n, **kw) -> SparseMatrix:
    """kw passes through to from_coo (device / dtype / build_ell /
    build_sellcs / sell_c / sell_sigma / build_bsr / block_size)."""
    rows, cols, vals = _symmetrize(np.asarray(rows), np.asarray(cols),
                                   np.asarray(vals, np.float64), n)
    return SparseMatrix.from_coo(rows, cols, vals, (n, n), **kw)


def delaunay_graph(r: int, seed: int = 0, locality_order: bool = True,
                   **kw) -> Tuple[SparseMatrix, np.ndarray]:
    """Delaunay triangulation of n=2^r uniform points in the unit square.

    locality_order sorts points by a Hilbert-like (Morton) key first so
    that matrix rows have spatial locality (neighbouring rows gather
    neighbouring multivector rows).
    Returns (W, points).
    """
    from scipy.spatial import Delaunay

    n = 2 ** r
    rng = np.random.default_rng(seed)
    pts = rng.random((n, 2))
    if locality_order:
        # 16-bit Morton interleave
        xi = (pts[:, 0] * 65535).astype(np.uint64)
        yi = (pts[:, 1] * 65535).astype(np.uint64)
        def spread(a):
            a = (a | (a << 8)) & 0x00FF00FF
            a = (a | (a << 4)) & 0x0F0F0F0F
            a = (a | (a << 2)) & 0x33333333
            a = (a | (a << 1)) & 0x55555555
            return a
        key = spread(xi) | (spread(yi) << 1)
        pts = pts[np.argsort(key)]
    tri = Delaunay(pts)
    s = tri.simplices
    rows = np.concatenate([s[:, 0], s[:, 1], s[:, 2]])
    cols = np.concatenate([s[:, 1], s[:, 2], s[:, 0]])
    vals = np.ones(len(rows))
    return _to_matrix(rows, cols, vals, n, **kw), pts


def grid_graph(nx: int, ny: int, **kw) -> SparseMatrix:
    """4-connected nx x ny grid (Delaunay-like banded structure)."""
    idx = np.arange(nx * ny).reshape(ny, nx)
    r = np.concatenate([idx[:, :-1].ravel(), idx[:-1, :].ravel()])
    c = np.concatenate([idx[:, 1:].ravel(), idx[1:, :].ravel()])
    return _to_matrix(r, c, np.ones(len(r)), nx * ny, **kw)


def ring_of_cliques(n_cliques: int, clique_size: int, bridge_w: float = 0.1,
                    **kw) -> Tuple[SparseMatrix, np.ndarray]:
    """k cliques joined in a ring by weak bridges; ground truth = clique id."""
    n = n_cliques * clique_size
    rows, cols, vals = [], [], []
    for ci in range(n_cliques):
        base = ci * clique_size
        for a in range(clique_size):
            for b in range(a + 1, clique_size):
                rows.append(base + a); cols.append(base + b); vals.append(1.0)
        nxt = ((ci + 1) % n_cliques) * clique_size
        rows.append(base); cols.append(nxt); vals.append(bridge_w)
    truth = np.repeat(np.arange(n_cliques), clique_size)
    return _to_matrix(rows, cols, vals, n, **kw), truth


def sbm_graph(sizes, p_in: float, p_out: float, seed: int = 0,
              **kw) -> Tuple[SparseMatrix, np.ndarray]:
    """Stochastic block model with blocks `sizes` (dense Bernoulli over
    all O(n²) pairs — exact, but only viable for small n; use
    ``sbm_graph_sparse`` for the ≥100k-node bench/scaling regime)."""
    rng = np.random.default_rng(seed)
    n = int(sum(sizes))
    truth = np.repeat(np.arange(len(sizes)), sizes)
    r, c = np.triu_indices(n, k=1)
    prob = np.where(truth[r] == truth[c], p_in, p_out)
    keep = rng.random(len(r)) < prob
    return _to_matrix(r[keep], c[keep], np.ones(keep.sum()), n, **kw), truth


def sbm_graph_sparse(sizes, deg_in: float, deg_out: float, seed: int = 0,
                     w_in: float = 1.0, w_out: float = 1.0,
                     **kw) -> Tuple[SparseMatrix, np.ndarray]:
    """Sparse-regime stochastic block model, O(nnz) construction.

    Parameterized by expected degrees instead of probabilities (the
    natural units when n grows): each vertex gets ~``deg_in`` expected
    neighbours inside its block and ~``deg_out`` outside.  Edge counts
    per block pair are Poisson-sampled, endpoints uniform within the
    blocks, duplicates/self-loops dropped by ``_symmetrize`` — never
    touches the O(n²) pair grid, so 500k+-node planted partitions build
    in seconds (the multilevel bench regime, DESIGN.md §6).

    ``w_in`` / ``w_out`` weight intra- vs cross-block edges (the
    weighted planted partition, e.g. similarity graphs).  Note for
    w_in == w_out in the sparse unit-weight regime the blocks are
    locally invisible — no triangles, equal degrees — which is exactly
    the setting where *any* locality-based coarsening loses the planted
    structure while global eigenvectors keep it.
    """
    rng = np.random.default_rng(seed)
    sizes = np.asarray(sizes, np.int64)
    k = len(sizes)
    n = int(sizes.sum())
    offs = np.concatenate([[0], np.cumsum(sizes)])
    truth = np.repeat(np.arange(k), sizes)
    rows_l, cols_l, vals_l = [], [], []
    for a in range(k):
        for b in range(a, k):
            if a == b:
                mean = 0.5 * deg_in * sizes[a]
            else:
                # per-vertex deg_out spread over the other blocks in
                # proportion to their size (undirected: count each
                # unordered pair once)
                mean = deg_out * sizes[a] * sizes[b] / max(n, 1)
            m = int(rng.poisson(mean))
            if m == 0:
                continue
            rows_l.append(offs[a] + rng.integers(0, sizes[a], m))
            cols_l.append(offs[b] + rng.integers(0, sizes[b], m))
            vals_l.append(np.full(m, w_in if a == b else w_out))
    if not rows_l:
        return _to_matrix(np.zeros(0, np.int64), np.zeros(0, np.int64),
                          np.zeros(0), n, **kw), truth
    rows = np.concatenate(rows_l)
    cols = np.concatenate(cols_l)
    vals = np.concatenate(vals_l)
    return _to_matrix(rows, cols, vals, n, **kw), truth


def gaussian_blobs_knn(n_per: int, k_blobs: int, knn: int = 10,
                       sigma: float = 0.35, spread: float = 3.0,
                       seed: int = 0, **kw) -> Tuple[SparseMatrix, np.ndarray]:
    """Gaussian blobs in 2D + Gaussian-weighted kNN graph (classic spectral
    clustering benchmark; exercises weighted edges)."""
    rng = np.random.default_rng(seed)
    centers = spread * np.stack(
        [np.cos(2 * np.pi * np.arange(k_blobs) / k_blobs),
         np.sin(2 * np.pi * np.arange(k_blobs) / k_blobs)], axis=1)
    pts = np.concatenate(
        [c + sigma * rng.standard_normal((n_per, 2)) for c in centers])
    truth = np.repeat(np.arange(k_blobs), n_per)
    d2 = ((pts[:, None, :] - pts[None, :, :]) ** 2).sum(-1)
    np.fill_diagonal(d2, np.inf)
    nbr = np.argsort(d2, axis=1)[:, :knn]
    rows = np.repeat(np.arange(len(pts)), knn)
    cols = nbr.ravel()
    vals = np.exp(-d2[rows, cols] / (2 * sigma ** 2))
    return _to_matrix(rows, cols, vals, len(pts), **kw), truth
