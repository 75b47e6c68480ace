"""Bandwidth-reducing graph orderings (port of ``repro.graphs.reorder``).

After a reverse Cuthill–McKee (RCM) ordering, the neighbours of row i
live near i, so SpMM gathers walk the multivector almost in order and
BSR tiles gather around the diagonal.  Degree ordering is the global
SELL σ-sort applied to the graph itself.

``reorder`` returns a new SparseMatrix over relabeled vertices and both
direction maps; ``core.psc`` (``PSCConfig.reorder``) un-permutes every
row-indexed output before returning, so callers never see the
relabeling::

    W2, perm, inv = reorder(W, method="rcm")
    # perm[new] = old,  inv[old] = new,  W2[i, j] == W[perm[i], perm[j]]
    labels_old = labels_new[inv]

The permutations are host numpy, computed from the same COO triple with
the same scipy routine as the reference, so they equal its own.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import scipy.sparse as sp

from repro_torch.grblas.containers import SparseMatrix


def rcm_ordering(W: SparseMatrix) -> np.ndarray:
    """Reverse Cuthill–McKee permutation (perm[new] = old) on the
    structure of W."""
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    rows, cols, _ = W.host_coo()
    A = sp.csr_matrix((np.ones(W.nnz, np.float32), (rows, cols)),
                      shape=(W.n_rows, W.n_cols))
    return np.asarray(reverse_cuthill_mckee(A, symmetric_mode=False),
                      dtype=np.int64)


def degree_ordering(W: SparseMatrix) -> np.ndarray:
    """Stable descending-degree permutation (perm[new] = old)."""
    deg = np.bincount(W.rows.cpu().numpy(), minlength=W.n_rows)
    return np.argsort(-deg, kind="stable").astype(np.int64)


_ORDERINGS = {"rcm": rcm_ordering, "degree": degree_ordering}


def bandwidth(W: SparseMatrix) -> int:
    """max |i - j| over stored entries — the figure RCM reduces."""
    if W.nnz == 0:
        return 0
    rows, cols, _ = W.host_coo()
    return int(np.abs(rows.astype(np.int64) - cols.astype(np.int64)).max())


def reorder(W: SparseMatrix, method: str = "rcm"
            ) -> Tuple[SparseMatrix, np.ndarray, np.ndarray]:
    """Relabel W's vertices under ``method`` ("rcm" | "degree").

    Returns (W2, perm, inv) with perm[new] = old and inv[old] = new.  W2
    has W's dtype and device and the same derived layouts (ELL, BSR,
    SELL-C-σ, same parameters), so a Descriptor that executed on W
    executes on W2."""
    if method not in _ORDERINGS:
        raise ValueError(f"unknown reorder method {method!r}; "
                         f"known: {sorted(_ORDERINGS)}")
    perm = _ORDERINGS[method](W)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm))
    rows, cols, vals = W.host_coo()
    W2 = SparseMatrix.from_coo(
        inv[rows.astype(np.int64)], inv[cols.astype(np.int64)], vals,
        (W.n_rows, W.n_cols),
        build_ell=W.ell_cols is not None,
        build_bsr=W.bsr_blocks is not None,
        block_size=W.block_size or 128,
        dtype=W.dtype,
        build_sellcs=W.sell_cols is not None,
        sell_c=W.sell_c or 32,
        sell_sigma=W.sell_sigma or None,
        sell_w_align=W.sell_w_align,
        device=W.device)
    return W2, perm, inv
