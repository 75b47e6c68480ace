"""Shape-bucketed batching for the clustering serve engine (port of
``repro.serve.bucketing``).

Every request is quantized onto a small lattice of (n, nnz, k) buckets
(powers of two, floored); each graph's COO triple is padded up to its
bucket, and one batched solve serves every request of a bucket.  The
engine builds that solve once per (bucket, solver signature)
(``serve.psc_engine``), so the number of builds stays logarithmic in
the graph sizes served.

Padding is sound: pad entries are (0, 0, 0.0), so every segment sum and
every edge-semiring term they add is an exact float zero; pad rows
(vertices n..n_b) are isolated, their embedding rows stay exactly zero
through QR and Newton, and the dense-eigh init shifts their Laplacian
null space to the top of the spectrum so the smallest-k selection never
sees it.  Assembly is host numpy, as in the reference.
"""
from __future__ import annotations

from typing import List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from repro_torch.grblas.containers import SparseMatrix


def next_pow2(x: int, floor: int = 1) -> int:
    """Smallest power of two >= max(x, floor)."""
    v = max(int(x), int(floor), 1)
    return 1 << (v - 1).bit_length()


class BucketSpec(NamedTuple):
    """One build signature of the batched solve: every graph padded to
    (n, nnz) with ``k`` clusters, and ``mode`` ("cold": the whole
    continuation from the p=2 init; "warm": the schedule tail from a
    cached embedding — separate builds, separate lanes)."""

    n: int
    nnz: int
    k: int
    mode: str

    @property
    def key(self) -> tuple:
        return ("serve", self.mode, self.n, self.nnz, self.k)


def bucket_for(W: SparseMatrix, k: int, mode: str, min_n: int = 64,
               min_nnz: int = 128) -> BucketSpec:
    """The bucket a graph pads into: power-of-two (n, nnz) with floors."""
    if W.n_rows != W.n_cols:
        raise ValueError("serve buckets hold square (graph) matrices")
    return BucketSpec(n=next_pow2(W.n_rows, min_n),
                      nnz=next_pow2(W.nnz, min_nnz), k=int(k), mode=mode)


class BucketBatch(NamedTuple):
    """The padded COO triples of one bucket solve, stacked on a batch
    axis: host numpy of the bucket's static shapes."""

    rows: np.ndarray      # (B, nnz_b) int32
    cols: np.ndarray      # (B, nnz_b) int32
    vals: np.ndarray      # (B, nnz_b) float32
    mask: np.ndarray      # (B, n_b) 1.0 on real vertices, 0.0 on pads
    n_real: Tuple[int, ...]


def assemble_batch(graphs: Sequence[SparseMatrix], spec: BucketSpec
                   ) -> BucketBatch:
    """Pad every graph to the bucket and stack them."""
    rows: List[np.ndarray] = []
    cols: List[np.ndarray] = []
    vals: List[np.ndarray] = []
    mask = np.zeros((len(graphs), spec.n), np.float32)
    for b, W in enumerate(graphs):
        r, c, v = W.padded_coo(spec.n, spec.nnz)
        rows.append(r)
        cols.append(c)
        vals.append(v)
        mask[b, :W.n_rows] = 1.0
    return BucketBatch(rows=np.stack(rows), cols=np.stack(cols),
                       vals=np.stack(vals).astype(np.float32), mask=mask,
                       n_real=tuple(W.n_rows for W in graphs))


def pad_embeddings(Us: Sequence, spec: BucketSpec) -> np.ndarray:
    """Stack cached (n_i, k) embeddings (arrays or tensors) into the
    bucket's (B, n_b, k) host warm start, zero on pad rows."""
    out = np.zeros((len(Us), spec.n, spec.k), np.float32)
    for b, U in enumerate(Us):
        U = (U.detach().cpu().numpy() if torch.is_tensor(U)
             else np.asarray(U)).astype(np.float32)
        if U.shape[1] != spec.k or U.shape[0] > spec.n:
            raise ValueError(f"embedding {U.shape} does not fit bucket "
                             f"{(spec.n, spec.k)}")
        out[b, :U.shape[0]] = U
    return out
