"""Matrix Market I/O for the SuiteSparse graphs the paper uses
(delaunay_n16 .. delaunay_n23); port of ``repro.graphs.mmio``, numpy
only.  The matrix is built by ``SparseMatrix.from_coo`` on the device
``device=`` names (default ``cuda``, as every entry point of the port).

The reader streams the coordinate section in bounded chunks instead of
one ``np.loadtxt`` slurp: a 48M-edge file parsed in one call
materializes a giant (nnz, 3) float64 intermediate (>1 GB) *before*
the int32/float32 conversion — at the paper's 8M-node scale that
transient dominated peak host memory.  Chunked parsing keeps the
resident overhead at ``chunk`` rows.

Handles the header field matrix (``real`` / ``integer`` / ``pattern``
× ``general`` / ``symmetric``): pattern files carry no value column
(every stored entry is weight 1), symmetric files store one triangle
which is mirrored on load.
"""
from __future__ import annotations

import gzip
import warnings
from pathlib import Path

import numpy as np

from repro_torch.grblas.containers import SparseMatrix


def _open_text(path: Path, mode: str = "rt"):
    return (gzip.open if path.suffix == ".gz" else open)(path, mode)


def read_matrix_market(path, build_ell: bool = True, build_bsr: bool = False,
                       block_size: int = 128,
                       chunk: int = 1_000_000, **layout_kwargs
                       ) -> SparseMatrix:
    """Load a ``.mtx`` / ``.mtx.gz`` coordinate file as a SparseMatrix.

    ``chunk`` bounds how many coordinate lines are parsed per pass
    (memory ceiling ~= chunk × 3 float64).  ``layout_kwargs`` pass
    through to ``from_coo`` (device / dtype / build_sellcs / sell_c /
    ...).
    """
    path = Path(path)
    with _open_text(path) as f:
        header = f.readline().strip().lower()
        if not header.startswith("%%matrixmarket"):
            raise ValueError(f"{path}: not a MatrixMarket file ({header!r})")
        fields = header.split()
        if "coordinate" not in fields:
            raise ValueError(f"{path}: only coordinate format is supported")
        symmetric = "symmetric" in fields
        pattern = "pattern" in fields
        line = f.readline()
        while line.startswith("%"):
            line = f.readline()
        n_rows, n_cols, nnz = (int(t) for t in line.split()[:3])

        n_read = 0
        r_parts, c_parts, v_parts = [], [], []
        while n_read < nnz:
            take = min(chunk, nnz - n_read)
            with warnings.catch_warnings():
                # a truncated file hits EOF mid-section; we raise our own
                # error below instead of numpy's empty-input warning
                warnings.simplefilter("ignore")
                data = np.loadtxt(f, max_rows=take, ndmin=2)
            if data.shape[0] == 0:
                raise ValueError(
                    f"{path}: truncated coordinate section "
                    f"({n_read}/{nnz} entries)")
            r_parts.append(data[:, 0].astype(np.int64) - 1)
            c_parts.append(data[:, 1].astype(np.int64) - 1)
            if pattern or data.shape[1] < 3:
                v_parts.append(np.ones(data.shape[0]))
            else:
                v_parts.append(np.ascontiguousarray(data[:, 2]))
            n_read += data.shape[0]

    rows = np.concatenate(r_parts) if r_parts else np.zeros(0, np.int64)
    cols = np.concatenate(c_parts) if c_parts else np.zeros(0, np.int64)
    vals = np.concatenate(v_parts) if v_parts else np.zeros(0)
    if symmetric:
        off = rows != cols
        rows, cols, vals = (np.concatenate([rows, cols[off]]),
                            np.concatenate([cols, rows[off]]),
                            np.concatenate([vals, vals[off]]))
    return SparseMatrix.from_coo(rows, cols, vals, (n_rows, n_cols),
                                 build_ell=build_ell, build_bsr=build_bsr,
                                 block_size=block_size, **layout_kwargs)


def write_matrix_market(path, W: SparseMatrix, pattern: bool = False,
                        comment: str = "",
                        chunk: int = 1_000_000) -> None:
    """Write W's COO triple as a MatrixMarket coordinate file (general
    storage — every stored entry, no triangle folding; gzip when the
    path ends in ``.gz``).  ``pattern=True`` drops the value column.

    The coordinate section streams through ``np.savetxt`` in ``chunk``-
    row blocks — same bounded-memory contract as the reader (a 48M-edge
    per-line f-string loop costs minutes of interpreter time)."""
    path = Path(path)
    rows, cols, w_vals = W.host_coo()
    rows = rows.astype(np.int64) + 1
    cols = cols.astype(np.int64) + 1
    kind = "pattern" if pattern else "real"
    with _open_text(path, "wt") as f:
        f.write(f"%%MatrixMarket matrix coordinate {kind} general\n")
        if comment:
            f.write(f"% {comment}\n")
        f.write(f"{W.n_rows} {W.n_cols} {W.nnz}\n")
        for s in range(0, W.nnz, max(int(chunk), 1)):
            e = min(s + chunk, W.nnz)
            if pattern:
                np.savetxt(f, np.column_stack([rows[s:e], cols[s:e]]),
                           fmt="%d %d")
            else:
                vals = np.asarray(w_vals[s:e], np.float64)
                np.savetxt(f, np.column_stack(
                    [rows[s:e].astype(np.float64),
                     cols[s:e].astype(np.float64), vals]),
                    fmt="%d %d %.17g")
