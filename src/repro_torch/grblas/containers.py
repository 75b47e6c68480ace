"""Algebraic containers: sparse matrices as torch tensors on one device.

Port of ``repro.grblas.containers`` with the COO, ELL, SELL-C-σ and
BSR layouts.  Construction is host-side numpy (the BSR tiles are
scattered on the target device) and produces layout arrays equal,
element for element, to the reference's; the result lives on the
device the caller names (default ``cuda``).

  * COO    (rows, cols, vals)      sorted by row then col
  * ELL    (ell_cols, ell_vals)    padded rows, pad = (col=row, val=0)
  * SELL-C-σ                       σ-window degree sort, C-row slices,
                                   each slice padded to its own width
  * BSR    dense (bs, bs) tiles    sorted by (row-block, col-block):
                                   ``bsr_blocks`` (n_blocks, bs, bs),
                                   ``bsr_indices`` / ``bsr_row_ids``
                                   (int32 col- and row-block of each
                                   tile), ``bsr_indptr`` (host int64,
                                   tiles of row-block rb are
                                   [indptr[rb], indptr[rb+1])) and its
                                   int32 device copy for the kernels

SELL-C-σ is stored twice:

  * the reference's storage model, kept equal to it for the parity
    tests: ``sell_perm``/``sell_inv`` and, per run of equal-width
    slices, ``sell_cols``/``sell_vals``/``sell_scatter`` of shape
    (rows_r, w_r) in the PERMUTED index space, with ``sell_row0`` the
    first row of each run;
  * ``sell_kernel`` (a ``SellKernelLayout``), the copy the CUDA kernels
    read: every slice stored slot-major ("classic SELL-C": slot j of the
    slice's C rows is C consecutive entries, so neighbouring threads read
    neighbouring rows), all runs in one array addressed by per-slice
    offsets and widths, column indices in the ORIGINAL index space.  One
    kernel launch covers every run and reads and writes the multivector
    in the caller's row order, so no permuted copy of X or Y is made.

A ``with_vals`` matrix gathers only the kernel copy's values; its
per-run ``sell_vals`` are gathered on first read (the plain twins and
the parity tests), so the device's hot path never builds them.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, numpy_dtype, resolve_device, torch_dtype
from repro_torch.kernels.segment_sum import segment_sum

# When full-ELL padding would store more than this multiple of nnz,
# from_coo builds the SELL-C-σ layout as well (the reference's policy).
SELLCS_AUTO_THRESHOLD = 4.0


def _row_layout(rows, n_rows: int, nnz: int):
    """(counts, pos_in_row) for a (row, col)-sorted COO triple."""
    counts = np.bincount(rows, minlength=max(n_rows, 1))
    pos_in_row = np.arange(nnz) - np.repeat(
        np.concatenate([[0], np.cumsum(counts)[:-1]]), counts)
    return counts, pos_in_row


@dataclasses.dataclass
class SellKernelLayout:
    """The slot-major SELL-C-σ copy the CUDA kernels read.

    Permuted row r (0 <= r < n) lives in slice s = r // C at lane
    r % C; its slot j is entry ``slice_ptr[s] + j * C + r % C`` of
    ``cols``/``vals``/``scatter``, for j < ``slice_w[s]``.  ``cols``
    holds ORIGINAL column ids (pads: the row's own original id, value 0)
    and ``perm[r]`` is the original id of permuted row r.  ``vals`` is
    (slots,) or (slots, k) multivalues; ``scatter`` maps each slot to
    its COO nnz index (pads -> nnz).  ``block_orders`` caches the
    kernels' block schedules, which depend on ``perm`` alone; a
    ``with_vals`` copy shares the cache.
    """

    n: int
    C: int
    slice_ptr: torch.Tensor   # (n_slices,) int32
    slice_w: torch.Tensor     # (n_slices,) int32
    perm: torch.Tensor        # (n,) int32
    cols: torch.Tensor        # (slots,) int32
    vals: torch.Tensor        # (slots,) or (slots, k)
    scatter: torch.Tensor     # (slots,) int64
    block_orders: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def slots(self) -> int:
        return int(self.cols.shape[0])

    def with_vals(self, vext: torch.Tensor) -> "SellKernelLayout":
        """Same layout, values gathered from ``vext`` (nnz + 1 rows, the
        last one the pad's zero)."""
        return dataclasses.replace(self, vals=vext[self.scatter])


@dataclasses.dataclass
class SparseMatrix:
    n_rows: int
    n_cols: int
    nnz: int
    rows: torch.Tensor                       # (nnz,) int32
    cols: torch.Tensor                       # (nnz,) int32
    vals: torch.Tensor                       # (nnz,) or (nnz, k)
    # entries are sorted by (row, col): row r holds [row_ptr[r],
    # row_ptr[r+1]), (n_rows + 1,) int64
    row_ptr: Optional[torch.Tensor] = None
    ell_cols: Optional[torch.Tensor] = None  # (n_rows, max_nnz) int32
    ell_vals: Optional[torch.Tensor] = None  # (n_rows, max_nnz)
    block_size: int = 0
    bsr_indptr: Optional[np.ndarray] = None          # (n_rb + 1,) host int64
    bsr_indptr_dev: Optional[torch.Tensor] = None    # the same, int32
    bsr_indices: Optional[torch.Tensor] = None       # (n_blocks,) int32
    bsr_blocks: Optional[torch.Tensor] = None        # (n_blocks, bs, bs)
    bsr_row_ids: Optional[torch.Tensor] = None       # (n_blocks,) int32
    sell_c: int = 0
    sell_sigma: int = 0
    sell_w_align: int = 1
    sell_n_pad: int = 0
    sell_row0: Tuple[int, ...] = ()
    sell_perm: Optional[torch.Tensor] = None      # (n_pad,) int32
    sell_inv: Optional[torch.Tensor] = None       # (n_rows,) int32
    sell_cols: Optional[Tuple[torch.Tensor, ...]] = None
    sell_scatter: Optional[Tuple[torch.Tensor, ...]] = None
    sell_kernel: Optional[SellKernelLayout] = None
    # per-run values, or (with_vals) the nnz + 1 values they gather from
    _sell_vals: Optional[Tuple[torch.Tensor, ...]] = None
    _sell_vext: Optional[torch.Tensor] = None

    @property
    def device(self) -> torch.device:
        return self.vals.device

    @property
    def dtype(self) -> torch.dtype:
        return self.vals.dtype

    @property
    def sell_vals(self) -> Optional[Tuple[torch.Tensor, ...]]:
        """Per-run (rows_r, w_r[, k]) values, the reference's storage
        model; a with_vals matrix gathers them here on first read."""
        if self._sell_vals is None and self._sell_vext is not None:
            self._sell_vals = tuple(self._sell_vext[sc.long()]
                                    for sc in self.sell_scatter)
        return self._sell_vals

    # ---- constructors ----
    @staticmethod
    def from_coo(rows, cols, vals, shape: Tuple[int, int],
                 build_ell: Optional[bool] = None, build_bsr: bool = False,
                 block_size: int = 128, dtype=torch.float32,
                 build_sellcs: Optional[bool] = None,
                 sell_c: int = 32, sell_sigma: Optional[int] = None,
                 sell_w_align: int = 1,
                 device: DeviceLike = None) -> "SparseMatrix":
        """Build from a host COO triple (numpy or lists).

        ``build_sellcs=None`` builds SELL-C-σ exactly when full-ELL
        padding would exceed SELLCS_AUTO_THRESHOLD x nnz (square
        matrices only); ``build_ell=None`` builds ELL except in that
        same regime — the reference's auto-build policy.  BSR is built
        only on request (``build_bsr=True``, tiles of ``block_size``)."""
        dev = resolve_device(device)
        tdtype = torch_dtype(dtype)
        np_dtype = numpy_dtype(tdtype)
        rows = np.asarray(rows, np.int64)
        cols = np.asarray(cols, np.int64)
        vals = np.asarray(vals)
        order = np.lexsort((cols, rows))
        rows, cols, vals = rows[order], cols[order], vals[order]
        n_rows, n_cols = shape
        nnz = len(vals)

        mat = SparseMatrix(
            n_rows=n_rows, n_cols=n_cols, nnz=nnz,
            rows=torch.as_tensor(rows.astype(np.int32), device=dev),
            cols=torch.as_tensor(cols.astype(np.int32), device=dev),
            vals=torch.as_tensor(vals.astype(np_dtype), device=dev),
            row_ptr=torch.as_tensor(
                np.searchsorted(rows, np.arange(n_rows + 1)).astype(np.int64),
                device=dev),
        )
        counts = pos_in_row = None
        if build_ell is not False or build_sellcs is not False:
            counts, pos_in_row = _row_layout(rows, n_rows, nnz)
            predicted_ell = n_rows * max(int(counts.max()) if nnz else 0, 1)
            ell_blown_up = (nnz > 0
                            and predicted_ell > SELLCS_AUTO_THRESHOLD * nnz)
            if build_sellcs is None:
                build_sellcs = ell_blown_up and n_rows == n_cols
            if build_ell is None:
                build_ell = not (ell_blown_up and build_sellcs)
        if build_ell:
            mat._build_ell(rows, cols, vals, np_dtype, counts, pos_in_row)
        if build_bsr:
            mat._build_bsr(rows, cols, vals, block_size, np_dtype)
        if build_sellcs and n_rows > 0:
            mat._build_sellcs(rows, cols, vals, sell_c, sell_sigma, np_dtype,
                              w_align=sell_w_align, counts=counts,
                              pos_in_row=pos_in_row)
        return mat

    @staticmethod
    def from_scipy(sp, **kw) -> "SparseMatrix":
        """Build from a scipy sparse matrix; ``kw`` as for from_coo."""
        sp = sp.tocoo()
        return SparseMatrix.from_coo(sp.row, sp.col, sp.data, sp.shape, **kw)

    # ---- layout builders (host-side) ----
    def _build_ell(self, rows, cols, vals, np_dtype, counts, pos_in_row):
        n = self.n_rows
        max_nnz = max(int(counts.max()) if n else 0, 1)
        ell_cols = np.empty((n, max_nnz), np.int32)
        ell_cols[:] = np.arange(n, dtype=np.int32)[:, None]  # pad = row itself
        ell_vals = np.zeros((n, max_nnz), np_dtype)
        ell_cols[rows, pos_in_row] = cols
        ell_vals[rows, pos_in_row] = vals
        self.ell_cols = torch.as_tensor(ell_cols, device=self.device)
        self.ell_vals = torch.as_tensor(ell_vals, device=self.device)

    def _build_bsr(self, rows, cols, vals, bs: int, np_dtype):
        """Dense (bs, bs) tiles of every block holding a stored entry,
        sorted by (row-block, col-block).  Requires the COO triple sorted
        by (row, col).  The block bookkeeping is host numpy (the
        reference's); the tiles are allocated in the target dtype on the
        target device and the values scattered there, so the host holds
        no (n_blocks, bs, bs) staging copy.  A repeated (row, col) keeps
        its last value, as the reference's numpy assignment does."""
        bs = int(bs)
        if bs < 1:
            raise ValueError(f"block_size={bs} must be >= 1")
        n_rb = -(-self.n_rows // bs)
        n_cb = -(-self.n_cols // bs)
        block_key = (rows // bs) * n_cb + cols // bs
        uniq, inv = np.unique(block_key, return_inverse=True)
        n_blocks = len(uniq)
        if n_blocks >= 2 ** 31:
            raise ValueError("BSR layout exceeds 2^31 tiles; the kernels "
                             "index tiles with int32")
        u_rb = uniq // n_cb
        indptr = np.zeros(n_rb + 1, np.int64)
        np.add.at(indptr, u_rb + 1, 1)
        indptr = np.cumsum(indptr)
        last = np.ones(len(rows), bool)           # last of each (row, col)
        last[:-1] = (rows[1:] != rows[:-1]) | (cols[1:] != cols[:-1])
        flat = ((inv[last] * bs + rows[last] % bs) * bs + cols[last] % bs)
        dev = self.device
        blocks = torch.zeros((n_blocks, bs, bs), dtype=self.dtype,
                             device=dev)
        blocks.view(-1)[torch.as_tensor(flat, device=dev)] = torch.as_tensor(
            np.ascontiguousarray(vals[last]).astype(np_dtype), device=dev)
        self.block_size = bs
        self.bsr_indptr = indptr
        self.bsr_indptr_dev = torch.as_tensor(indptr.astype(np.int32),
                                              device=dev)
        self.bsr_indices = torch.as_tensor((uniq % n_cb).astype(np.int32),
                                           device=dev)
        self.bsr_blocks = blocks
        self.bsr_row_ids = torch.as_tensor(u_rb.astype(np.int32), device=dev)

    def _build_sellcs(self, rows, cols, vals, C: int, sigma: Optional[int],
                      np_dtype, w_align: int = 1, counts=None,
                      pos_in_row=None):
        """SELL-C-σ: σ-window degree sort, C-row slices, per-slice
        padding (``sigma=None`` sorts globally), plus the slot-major
        kernel copy.  Requires the COO triple sorted by (row, col)."""
        if self.n_rows != self.n_cols:
            raise ValueError(
                "SELL-C-σ permutes row and column space with one "
                f"permutation and requires a square matrix, got "
                f"({self.n_rows}, {self.n_cols})")
        n = self.n_rows
        nnz = len(vals)
        C = max(int(C), 1)
        if counts is None:
            counts, pos_in_row = _row_layout(rows, n, nnz)
        counts = counts.astype(np.int64)
        sigma_eff = n if sigma is None else max(int(sigma), 1)

        # σ-window stable degree sort (descending); pad key -1 sorts last
        n_win = -(-n // sigma_eff)
        counts_pad = np.full(n_win * sigma_eff, -1, np.int64)
        counts_pad[:n] = counts
        order_in_win = np.argsort(-counts_pad.reshape(n_win, sigma_eff),
                                  axis=1, kind="stable")
        perm = (order_in_win
                + np.arange(n_win, dtype=np.int64)[:, None] * sigma_eff
                ).reshape(-1)
        perm = perm[perm < n]
        inv = np.empty(n, np.int64)
        inv[perm] = np.arange(n)

        n_slices = max(-(-n // C), 1)
        n_pad = n_slices * C
        deg_p = np.zeros(n_pad, np.int64)
        deg_p[:n] = counts[perm]
        slice_w = deg_p.reshape(n_slices, C).max(axis=1)
        slice_w = np.maximum(-(-slice_w // w_align) * w_align, 1)
        run_bounds = np.concatenate(
            [[0], np.flatnonzero(np.diff(slice_w)) + 1, [n_slices]])

        i_nnz = inv[rows]                     # permuted position of each entry
        s_nnz = i_nnz // C                    # owning slice
        cols_p = inv[cols]                    # columns in permuted space
        by_slice = np.argsort(s_nnz, kind="stable")
        s_sorted = s_nnz[by_slice]

        perm_pad = np.zeros(n_pad, np.int64)
        perm_pad[:n] = perm
        run_cols, run_vals, run_scat, run_row0 = [], [], [], []
        k_cols, k_vals, k_scat = [], [], []
        for r in range(len(run_bounds) - 1):
            s0, s1 = int(run_bounds[r]), int(run_bounds[r + 1])
            w = int(slice_w[s0])
            row0 = s0 * C
            rows_r = (s1 - s0) * C
            cp = np.empty((rows_r, w), np.int32)
            cp[:] = (row0 + np.arange(rows_r, dtype=np.int32))[:, None]  # pad=self
            vp = np.zeros((rows_r, w), np_dtype)
            sc = np.full((rows_r, w), nnz, np.int32)                     # pad slot
            seg = by_slice[np.searchsorted(s_sorted, s0, "left"):
                           np.searchsorted(s_sorted, s1, "left")]
            cp[i_nnz[seg] - row0, pos_in_row[seg]] = cols_p[seg]
            vp[i_nnz[seg] - row0, pos_in_row[seg]] = vals[seg]
            sc[i_nnz[seg] - row0, pos_in_row[seg]] = seg
            run_cols.append(cp)
            run_vals.append(vp)
            run_scat.append(sc)
            run_row0.append(int(row0))
            # slot-major copy: (slices, C, w) -> (slices, w, C)
            def slot_major(a):
                return a.reshape(s1 - s0, C, w).transpose(0, 2, 1).reshape(-1)
            k_cols.append(slot_major(perm_pad[cp]))
            k_vals.append(slot_major(vp))
            k_scat.append(slot_major(sc))

        slots = slice_w * C
        if int(slots.sum()) >= 2 ** 31:
            raise ValueError("SELL-C-σ layout exceeds 2^31 stored slots; "
                             "the kernels index with int32")
        slice_ptr = np.concatenate([[0], np.cumsum(slots)[:-1]])
        dev = self.device
        to = lambda a, dt=None: torch.as_tensor(
            a if dt is None else a.astype(dt), device=dev)
        self.sell_c = C
        self.sell_sigma = sigma_eff
        self.sell_w_align = max(int(w_align), 1)
        self.sell_n_pad = n_pad
        self.sell_row0 = tuple(run_row0)
        self.sell_perm = to(perm_pad, np.int32)
        self.sell_inv = to(inv, np.int32)
        self.sell_cols = tuple(to(a) for a in run_cols)
        self._sell_vals = tuple(to(a) for a in run_vals)
        self.sell_scatter = tuple(to(a) for a in run_scat)
        self.sell_kernel = SellKernelLayout(
            n=n, C=C,
            slice_ptr=to(slice_ptr, np.int32),
            slice_w=to(slice_w, np.int32),
            perm=to(perm, np.int32),
            cols=to(np.concatenate(k_cols), np.int32),
            vals=to(np.concatenate(k_vals)),
            scatter=to(np.concatenate(k_scat), np.int64))

    # ---- conveniences ----
    def with_vals(self, vals: torch.Tensor) -> "SparseMatrix":
        """Same sparsity pattern, new values — (nnz,) or (nnz, k)
        multivalues (Algorithm 1 builds W-hat this way each Newton step).
        ELL and BSR are dropped (they would be stale); SELL-C-σ survives, its
        scatter maps rebuilding the kernel copy's values on the device
        (the per-run ``sell_vals`` wait until they are read)."""
        m = SparseMatrix(n_rows=self.n_rows, n_cols=self.n_cols,
                         nnz=self.nnz, rows=self.rows, cols=self.cols,
                         vals=vals, row_ptr=self.row_ptr)
        if self.sell_scatter is not None:
            pad = torch.zeros((1,) + tuple(vals.shape[1:]), dtype=vals.dtype,
                              device=vals.device)
            vext = torch.cat([vals, pad], dim=0)      # slot nnz == pad 0
            m.sell_c = self.sell_c
            m.sell_sigma = self.sell_sigma
            m.sell_w_align = self.sell_w_align
            m.sell_n_pad = self.sell_n_pad
            m.sell_row0 = self.sell_row0
            m.sell_perm = self.sell_perm
            m.sell_inv = self.sell_inv
            m.sell_cols = self.sell_cols
            m.sell_scatter = self.sell_scatter
            m._sell_vext = vext
            m.sell_kernel = self.sell_kernel.with_vals(vext)
        return m

    def host_coo(self):
        """Host-side (rows, cols, vals) numpy copies of the COO triple."""
        return (self.rows.cpu().numpy(), self.cols.cpu().numpy(),
                self.vals.cpu().numpy())

    def to_dense(self) -> torch.Tensor:
        d = torch.zeros((self.n_rows, self.n_cols), dtype=self.vals.dtype,
                        device=self.device)
        return d.index_put_((self.rows.long(), self.cols.long()), self.vals,
                            accumulate=True)

    def row_sums(self) -> torch.Tensor:
        """Sum of each row's stored values, added in (row, col) order: the
        same bit for bit on every run (``kernels.segment_sum``)."""
        return segment_sum(self.vals, self.rows, self.n_rows, self.row_ptr)

    # ---- layout cost metrics (stored values / nnz; 1.0 = no padding) ----
    def ell_fill_ratio(self) -> float:
        if self.ell_cols is None:
            return float("nan")
        return float(self.ell_cols.shape[0] * self.ell_cols.shape[1]) / max(self.nnz, 1)

    def bsr_fill_ratio(self) -> float:
        """BSR stored values / nnz (dense-tile zero fill)."""
        if self.bsr_blocks is None:
            return float("nan")
        return float(self.bsr_blocks.numel()) / max(self.nnz, 1)

    def sellcs_fill_ratio(self) -> float:
        if self.sell_cols is None:
            return float("nan")
        stored = sum(c.shape[0] * c.shape[1] for c in self.sell_cols)
        return float(stored) / max(self.nnz, 1)
