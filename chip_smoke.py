#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py [--newton-iters 30] [--tcg-iters 20]
    python3 chip_smoke.py --sellcs-src SRC
    python3 chip_smoke.py --kmeans-src SRC

The second form only times the SELL-C-σ kernels of the tree whose
``src`` directory is SRC (this one, or an older commit unpacked with
``git archive``) at the shapes of phase 2, the third ``kmeans_assign``
at the main path's shape, at stage 3's k = 48 fp64 and k = 70 fp32 and
at k = 16, 17, 24 and 32 in both dtypes (2^20 points, 8 sets), also by
the profiler's device time; each prints one JSON line with every call's
time and a digest of its outputs (equal digests: equal bits), the third
also a line with the seconds of stage 3 at k = 4, 48 and 70.  To compare two
trees, run them in turns on one card, one after the other: old, new,
new, old.

Phases, none of which catches its own failure:

  1. device: the card's name and power limit (nvidia-smi), the torch and
     CUDA versions, then the build of every kernel from the checkout's
     sources into ``build/torch_ext`` (``repro_torch.kernels.build_all``:
     the six nvcc libraries compile at once).
  2. SELL-C-σ kernels: on ``delaunay_graph(20)`` (n = 2^20, SELL-C-σ with
     C=32) and fp32 multivectors, each kernel's wrapper against its plain
     PyTorch version on the card, with the tolerance of the fp32 parity
     tests (|kernel - plain| <= 2e-5 + 2e-4 |plain|), and its time (median
     of CUDA-event timed runs), the plain version's time and the bound of
     the card, at the shapes the main path launches: ``sellcs_spmm`` with
     scalar values at k = 4, 8 and 24 (each also against
     ``torch.sparse.mm`` on the CSR form of W, a yardstick the port never
     calls) and with (nnz, 4) multivalues, the apply and the HVP at
     k = 4.  Every kernel runs twice, equal bit for bit, and with a NaN
     in one row of X (the HVP: one row of U and one of E), NaN where the
     plain versions put it.  Then the COO backend's reals SpMM with
     full-size W-hat multivalues and ``row_sums``, each twice, equal bit
     for bit (the fixed-order segmented sum), and the sum timed beside
     ``index_add_``, also on rows of about a thousand entries (a planted
     partition with dense blocks), by rows and by columns.
  3. SELL-C-σ path: ``p_spectral_cluster(W, PSCConfig(k=4,
     backend="sellcs"))`` with ``hvp_mode="graphblas"`` and
     ``"matrix_free"``.  Each run starts from zeroed launch counts; it
     fails unless every kernel the mode uses launched, RCut is finite and
     at most 1.01 x the p=2 start's, and U^T U is within 1e-4 of I.
  4. breakdown: at the final U of each mode and p = 1.2, the host time of
     one value, one gradient and one Hessian apply, and a torch.profiler
     window over a few Hessian applies: the device's busy share of the
     window and the kernels that take the most device time.
  5. BSR graph: the same triangulation as BSR with 128 x 128 tiles and
     COO only (no ELL, no SELL-C-σ); its tile count, fill and bytes.
  6. BSR kernels: the three BSR kernels against their plain versions
     (which process tiles in chunks) at full size, fp32, with the same
     tolerance; their times and bounds.  ``bsr_spmm`` at every width the
     main path gives it: k=4 and stage 1's LOBPCG matvec (8 columns) and
     [X, R, P] block (24), each also against
     ``torch.sparse_bsr_tensor(...) @ X`` on the same tiles (a yardstick
     the port never calls, timed beside it), and two runs of one call
     equal bit for bit.  The φ kernels at k=4: the share of stored entries
     that are zero and the non-zeros per tile; both kernels in skip mode
     (the main path's), two runs of one call equal bit for bit; a NaN in
     one row-block of U giving NaN exactly where the plain versions do;
     ``plap_hvp`` in full mode at eps = 0 (NaN pattern and values against
     its plain version, and its time); and the divergent variant of both
     (each lane tests its own weights), timed once against skip mode.
  7. BSR path: ``PSCConfig(k=4, backend="edge_pallas")`` in both HVP
     modes with the checks of phase 3 (stage 1 runs on ``bsr_pallas``,
     the graph having no other reals layout), then the breakdown of
     phase 4.
  8. multilevel BSR path: the same configuration with
     ``multilevel=MultilevelConfig()`` and ``hvp_mode="matrix_free"``,
     every level built with BSR tiles; it fails on non-finite output,
     U^T U off I by more than 1e-4, labels missing a cluster, or no
     launch of the two p-Laplacian kernels.  Its RCut next to the flat
     BSR solve's is printed, not asserted.  Every solve (3, 7, 8) fails
     if a φ kernel launched in any mode but skip.  Then the same graph as
     BSR with 256 x 256 tiles, above the kernels' limit: ``api.mxm`` under
     ``auto`` runs the reals SpMM and the apply on ``coo`` and matches the
     BSR plain versions, and a named ``bsr_pallas`` / ``edge_pallas``
     raises BackendUnavailableError.
  9. dense kernels: flash attention at Gemma-2B's serve shape (B 4,
     Hq 8, Hkv 1, S 2048, D 256, bf16, causal), at a ragged S = 1000,
     with window = 512 and at D 128 with group 4 (all four on the wgmma
     kernel), then the mma.sync kernel at D 32 and the fp32 kernel at
     D 128, each against fp32 math on the same inputs (bf16:
     |d| <= 2^-6 (1 + |ref|): bf16 keeps 8 significant bits, and the
     kernel rounds P and O; fp32: the parity tolerance), each printed
     with the kernel that served it and timed beside the plain version,
     its bound and ``F.scaled_dot_product_attention`` (a yardstick the
     port never calls); kmeans_assign on the row-normalized
     stage-3 input (the final U of the SELL-C-σ matrix_free solve) with
     8 kmeans++ restarts, labels equal except where the plain version's
     two nearest centroids tie within 16 ulps, distances to the fp32
     bound above, twice bit for bit, and each set alone equal to the
     batch; and stage 3 (``psc.discretize``) on that U through the
     plain assignment and through the kernel, in turns.  Then the
     assignment at k = 48 fp64 and k = 70 fp32 (the tiled variant, one
     launch) on 2^20 points with 8 kmeans++ restarts, against the plain
     version (distances to 8 ulps of the largest term, in each dtype),
     twice bit for bit, a set alone equal to the batch, and stage 3 at
     each k, every assignment through the kernels.  Every assignment's
     device time (the profiler's) is printed beside its CUDA-event time.
 10. LM serve path: Gemma-2B at full width (2.51 B parameters, fp32
     params, bf16 compute) with seeded weights on the card; the
     ServeEngine answers 4 requests of 2048-token prompts with 32 greedy
     new tokens.  It fails unless the prefill launched the wgmma flash
     kernel once per layer (18), the last-token prefill logits through the
     kernel are within 2^-5 relative of the same prefill through the
     plain attention, and one decode step's logits are within 2^-5
     relative of a full forward's over the same 2049 tokens.

Every clustering solve (3, 7, 8) also assigns its kmeans stages through
``kmeans_assign``, and fails if it did not launch; the bsr graphblas
solve fails unless its W-hat SpMMs ran through the fixed-order sum.  The
HVP count of every flat solve is printed.  The line before the
last is a JSON object with one entry per kernel, its launches summed
over the paths' runs (and split by path, and for ``bsr_spmm`` by
width), and the card's name and power limit; the last line is ``{"ok":
true, "device": {...}}``.  Without a CUDA device, or without
``src/repro_torch`` beside this script, it exits non-zero and prints no
result.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
FP32_OPS_PER_S = 67e12         # H100 SXM fp32 outside the tensor cores
BF16_OPS_PER_S = 989e12        # H100 SXM dense bf16 tensor cores
FP64_OPS_PER_S = 67e12         # H100 SXM fp64 tensor cores (DMMA)
BF16_TOL = 2.0 ** -6           # 4 x bf16's unit roundoff 2^-8
LM_TOL = 2.0 ** -5             # relative logit error, kernel vs plain
RTOL, ATOL = 2e-4, 2e-5        # fp32 bounds of the kernel parity tests
SPMM_WIDTHS = (4, 8, 24)       # bsr_spmm's widths: the k = 4 multivectors,
                               # LOBPCG's matvec (8) and [X, R, P] block (24)
P, EPS = 1.2, 1e-8             # PSCConfig's p_target and eps
GRAPH_R = 20                   # delaunay_graph(20): n = 1,048,576
BLOCK = 128                    # the reference's default BSR tile
# operations per term (one stored value, one column); a pow counts as
# one operation, so the operation bound is a lower bound
OPS = {"reals": 2, "apply": 7, "hvp": 13}


def _time_ms(fn, reps: int = 5, inner: int = 20) -> float:
    """Median over ``reps`` of the CUDA-event time of ``inner`` calls,
    per call."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / inner)
    times.sort()
    return times[len(times) // 2]


def _device_ms(fn, calls: int = 20) -> dict:
    """The device time of ``calls`` calls as torch.profiler (CUPTI) sees
    it, by kernel [launches recorded, ms in all], and per call: each
    kernel's mean time a launch times its launches a call (the profiler
    may drop a few events late in a long run)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    kernels = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            n, us = kernels.get(e.name[:60], (0, 0.0))
            kernels[e.name[:60]] = (n + 1, us + e.time_range.elapsed_us())
    per_call_us = sum(us / n * max(1, round(n / calls))
                      for n, us in kernels.values())
    return {"per_call_ms": per_call_us / 1000,
            "kernels": {k: [n, us / 1000] for k, (n, us) in kernels.items()}}


def _compare(name: str, got, want, atol: float = ATOL,
             rtol: float = RTOL) -> tuple:
    import torch

    err = (got - want).abs()
    bad = err > atol + rtol * want.abs()
    max_abs = float(err.max())
    max_rel = float((err / want.abs().clamp(min=1e-30)).max())
    print(f"{name}: max_abs_err={max_abs!r} max_rel_err={max_rel!r} "
          f"tolerance=|d|<={atol!r}+{rtol!r}|plain| "
          f"violations={int(bad.sum())}", flush=True)
    if not bool(torch.isfinite(got).all()) or bool(bad.any()):
        raise AssertionError(f"{name}: kernel disagrees with its plain version")
    return max_abs, max_rel


def _compare_nan(name: str, got, want) -> float:
    """NaN exactly where the plain version has it, the finite values
    within the fp32 tolerance."""
    import torch

    nan = torch.isnan(want)
    if not torch.equal(torch.isnan(got), nan):
        raise AssertionError(f"{name}: NaN pattern differs from the plain "
                             "version's")
    fin = ~nan
    err = (got[fin] - want[fin]).abs()
    bad = err > ATOL + RTOL * want[fin].abs()
    max_abs = float(err.max()) if err.numel() else 0.0
    print(f"{name}: nan={int(nan.sum())} of {want.numel()} (pattern equal) "
          f"max_abs_err={max_abs!r} violations={int(bad.sum())}", flush=True)
    if bool(bad.any()) or bool(torch.isinf(got[fin]).any()):
        raise AssertionError(f"{name}: kernel disagrees with its plain version")
    return max_abs


def _layout_bytes(L, itemsize: int) -> int:
    """Bytes of the SELL-C-σ arrays a launch reads once (int32 slice
    offsets, widths, perm and column ids; the stored values)."""
    return (4 * (L.slice_ptr.numel() + L.slice_w.numel() + L.perm.numel()
                 + L.cols.numel()) + itemsize * L.vals.numel())


def _bound(bytes_moved: int, ops: int,
           ops_per_s: float = FP32_OPS_PER_S) -> tuple:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _row(name, source, replaces, err, ms, plain_ms, bound, library_ms):
    return dict(name=name, route="cuda", source=source, replaces=replaces,
                max_abs_err=err[0], max_rel_err=err[1], ms=ms,
                plain_ms=plain_ms, bound_ms=bound[0], bound_by=bound[1],
                library_ms=library_ms)


def _print_rows(rows) -> None:
    for row in rows:
        print(f"{row['name']}: kernel_ms={row['ms']!r} "
              f"twin_ms={row['plain_ms']!r} bound_ms={row['bound_ms']!r} "
              f"({row['bound_by']}) library_ms={row['library_ms']!r}",
              flush=True)


def _inputs(n, torch):
    gen = torch.Generator(device="cuda").manual_seed(0)
    X = torch.randn((n, 4), generator=gen, device="cuda")
    U = torch.linalg.qr(torch.randn((n, 4), generator=gen, device="cuda"))[0]
    E = 0.1 * torch.randn((n, 4), generator=gen, device="cuda")
    return gen, X, U.contiguous(), E


def _repeat(name, fn) -> None:
    """Two calls of one kernel on the same inputs, equal bit for bit."""
    import torch

    if not torch.equal(fn(), fn()):
        raise AssertionError(f"{name}: two runs differ")
    print(f"{name}: two runs equal bit for bit", flush=True)


def sellcs_kernel_phase(W, K, torch) -> list:
    """Each SELL-C-σ kernel against its plain version at the main path's
    shapes: ``sellcs_spmm`` with scalar values at k = 4 and LOBPCG's 8 and
    24 (each beside ``torch.sparse.mm``) and with the graphblas HVP's
    (nnz, 4) multivalues; the apply and the HVP at k = 4.  Each kernel
    also runs twice (bit for bit) and with a NaN in one row of X, or of U
    and of E (NaN where the plain versions put it); the HVP is timed in
    both block orders."""
    n, k = W.n_rows, 4
    L = W.sell_kernel
    item = 4
    gen, X, U, E = _inputs(n, torch)
    dense_bytes = n * k * item
    src = "src/repro_torch/kernels/sellcs_spmm/csrc/sellcs_kernels.cu"
    ref = "src/repro/kernels/sellcs_spmm/sellcs_spmm.py"
    rows = []
    # a NaN in one row of X (vertex 777,777, column 2)
    Xn = X.clone()
    Xn[777777, 2] = float("nan")

    # reals ring, scalar values: the LOBPCG Laplacian matvec at every
    # width stage 1 gives it
    csr = torch.sparse_coo_tensor(
        torch.stack([W.rows.long(), W.cols.long()]), W.vals,
        (n, n)).coalesce().to_sparse_csr()
    widths = {}
    for kw in SPMM_WIDTHS:
        S = X if kw == k else torch.randn((n, kw), generator=gen,
                                          device="cuda")
        got = K.sellcs_spmm(W, S)
        err = _compare(f"sellcs_spmm k={kw}", got, K.sellcs_spmm_plain(W, S))
        _compare(f"sellcs_spmm k={kw} vs torch.sparse.mm", got,
                 torch.sparse.mm(csr, S))
        _repeat(f"sellcs_spmm k={kw}", lambda: K.sellcs_spmm(W, S))
        bound = _bound(_layout_bytes(L, item) + 2 * n * kw * item,
                       OPS["reals"] * L.slots * kw)
        widths[kw] = dict(
            max_abs_err=err[0], max_rel_err=err[1],
            plan=K.launch_plan("sellcs_spmm", n, kw, S.dtype)._asdict(),
            ms=_time_ms(lambda: K.sellcs_spmm(W, S)),
            plain_ms=_time_ms(lambda: K.sellcs_spmm_plain(W, S), 3, 3),
            bound_ms=bound[0], bound_by=bound[1],
            library_ms=_time_ms(lambda: torch.sparse.mm(csr, S)))
        print(f"sellcs_spmm k={kw}: kernel_ms={widths[kw]['ms']!r} "
              f"twin_ms={widths[kw]['plain_ms']!r} bound_ms={bound[0]!r} "
              f"({bound[1]}) library_ms={widths[kw]['library_ms']!r} "
              f"(torch.sparse.mm, CSR)", flush=True)
        del S
    _compare_nan("sellcs_spmm with a NaN in one row", K.sellcs_spmm(W, Xn),
                 K.sellcs_spmm_plain(W, Xn))
    # reals ring, (nnz, k) multivalues (the Algorithm-1 W-hat SpMM)
    mv = torch.rand((W.nnz, k), generator=gen, device="cuda")
    Wh = W.with_vals(mv)
    got_mv, want_mv = K.sellcs_spmm(Wh, X), K.sellcs_spmm_plain(Wh, X)
    err_mv = _compare("sellcs_spmm multivalue", got_mv, want_mv)
    _repeat("sellcs_spmm multivalue", lambda: K.sellcs_spmm(Wh, X))
    _compare_nan("sellcs_spmm multivalue with a NaN in one row",
                 K.sellcs_spmm(Wh, Xn), K.sellcs_spmm_plain(Wh, Xn))
    bound_mv = _bound(_layout_bytes(Wh.sell_kernel, item) + 2 * dense_bytes,
                      OPS["reals"] * L.slots * k)
    main = widths[k]
    row = _row("sellcs_spmm", src, f"{ref}:95",
               (main["max_abs_err"], main["max_rel_err"]), main["ms"],
               main["plain_ms"], (main["bound_ms"], main["bound_by"]),
               main["library_ms"])
    row["widths"] = widths
    row["multivalue"] = dict(
        max_abs_err=err_mv[0], max_rel_err=err_mv[1],
        ms=_time_ms(lambda: K.sellcs_spmm(Wh, X)),
        plain_ms=_time_ms(lambda: K.sellcs_spmm_plain(Wh, X), 3, 3),
        bound_ms=bound_mv[0], bound_by=bound_mv[1], library_ms=None)
    print(f"sellcs_spmm multivalue k=4: kernel_ms="
          f"{row['multivalue']['ms']!r} twin_ms="
          f"{row['multivalue']['plain_ms']!r} bound_ms={bound_mv[0]!r} "
          f"({bound_mv[1]})", flush=True)
    rows.append(row)
    del csr, mv, Wh

    # p-Laplacian apply (the gradient op)
    err = _compare("sellcs_plap_apply", K.sellcs_plap_apply(W, U, P, EPS),
                   K.sellcs_plap_apply_plain(W, U, P, EPS))
    _repeat("sellcs_plap_apply", lambda: K.sellcs_plap_apply(W, U, P, EPS))
    Un = U.clone()
    Un[777777, 2] = float("nan")
    _compare_nan("sellcs_plap_apply with a NaN in one row",
                 K.sellcs_plap_apply(W, Un, P, EPS),
                 K.sellcs_plap_apply_plain(W, Un, P, EPS))
    rows.append(_row(
        "sellcs_plap_apply", src, f"{ref}:109", err,
        _time_ms(lambda: K.sellcs_plap_apply(W, U, P, EPS)),
        _time_ms(lambda: K.sellcs_plap_apply_plain(W, U, P, EPS), 3, 3),
        _bound(_layout_bytes(L, item) + 2 * dense_bytes,
               OPS["apply"] * L.slots * k), None))

    # matrix-free Newton HVP (the row kernel)
    err = _compare("sellcs_plap_hvp", K.sellcs_plap_hvp(W, U, E, P, EPS),
                   K.sellcs_plap_hvp_plain(W, U, E, P, EPS))
    _repeat("sellcs_plap_hvp", lambda: K.sellcs_plap_hvp(W, U, E, P, EPS))
    # a NaN in one row of U (777,777, column 2) and one of E (555,555, 1)
    En = E.clone()
    En[555555, 1] = float("nan")
    _compare_nan("sellcs_plap_hvp with a NaN in one row of U and one of E",
                 K.sellcs_plap_hvp(W, Un, En, P, EPS),
                 K.sellcs_plap_hvp_plain(W, Un, En, P, EPS))
    del Xn, Un, En
    rows.append(_row(
        "sellcs_plap_hvp", src, f"{ref}:124", err,
        _time_ms(lambda: K.sellcs_plap_hvp(W, U, E, P, EPS)),
        _time_ms(lambda: K.sellcs_plap_hvp_plain(W, U, E, P, EPS), 3, 3),
        _bound(_layout_bytes(L, item) + 3 * dense_bytes,
               OPS["hvp"] * L.slots * k), None))
    rows[-1]["plan"] = K.launch_plan("sellcs_plap_hvp", n, k,
                                     U.dtype)._asdict()
    _print_rows(rows)
    print(f"sellcs_plap_hvp: plan={rows[-1]['plan']}", flush=True)
    return rows


def coo_sum_phase(W, KS, torch, api) -> dict:
    """The COO backend's reals SpMM with full-size W-hat multivalues, and
    ``row_sums``, each run twice: equal bit for bit (the fixed-order
    segmented sum); the sum's time beside ``index_add_``'s (atomic)."""
    from repro_torch.grblas import Descriptor

    gen = torch.Generator(device="cuda").manual_seed(5)
    X = torch.randn((W.n_rows, 4), generator=gen, device="cuda")
    Wh = W.with_vals(torch.rand((W.nnz, 4), generator=gen, device="cuda"))
    desc = Descriptor(backend="coo")
    before = KS.LAUNCHES["segment_sum"]
    _repeat("api.mxm coo W-hat multivalues",
            lambda: api.mxm(Wh, X, desc=desc))
    _repeat("row_sums", W.row_sums)
    if KS.LAUNCHES["segment_sum"] != before + 4:
        raise AssertionError("the COO sum did not run through segment_sum")
    contrib = Wh.vals * X[W.cols.long()]
    rows = W.rows.long()
    out = dict(
        segment_sum_ms=_time_ms(lambda: KS.segment_sum(
            contrib, rows, W.n_rows, W.row_ptr)),
        index_add_ms=_time_ms(lambda: torch.zeros_like(X).index_add_(
            0, rows, contrib)),
        coo_mxm_ms=_time_ms(lambda: api.mxm(Wh, X, desc=desc), 3, 5))
    print(f"coo sum: {out}", flush=True)
    del Wh, contrib, rows
    out["long_rows"] = _long_row_sum(KS, torch, gen)
    return out


def _long_row_sum(KS, torch, gen) -> dict:
    """The sum where rows hold about a thousand entries (a planted
    partition of 4 blocks of 4096 vertices, about 1000 neighbours inside
    a block and 20 outside), where one thread adds a row's entries in
    turn: by the row pointers, and by columns after a sort (the
    transposed product), each beside ``index_add_`` and the byte bound."""
    from repro_torch.graphs import sbm_graph_sparse

    S, _ = sbm_graph_sparse([4096] * 4, deg_in=1000, deg_out=20,
                            device="cuda", build_ell=False,
                            build_sellcs=False)
    n, k = S.n_rows, 4
    vals = torch.rand((S.nnz, k), generator=gen, device="cuda")
    rows, cols = S.rows.long(), S.cols.long()
    deg = S.row_ptr[1:] - S.row_ptr[:-1]
    _compare("segment_sum long rows vs index_add_",
             KS.segment_sum(vals, rows, n, S.row_ptr),
             torch.zeros((n, k), device="cuda").index_add_(0, rows, vals))
    bound = _bound(4 * S.nnz * k + 8 * (n + 1) + 4 * n * k, S.nnz * k)
    out = dict(
        n=n, nnz=S.nnz, max_row=int(deg.max()), mean_row=S.nnz / n,
        segment_sum_ms=_time_ms(lambda: KS.segment_sum(vals, rows, n,
                                                       S.row_ptr)),
        segment_sum_by_cols_ms=_time_ms(lambda: KS.segment_sum(vals, cols,
                                                               n)),
        index_add_ms=_time_ms(lambda: torch.zeros(
            (n, k), device="cuda").index_add_(0, rows, vals)),
        bound_ms=bound[0], bound_by=bound[1])
    print(f"coo sum, long rows: {out}", flush=True)
    return out


def bsr_kernel_phase(W, KB, KP, torch) -> list:
    """Each BSR kernel against its chunked plain version at full size;
    ``bsr_spmm`` at every width the main path gives it (4; LOBPCG's 8 and
    24), each beside ``torch.sparse_bsr_tensor(...) @ X``; the φ kernels
    in skip mode, in full mode and as the divergent variant."""
    n, k, item = W.n_rows, 4, 4
    nb, bs = int(W.bsr_blocks.shape[0]), W.block_size
    terms = nb * bs * bs * k     # every stored entry, every column
    # bytes a launch must move: the tiles, the int32 tile column ids and
    # row pointers, each multivector read once, the output written once
    layout = (nb * bs * bs * item + 4 * nb
              + 4 * int(W.bsr_indptr_dev.numel()))
    dense_bytes = n * k * item
    gen, X, U, E = _inputs(n, torch)
    rows = []

    n_rb = len(W.bsr_indptr) - 1
    n_cb = -(-W.n_cols // bs)
    lib = torch.sparse_bsr_tensor(W.bsr_indptr_dev, W.bsr_indices,
                                  W.bsr_blocks, (n_rb * bs, n_cb * bs))
    widths = {}
    for kw in SPMM_WIDTHS:
        S = X if kw == k else torch.randn((n, kw), generator=gen,
                                          device="cuda")
        got = KB.bsr_spmm(W, S)
        err = _compare(f"bsr_spmm k={kw}", got, KB.bsr_spmm_plain(W, S))
        Sp = torch.nn.functional.pad(S, (0, 0, 0, n_cb * bs - n))
        _compare(f"bsr_spmm k={kw} vs torch.sparse_bsr_tensor @ X", got,
                 (lib @ Sp)[:n])
        if not torch.equal(got, KB.bsr_spmm(W, S)):
            raise AssertionError(f"bsr_spmm k={kw}: two runs differ")
        bound = _bound(layout + 2 * n * kw * item,
                       OPS["reals"] * nb * bs * bs * kw)
        widths[kw] = dict(
            max_abs_err=err[0], max_rel_err=err[1],
            ms=_time_ms(lambda: KB.bsr_spmm(W, S)),
            plain_ms=_time_ms(lambda: KB.bsr_spmm_plain(W, S), 3, 3),
            bound_ms=bound[0], bound_by=bound[1],
            library_ms=_time_ms(lambda: lib @ Sp))
        print(f"bsr_spmm k={kw}: kernel_ms={widths[kw]['ms']!r} "
              f"twin_ms={widths[kw]['plain_ms']!r} "
              f"bound_ms={bound[0]!r} ({bound[1]}) "
              f"library_ms={widths[kw]['library_ms']!r} "
              f"(torch.sparse_bsr_tensor @ X)", flush=True)
        del S, Sp
    # the row's own numbers at LOBPCG's widest block, where stage 1
    # spends the most; every width beside them
    main = widths[max(SPMM_WIDTHS)]
    rows.append(_row(
        "bsr_spmm", "src/repro_torch/kernels/bsr_spmm/csrc/bsr_spmm.cu",
        "src/repro/kernels/bsr_spmm/bsr_spmm.py:46",
        (main["max_abs_err"], main["max_rel_err"]), main["ms"],
        main["plain_ms"], (main["bound_ms"], main["bound_by"]),
        main["library_ms"]))
    rows[-1]["k"] = max(SPMM_WIDTHS)
    rows[-1]["widths"] = widths
    del lib

    src = "src/repro_torch/kernels/plap_edge/csrc/plap_edge.cu"
    ref = "src/repro/kernels/plap_edge/plap_edge.py"
    nnz_stored = int(torch.count_nonzero(W.bsr_blocks))
    print(f"phi kernels: stored entries={nb * bs * bs} non-zero={nnz_stored}"
          f" zero_share={1 - nnz_stored / (nb * bs * bs)!r} "
          f"non_zeros_per_tile={nnz_stored / nb!r}", flush=True)
    # skip mode evaluates phi on the non-zero terms only: the operation
    # bound counts those (each stored value is still read once)
    nz_terms = nnz_stored * k
    calls = {"plap_apply": lambda Z: KP.plap_apply(W, Z, P, EPS),
             "plap_hvp": lambda Z: KP.plap_hvp(W, Z, E, P, EPS)}
    plains = {"plap_apply": lambda Z: KP.plap_apply_plain(W, Z, P, EPS),
              "plap_hvp": lambda Z: KP.plap_hvp_plain(W, Z, E, P, EPS)}
    dense = {"plap_apply": 2 * dense_bytes, "plap_hvp": 3 * dense_bytes}
    line = {"plap_apply": 76, "plap_hvp": 96}
    # a NaN in one row-block of U (vertex 777,777, column 2)
    Un = U.clone()
    Un[777777, 2] = float("nan")
    for name in ("plap_apply", "plap_hvp"):
        mode = KP.phi_mode(name, P, EPS, U.dtype)
        if mode != "skip":
            raise AssertionError(f"{name}: the main path's call is routed to "
                                 f"{mode}, not skip")
        got = calls[name](U)
        err = _compare(name, got, plains[name](U))
        if not torch.equal(got, calls[name](U)):
            raise AssertionError(f"{name}: two runs differ")
        _compare_nan(f"{name} with a NaN in one row-block", calls[name](Un),
                     plains[name](Un))
        op = name.split("_")[1]
        rows.append(_row(
            name, src, f"{ref}:{line[name]}", err, _time_ms(
                lambda: calls[name](U)),
            _time_ms(lambda: plains[name](U), 3, 1),
            _bound(layout + dense[name], OPS[op] * nz_terms), None))
        rows[-1].update(mode="skip", bound_ops="non-zero terms")
        # the divergent variant: the same skeleton, no compaction
        div = KP.run_divergent(name, W, U, E, P, EPS)
        div_err = _compare(f"{name} divergent variant", div, plains[name](U))
        rows[-1]["divergent"] = dict(
            ms=_time_ms(lambda: KP.run_divergent(name, W, U, E, P, EPS), 3,
                        5), max_abs_err=div_err[0])
    del Un
    # full mode: plap_hvp at eps = 0, every entry evaluated
    if KP.phi_mode("plap_hvp", P, 0.0, U.dtype) != "full":
        raise AssertionError("plap_hvp at eps = 0 is not routed to full mode")
    full_err = _compare_nan("plap_hvp eps=0 (full mode)",
                            KP.plap_hvp(W, U, E, P, 0.0),
                            KP.plap_hvp_plain(W, U, E, P, 0.0))
    full_bound = _bound(layout + dense["plap_hvp"], OPS["hvp"] * terms)
    rows[-1]["full_mode"] = dict(
        eps=0.0, max_abs_err=full_err,
        ms=_time_ms(lambda: KP.plap_hvp(W, U, E, P, 0.0), 3, 3),
        plain_ms=_time_ms(lambda: KP.plap_hvp_plain(W, U, E, P, 0.0), 3, 1),
        bound_ms=full_bound[0], bound_by=full_bound[1],
        bound_ops="every stored entry")
    _print_rows(rows)
    for row in rows[-2:]:
        print(f"{row['name']}: divergent variant ms="
              f"{row['divergent']['ms']!r}", flush=True)
    print(f"plap_hvp full mode (eps=0): {rows[-1]['full_mode']}", flush=True)
    return rows


def _orthonormality(U, torch) -> float:
    G = U.T @ U
    return float((G - torch.eye(G.shape[0], device=G.device)).abs().max())


def solve_phase(tag, W, counters, torch, psc, cfg, used) -> tuple:
    """One p_spectral_cluster run from zeroed launch counts; returns
    (counts, result)."""
    for K in counters:
        K.reset_launch_counts()
    t0 = time.perf_counter()
    res = psc.p_spectral_cluster(W, cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: c for K in counters for name, c in K.LAUNCHES.items()}
    launches["bsr_spmm_by_width"] = {
        kw: c for K in counters
        for kw, c in getattr(K, "LAUNCHES_BY_WIDTH", {}).items()}
    launches["sellcs_spmm_by_shape"] = {
        shape: c for K in counters
        for shape, c in getattr(K, "LAUNCHES_BY_SHAPE", {}).items()}
    orth = _orthonormality(res.U, torch)
    print(f"{tag}: wall_s={wall!r} stage_s={res.stage_seconds} "
          f"init_rcut={res.init_rcut!r} rcut={res.rcut!r} ncut={res.ncut!r} "
          f"p_path={res.p_path} hvp_counts={res.hvp_counts} "
          f"fvals={res.fvals} launches={launches} "
          f"max|U^T U - I|={orth!r}", flush=True)
    for name in used:
        if launches[name] < 1:
            raise AssertionError(f"{tag}: {name} never launched")
    for name in ("plap_apply", "plap_hvp"):
        for mode in ("full", "divergent"):
            key = f"{name}_{mode}"
            if launches[key]:
                raise AssertionError(f"{tag}: {launches[key]} φ launches "
                                     f"in {mode} mode ({key})")
    if not (math.isfinite(res.rcut) and bool(torch.isfinite(res.U).all())):
        raise AssertionError(f"{tag}: non-finite output (rcut {res.rcut})")
    if not orth <= 1e-4:
        raise AssertionError(f"{tag}: U^T U off identity by {orth}")
    if len(np.unique(res.labels)) != cfg.k:
        raise AssertionError(f"{tag}: labels use {len(np.unique(res.labels))}"
                             f" of {cfg.k} clusters")
    return launches, res


def flat_phase(tag, W, counters, torch, psc, backend, mode, used,
               args) -> tuple:
    """A flat solve, also held to RCut <= 1.01 x the p=2 start's."""
    cfg = psc.PSCConfig(k=4, backend=backend, hvp_mode=mode,
                        newton_iters=args.newton_iters,
                        tcg_iters=args.tcg_iters)
    launches, res = solve_phase(f"{tag}[{mode}]", W, counters, torch, psc,
                                cfg, used)
    if not res.rcut <= res.init_rcut * 1.01 + 1e-9:
        raise AssertionError(f"{tag}[{mode}]: rcut {res.rcut} above "
                             f"1.01 x init_rcut {res.init_rcut}")
    return launches, res


def breakdown_phase(tag, W, torch, backend: str, mode: str, U) -> None:
    """Host ms of the trust-region callbacks at U, and where the device
    time of a window of Hessian applies goes."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import plap
    from repro_torch.core.grassmann import proj
    from repro_torch.grblas import Descriptor

    desc = Descriptor(backend=backend)
    tag = f"{tag}[{mode}]"
    gen = torch.Generator(device="cuda").manual_seed(1)
    eta = proj(U, 1e-3 * torch.randn(U.shape, generator=gen, device="cuda"))
    hvp = {"graphblas": plap.hess_eta_graphblas,
           "matrix_free": plap.hess_eta_matrix_free}[mode]
    calls = {"value": lambda: plap.value(W, U, P, EPS, desc=desc),
             "euc_grad": lambda: plap.euc_grad(W, U, P, EPS, desc=desc),
             "hvp": lambda: hvp(W, U, eta, P, EPS, desc=desc)}
    host = {}
    for name, fn in calls.items():
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(10):
            fn()
        torch.cuda.synchronize()
        host[name] = (time.perf_counter() - t0) * 100.0     # ms per call
    print(f"{tag}: host_ms_per_call={host}", flush=True)

    reps = 5
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            calls["hvp"]()
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    print(f"{tag}: hvp window {reps} calls wall_ms={window_ms!r} "
          f"device_ms={device_ms!r} busy_share={device_ms / window_ms!r} "
          f"kernel_launches={sum(e.count for e in kernels)}", flush=True)
    kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
    for e in kernels[:8]:
        print(f"{tag}:   {e.self_device_time_total / 1e3 / reps!r}"
              f" ms/hvp x{e.count / reps} {e.key[:90]}", flush=True)


def multilevel_phase(W, counters, torch, psc, flat_rcut, args) -> dict:
    from repro_torch.multilevel import MultilevelConfig

    cfg = psc.PSCConfig(k=4, backend="edge_pallas", hvp_mode="matrix_free",
                        newton_iters=args.newton_iters,
                        tcg_iters=args.tcg_iters,
                        multilevel=MultilevelConfig())
    launches, res = solve_phase("multilevel[matrix_free]", W, counters,
                                torch, psc, cfg,
                                ["plap_apply", "plap_hvp", "kmeans_assign"])
    if not res.hierarchy or len(res.hierarchy) < 2:
        raise AssertionError("multilevel: the graph was not coarsened")
    for lev in res.hierarchy:
        print(f"multilevel: level {lev['level']} n={lev['n']} "
              f"nnz={lev['nnz']} bsr_tiles={lev['bsr_tiles']}", flush=True)
    refined = sorted({r["level"] for r in res.levels})
    print(f"multilevel: refined_levels={refined} "
          f"total_s={sum(res.stage_seconds.values())!r} "
          f"rcut_over_flat_bsr={res.rcut / flat_rcut!r} (recorded, not "
          f"asserted)", flush=True)
    return launches


def _visible_pairs(S: int, window) -> int:
    """(query, key) pairs the causal and window masks leave, Sq = Sk = S."""
    i = np.arange(S)
    lo = np.maximum(i - window + 1, 0) if window else np.zeros(S, int)
    return int(np.sum(i - lo + 1))


def _compare_bf16(name, got, ref32, torch) -> tuple:
    """The bf16 kernel against fp32 math on the same bf16 inputs:
    |d| <= 2^-6 (1 + |ref|) at every element."""
    err = (got.float() - ref32).abs()
    scaled = float((err / (1 + ref32.abs())).max())
    max_abs = float(err.max())
    print(f"{name}: max_abs_err={max_abs!r} max_err/(1+|ref|)={scaled!r} "
          f"tolerance={BF16_TOL}", flush=True)
    if not bool(torch.isfinite(got).all()) or not scaled <= BF16_TOL:
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             "version")
    return max_abs, scaled


def flash_kernel_phase(torch) -> dict:
    """Flash attention against its plain version at the serve shape and
    three variants (all on the wgmma kernel), then the mma.sync and fp32
    kernels at shapes routed to them; returns the row of the kernel the
    serve path runs."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as KF

    gen = torch.Generator(device="cuda").manual_seed(2)
    shapes = [  # (tag, B, Hq, Hkv, S, D, window, dtype)
        ("serve", 4, 8, 1, 2048, 256, None, torch.bfloat16),
        ("ragged_S1000", 4, 8, 1, 1000, 256, None, torch.bfloat16),
        ("window512", 4, 8, 1, 2048, 256, 512, torch.bfloat16),
        ("D128_group4", 4, 8, 2, 2048, 128, None, torch.bfloat16),
        # the kernels of the other routes: a head dim off wgmma's (the
        # reduced test configs' 16 and 32), and fp32
        ("mma_D32", 4, 8, 2, 2048, 32, None, torch.bfloat16),
        ("f32_D128", 1, 8, 2, 2048, 128, None, torch.float32)]
    out = []
    for tag, B, Hq, Hkv, S, D, window, dtype in shapes:
        q, k, v = (torch.randn(shape, generator=gen, device="cuda",
                               dtype=dtype)
                   for shape in ((B, Hq, S, D), (B, Hkv, S, D),
                                 (B, Hkv, S, D)))
        variant = KF.kernel_variant(dtype, D, S)
        name = f"flash_attention_{variant}"
        before = KF.LAUNCHES[name]
        got = KF.flash_attention(q, k, v, causal=True, window=window)
        if KF.LAUNCHES[name] != before + 1:
            raise AssertionError(f"flash_attention[{tag}]: {name} did not "
                                 "launch")
        ref32 = KF.attention_ref(q.float(), k.float(), v.float(),
                                 causal=True, window=window)
        if dtype == torch.float32:
            err = _compare(f"flash_attention[{tag}] ({variant})", got, ref32)
        else:
            err = _compare_bf16(f"flash_attention[{tag}] ({variant})", got,
                                ref32, torch)
        plain = KF.plain_attention(q, k, v, causal=True, window=window)
        err_plain = float((got.float() - plain.float()).abs().max())
        del ref32, plain
        if window is None:
            lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                q, k, v, is_causal=True, enable_gqa=True)
        else:
            i = torch.arange(S, device="cuda")
            mask = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None]
                                                 - window)
            lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                q, k, v, attn_mask=mask, enable_gqa=True)
        item = q.element_size()
        nbytes = item * (2 * q.numel() + k.numel() + v.numel())
        flops = 4 * B * Hq * D * _visible_pairs(S, window)
        bound = _bound(nbytes, flops, BF16_OPS_PER_S
                       if dtype == torch.bfloat16 else FP32_OPS_PER_S)
        row = dict(shape=dict(B=B, Hq=Hq, Hkv=Hkv, S=S, D=D, window=window,
                              dtype=str(dtype).split(".")[-1], causal=True),
                   variant=variant, max_abs_err=err[0], max_rel_err=err[1],
                   max_abs_err_vs_plain=err_plain,
                   ms=_time_ms(lambda: KF.flash_attention(
                       q, k, v, causal=True, window=window)),
                   plain_ms=_time_ms(lambda: KF.plain_attention(
                       q, k, v, causal=True, window=window), 3, 3),
                   bound_ms=bound[0], bound_by=bound[1], gflop=flops / 1e9,
                   library_ms=_time_ms(lib))
        print(f"flash_attention[{tag}]: kernel={variant} "
              f"kernel_ms={row['ms']!r} plain_ms={row['plain_ms']!r} "
              f"bound_ms={row['bound_ms']!r} ({row['bound_by']}, "
              f"{row['gflop']!r} GFLOP) sdpa_ms={row['library_ms']!r} "
              f"|kernel-plain|={err_plain!r}", flush=True)
        out.append((tag, row))
        del q, k, v
    serve = out[0][1]
    row = _row("flash_attention",
               "src/repro_torch/kernels/flash_attention/csrc/"
               "flash_attention_wgmma.cu",
               "src/repro/kernels/flash_attention/flash_attention.py:74",
               (serve["max_abs_err"], serve["max_rel_err"]), serve["ms"],
               serve["plain_ms"], (serve["bound_ms"], serve["bound_by"]),
               serve["library_ms"])
    # the serve path's kernel; its launches are read from this counter
    row["counter"] = "flash_attention_wgmma"
    row["shape"] = serve["shape"]
    row["variants"] = {tag: r for tag, r in out[1:]}
    return row


def kmeans_kernel_phase(U, torch, psc) -> dict:
    """kmeans_assign on the stage-3 input with 8 kmeans++ restarts, and
    stage 3 through the plain assignment and through the kernel."""
    from unittest import mock

    from repro_torch.core import kmeans as KM
    from repro_torch.kernels import kmeans_assign as KK

    # contiguous: stage 3's X keeps U's column-major layout (stage 3
    # measured 2-4% faster so than on one contiguous copy of X), and
    # ``ops.kmeans_assign`` copies it before each launch; the kernel is
    # timed on the copy
    X = (U / torch.clamp(torch.linalg.norm(U, dim=1, keepdim=True),
                         min=1e-12)).contiguous()
    gen = torch.Generator(device="cuda").manual_seed(3)
    C = KM._plusplus_init(gen, X, U.shape[1], 8)            # (8, 4, 4)
    lab, dist = KK.kmeans_assign(X, C)
    want_lab, want_dist = KK.kmeans_assign_ref(X, C)
    err = _compare("kmeans_assign", dist, want_dist)
    scale = float((X * X).sum(1).max() + (C * C).sum(-1).max())
    top2 = KK.pairwise_sqdist(X, C).topk(2, dim=-1, largest=False).values
    tie = (top2[..., 1] - top2[..., 0]) <= 16 * 2.0 ** -23 * scale
    diff = lab != want_lab
    print(f"kmeans_assign: label differences={int(diff.sum())} (at ties "
          f"{int((diff & tie).sum())}) of {lab.numel()}", flush=True)
    if bool((diff & ~tie).any()):
        raise AssertionError("kmeans_assign: labels differ off a tie")
    _repeat("kmeans_assign", lambda: torch.cat(
        [t.view(-1).double() for t in KK.kmeans_assign(X, C)]))
    _sets_alone(KK, X, C, lab, dist, "kmeans_assign", torch)
    R, n, kc, d = C.shape[0], X.shape[0], C.shape[1], X.shape[1]
    nbytes = 4 * (X.numel() + C.numel() + 2 * R * n)
    ops = R * n * kc * (2 * d + 4) + 2 * n * d
    row = _row("kmeans_assign",
               "src/repro_torch/kernels/kmeans_assign/csrc/kmeans_assign.cu",
               "src/repro/kernels/kmeans_assign/kmeans_assign.py:35", err,
               _time_ms(lambda: KK.kmeans_assign(X, C)),
               _time_ms(lambda: KK.kmeans_assign_ref(X, C), 3, 5),
               _bound(nbytes, ops), None)
    # distances near 0 make |d| / |plain| meaningless: the error relative
    # to the largest term the identity cancels instead
    row["max_rel_err"] = err[0] / scale
    # the kernels' own time, without the wrapper's host work
    row["device_ms"] = _device_ms(lambda: KK.kmeans_assign(X, C))
    row["shape"] = dict(n=n, d=d, restarts=R, kc=kc, dtype="float32")
    row["plan"] = KK.launch_plan(R, kc, d, X.element_size())
    _print_rows([row])
    print(f"kmeans_assign: device_ms={row['device_ms']}", flush=True)

    def stage3():
        t0 = time.perf_counter()
        psc.discretize(U, kc, torch.Generator(device="cuda").manual_seed(4))
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    plain = mock.patch.object(KM, "kmeans_assign", KK.kmeans_assign_ref)
    seconds = {"plain": [], "kernel": []}
    for which in ("plain", "kernel", "kernel", "plain"):
        if which == "plain":
            with plain:
                seconds[which].append(stage3())
        else:
            seconds[which].append(stage3())
    row["stage3_s"] = seconds
    print(f"stage 3 (discretize, 8 restarts x 50 Lloyd steps) seconds: "
          f"{seconds}", flush=True)
    return row


def _sets_alone(KK, X, C, lab, dist, tag, torch) -> None:
    """The first and the last set taken alone give the batch's result
    bit for bit."""
    for r in (0, C.shape[0] - 1):
        lab1, dist1 = KK.kmeans_assign(X, C[r])
        if not (torch.equal(lab1, lab[r]) and torch.equal(dist1, dist[r])):
            raise AssertionError(f"{tag}: set {r} alone differs from the "
                                 "batch")
    print(f"{tag}: sets alone equal to the batch bit for bit", flush=True)


def kmeans_large_k_phase(torch, psc) -> dict:
    """Stage 3's assignment on the tiled variant: k = 48 in fp64 and
    k = 70 in fp32 (one launch for the 8 restarts each), on 2^20
    row-normalized points with 8 kmeans++ restarts, held against the
    plain version; then stage 3 (``psc.discretize``) at each k from
    zeroed counts, every assignment through the kernels."""
    from repro_torch.core import kmeans as KM
    from repro_torch.kernels import kmeans_assign as KK

    out = {}
    n, R = 1 << 20, 8
    for k, dtype in ((48, torch.float64), (70, torch.float32)):
        tag = f"kmeans_assign k={k} {str(dtype).split('.')[-1]}"
        gen = torch.Generator(device="cuda").manual_seed(k)
        U = torch.randn((n, k), generator=gen, device="cuda", dtype=dtype)
        X = U / torch.linalg.norm(U, dim=1, keepdim=True)
        C = KM._plusplus_init(gen, X, k, R)
        plan = KK.launch_plan(R, k, k, X.element_size())
        KK.reset_launch_counts()
        lab, dist = KK.kmeans_assign(X, C)
        launches = dict(KK.LAUNCHES)
        want_lab, want_dist = KK.kmeans_assign_ref(X, C)
        eps = torch.finfo(dtype).eps
        scale = float((X * X).sum(1).max() + (C * C).sum(-1).max())
        # 8 ulps of the largest term the distance identity cancels, in
        # this dtype (the cuda tests' limit)
        err = _compare(tag, dist, want_dist, atol=8 * eps * scale, rtol=0.0)
        top2 = KK.pairwise_sqdist(X, C).topk(2, dim=-1, largest=False).values
        tie = (top2[..., 1] - top2[..., 0]) <= 16 * eps * scale
        diff = lab != want_lab
        print(f"{tag}: plan={plan} launches={launches} label differences="
              f"{int(diff.sum())} (at ties {int((diff & tie).sum())}) of "
              f"{lab.numel()}", flush=True)
        if bool((diff & ~tie).any()):
            raise AssertionError(f"{tag}: labels differ off a tie")
        for variant, name in (("narrow", "kmeans_assign"),
                              ("tiled", "kmeans_assign_tiled")):
            if launches[name] != sum(v == variant for v, _, _ in plan):
                raise AssertionError(f"{tag}: {name} launched "
                                     f"{launches[name]} times, plan {plan}")
        del top2, tie, diff, want_lab, want_dist
        _repeat(tag, lambda: torch.cat(
            [t.view(-1).to(dtype) for t in KK.kmeans_assign(X, C)]))
        _sets_alone(KK, X, C, lab, dist, tag, torch)
        item = X.element_size()
        nbytes = item * (X.numel() + C.numel() + R * n) + 4 * R * n
        ops = R * n * k * (2 * k + 4) + 2 * n * k
        bound = _bound(nbytes, ops, FP64_OPS_PER_S
                       if dtype == torch.float64 else FP32_OPS_PER_S)
        entry = dict(
            shape=dict(n=n, d=k, restarts=R, kc=k,
                       dtype=str(dtype).split(".")[-1]),
            variant=plan[0][0], launches_per_assignment=len(plan),
            max_abs_err=err[0], max_rel_err=err[0] / scale,
            ms=_time_ms(lambda: KK.kmeans_assign(X, C)),
            plain_ms=_time_ms(lambda: KK.kmeans_assign_ref(X, C), 3, 2),
            bound_ms=bound[0], bound_by=bound[1], library_ms=None,
            device_ms=_device_ms(lambda: KK.kmeans_assign(X, C)))
        print(f"{tag}: kernel_ms={entry['ms']!r} twin_ms="
              f"{entry['plain_ms']!r} bound_ms={bound[0]!r} ({bound[1]}) "
              f"device_ms={entry['device_ms']}", flush=True)
        # stage 3 at this k, every assignment through the kernels
        KK.reset_launch_counts()
        t0 = time.perf_counter()
        labels = psc.discretize(U, k, torch.Generator(device="cuda")
                                .manual_seed(6))
        torch.cuda.synchronize()
        entry["stage3_s"] = time.perf_counter() - t0
        entry["stage3_launches"] = dict(KK.LAUNCHES)
        used = "kmeans_assign_tiled" if plan[0][0] == "tiled" \
            else "kmeans_assign"
        if KK.LAUNCHES[used] < (k - 1) + 51 or \
                sum(KK.LAUNCHES.values()) != KK.LAUNCHES[used]:
            raise AssertionError(f"{tag}: stage 3 launches "
                                 f"{entry['stage3_launches']}")
        if not (labels.shape == (n,) and int(labels.min()) >= 0
                and int(labels.max()) < k):
            raise AssertionError(f"{tag}: stage 3 labels out of range")
        print(f"{tag}: stage 3 (discretize) s={entry['stage3_s']!r} "
              f"launches={entry['stage3_launches']}", flush=True)
        out[f"k{k}_{entry['shape']['dtype']}"] = entry
        del U, X, C, lab, dist, labels
    torch.cuda.empty_cache()
    return out


def bsr_large_tile_phase(coo, shape, torch, api) -> dict:
    """The triangulation as BSR with 256 x 256 tiles and COO only: the BSR
    kernels take tiles of at most 128, so ``auto`` runs the reals SpMM and
    the p-Laplacian apply on ``coo``, and they match the BSR plain
    versions; a named ``bsr_pallas`` or ``edge_pallas`` raises
    BackendUnavailableError."""
    from repro_torch.grblas import (BackendUnavailableError, Descriptor,
                                    SparseMatrix, plap_edge_semiring,
                                    reals_ring)
    from repro_torch.grblas import backends as BE
    from repro_torch.kernels import bsr_spmm as KB
    from repro_torch.kernels import plap_edge as KP

    W = SparseMatrix.from_coo(*coo, shape, build_ell=False,
                              build_sellcs=False, build_bsr=True,
                              block_size=256, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(7)
    X = torch.randn((W.n_rows, 4), generator=gen, device="cuda")
    ring = plap_edge_semiring(P, EPS)
    chosen = {"reals": BE.select_backend(W, X, reals_ring,
                                         Descriptor()).name,
              "plap_apply": BE.select_backend(W, X, ring,
                                              Descriptor()).name}
    if chosen != {"reals": "coo", "plap_apply": "coo"}:
        raise AssertionError(f"bsr block 256: auto chose {chosen}")
    err = _compare("bsr block 256 api.mxm (auto -> coo) vs bsr_spmm_plain",
                   api.mxm(W, X), KB.bsr_spmm_plain(W, X))
    err_a = _compare("bsr block 256 api.mxm plap_apply (auto -> coo) vs "
                     "plap_apply_plain", api.mxm(W, X, ring),
                     KP.plap_apply_plain(W, X, P, EPS))
    for name, r in (("bsr_pallas", reals_ring), ("edge_pallas", ring)):
        try:
            api.mxm(W, X, r, desc=Descriptor(backend=name))
        except BackendUnavailableError as e:
            print(f"bsr block 256: named {name} raises "
                  f"BackendUnavailableError ({str(e)[:60]}...)", flush=True)
        else:
            raise AssertionError(f"bsr block 256: named {name} ran")
    out = dict(n_blocks=int(W.bsr_blocks.shape[0]), chosen=chosen,
               max_abs_err=err[0], max_abs_err_apply=err_a[0])
    print(f"bsr block 256: {out}", flush=True)
    del W
    torch.cuda.empty_cache()
    return out


def _profile(tag, fn, torch, reps: int) -> None:
    """Device busy share of ``reps`` calls and the kernels that take the
    most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with torch.no_grad():
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            window_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    print(f"{tag}: {reps} calls wall_ms={window_ms!r} device_ms={device_ms!r}"
          f" busy_share={device_ms / window_ms!r} "
          f"kernel_launches={sum(e.count for e in kernels)}", flush=True)
    kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
    for e in kernels[:8]:
        print(f"{tag}:   {e.self_device_time_total / 1e3 / reps!r} ms/call "
              f"x{e.count / reps} {e.key[:90]}", flush=True)


def lm_serve_phase(torch, counters) -> tuple:
    """Gemma-2B at full width through the ServeEngine; returns (launch
    counts of the served run, summary)."""
    from unittest import mock

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as KF
    from repro_torch.models import attention as ATT
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    from repro_torch.serve import GenerationConfig, ServeEngine

    cfg = get_config("gemma-2b")
    B, S, new = 4, 2048, 32
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = M.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    print(f"lm_serve: {cfg.name} n_layers={cfg.n_layers} "
          f"d_model={cfg.d_model} heads={cfg.n_heads}/{cfg.n_kv_heads} "
          f"head_dim={cfg.resolved_head_dim} d_ff={cfg.d_ff} "
          f"vocab={cfg.padded_vocab} params={n_params} "
          f"({cfg.params_dtype}, compute {cfg.compute_dtype}) "
          f"init_s={time.perf_counter() - t0!r}", flush=True)
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab, (B, S)).astype(np.int32)
    engine = ServeEngine(cfg, params, max_len=S + new)
    engine.generate(prompts, GenerationConfig(max_new_tokens=2))  # warm-up
    for K in counters:
        K.reset_launch_counts()
    t0 = time.perf_counter()
    out = engine.generate(prompts, GenerationConfig(max_new_tokens=new))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: c for K in counters for name, c in K.LAUNCHES.items()}
    t = engine.timing
    summary = dict(
        requests=B, prompt_len=S, new_tokens=new, generated=int(out.size),
        wall_s=wall, prefill_s=t["prefill_s"],
        decode_ms_per_token=t["decode_s"] / t["decode_steps"] * 1e3,
        decode_steps=t["decode_steps"], tokens_per_s=out.size / wall,
        prompt_tokens_per_s=B * S / t["prefill_s"],
        peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
        flash_launches=launches["flash_attention_wgmma"])
    print(f"lm_serve: {summary}", flush=True)
    print(f"lm_serve: first request's tokens {out[0].tolist()}", flush=True)
    if launches["flash_attention_wgmma"] != cfg.n_layers:
        raise AssertionError(f"lm_serve: {launches['flash_attention_wgmma']}"
                             f" launches of the wgmma flash kernel, not "
                             f"{cfg.n_layers}")
    if not ((out >= 0) & (out < cfg.vocab)).all():
        raise AssertionError("lm_serve: token ids out of the vocabulary")

    def rel(a, b):
        return float((a.float() - b.float()).norm() / b.float().norm())

    tok = torch.as_tensor(prompts, device="cuda")
    with torch.no_grad():
        lk, cache, pos = M.prefill(cfg, params, tok, S + new)
        with mock.patch.object(ATT, "flash_attention", KF.plain_attention):
            lp, _, _ = M.prefill(cfg, params, tok, S + new)
        nxt = torch.argmax(lk[:, -1], dim=-1)[:, None].to(torch.int32)
        ld, _ = M.decode_step(cfg, params, cache, nxt, torch.full(
            (B, 1), pos, dtype=torch.int32, device="cuda"))
        x, _ = M.forward_train(cfg, params, torch.cat([tok, nxt], dim=1))
        lf = L.unembed_logits(params["embed"], x[:, -1:],
                              real_vocab=cfg.vocab)
    checks = dict(
        prefill_rel_err_kernel_vs_plain=rel(lk, lp),
        prefill_argmax_equal=int((lk.argmax(-1) == lp.argmax(-1)).sum()),
        decode_rel_err_vs_full_forward=rel(ld, lf),
        decode_argmax_equal=int((ld.argmax(-1) == lf.argmax(-1)).sum()),
        tolerance=LM_TOL, logits_finite=bool(torch.isfinite(lk).all()
                                             and torch.isfinite(ld).all()))
    summary.update(checks)
    print(f"lm_serve checks: {checks}", flush=True)
    if not (checks["logits_finite"]
            and checks["prefill_rel_err_kernel_vs_plain"] <= LM_TOL
            and checks["decode_rel_err_vs_full_forward"] <= LM_TOL):
        raise AssertionError("lm_serve: logits off their plain versions")
    positions = torch.full((B, 1), pos, dtype=torch.int32, device="cuda")
    _profile("lm_serve decode step", lambda: M.decode_step(
        cfg, params, cache, nxt, positions), torch, reps=3)
    _profile("lm_serve prefill", lambda: M.prefill(
        cfg, params, tok, S + new), torch, reps=1)
    del params, engine, cache
    torch.cuda.empty_cache()
    return launches, summary


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def _digest(out) -> str:
    """A digest of the bytes of a tensor or a tuple of tensors: equal
    digests, equal bits."""
    h = hashlib.sha1()
    for t in out if isinstance(out, tuple) else (out,):
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def _ab_line(src: Path, calls: dict, device: bool = False) -> None:
    """One JSON line: each call's time (CUDA events) and the digest of
    its output; ``device``: also its device time by the profiler."""
    line = {"src": str(src), "card": _card(),
            "ms": {name: _time_ms(fn) for name, fn in calls.items()},
            "digest": {name: _digest(fn()) for name, fn in calls.items()}}
    if device:
        line["device_ms"] = {name: _device_ms(fn)
                             for name, fn in calls.items()}
    print(json.dumps(line), flush=True)


def sellcs_times(src: Path, torch) -> int:
    """``--sellcs-src``: time the SELL-C-σ kernels of the tree at ``src``
    (its ``repro_torch`` imported and built) at the main path's shapes on
    ``delaunay_graph(20)``, with the inputs and timer of the full run,
    and print one JSON line with the card's name and power limit."""
    sys.path.insert(0, str(src.resolve()))
    from repro_torch.graphs import delaunay_graph
    from repro_torch.kernels import sellcs_spmm as K

    K.build()
    W, _ = delaunay_graph(GRAPH_R, device="cuda", build_sellcs=True,
                          sell_c=32)
    gen, X, U, E = _inputs(W.n_rows, torch)
    Xs = {kw: X if kw == 4 else torch.randn((W.n_rows, kw), generator=gen,
                                            device="cuda")
          for kw in SPMM_WIDTHS}
    Wh = W.with_vals(torch.rand((W.nnz, 4), generator=gen, device="cuda"))
    calls = {f"sellcs_spmm scalar k={kw}": (lambda S=S: K.sellcs_spmm(W, S))
             for kw, S in Xs.items()}
    calls["sellcs_spmm multivalue k=4"] = lambda: K.sellcs_spmm(Wh, X)
    calls["sellcs_plap_apply k=4"] = lambda: K.sellcs_plap_apply(
        W, U, P, EPS)
    calls["sellcs_plap_hvp k=4"] = lambda: K.sellcs_plap_hvp(
        W, U, E, P, EPS)
    _ab_line(src, calls)
    return 0


# --kmeans-src shapes (k, dtype): the main path's, stage 3's at k = 48
# fp64 and k = 70 fp32, and k about the narrow variant's widest row
KMEANS_AB = [(4, "float32"), (48, "float64"), (70, "float32")] + [
    (k, dt) for dt in ("float32", "float64") for k in (16, 17, 24, 32)]


def kmeans_times(src: Path, torch) -> int:
    """``--kmeans-src``: time ``kmeans_assign`` of the tree at ``src`` at
    the shapes of ``KMEANS_AB`` (2^20 x k, 8 sets of k centroids), on
    row-normalized points with centroids drawn from them, by CUDA events
    and by the profiler's device time; where the tree has the tiled
    variant, also that variant alone at k <= 16; then stage 3 at k = 4
    (on a column-major U), 48 and 70.  Prints one JSON line of times and
    one of stage 3 seconds."""
    sys.path.insert(0, str(src.resolve()))
    from repro_torch.core import psc
    from repro_torch.kernels import kmeans_assign as KK

    KK.build()
    tiled = getattr(KK, "kmeans_assign_tiled_cuda", None)
    calls, stage3_s = {}, {}
    for k, name in KMEANS_AB:
        dtype = getattr(torch, name)
        tag = f"k={k} {str(dtype).split('.')[-1]}"
        gen = torch.Generator(device="cuda").manual_seed(k)
        X = torch.randn((1 << 20, k), generator=gen, device="cuda",
                        dtype=dtype)
        X /= torch.linalg.norm(X, dim=1, keepdim=True)
        C = X[torch.randint(0, X.shape[0], (8, k), generator=gen,
                            device="cuda")].contiguous()
        calls[f"kmeans_assign {tag}"] = (
            lambda X=X, C=C: KK.kmeans_assign(X, C))
        if tiled is not None and k <= 16:
            calls[f"tiled alone {tag}"] = lambda X=X, C=C: tiled(X, C)
        if k in (4, 48, 70):   # stage 3 (8 kmeans++ restarts, 50 Lloyd
            # steps); at k = 4 on a column-major U, as stage 1 hands it on
            U = X.T.contiguous().T if k == 4 else X
            psc.discretize(U[:4096], k, torch.Generator(device="cuda"))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            psc.discretize(U, k, torch.Generator(device="cuda")
                           .manual_seed(6))
            torch.cuda.synchronize()
            stage3_s[tag] = time.perf_counter() - t0
    _ab_line(src, calls, device=True)
    print(json.dumps({"src": str(src), "stage3_s": stage3_s}), flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--newton-iters", type=int, default=30)
    ap.add_argument("--tcg-iters", type=int, default=20)
    ap.add_argument("--sellcs-src", type=Path, metavar="SRC",
                    help="only time the SELL-C-σ kernels of the tree whose "
                    "src directory is SRC and print one JSON line")
    ap.add_argument("--kmeans-src", type=Path, metavar="SRC",
                    help="only time kmeans_assign of the tree whose src "
                    "directory is SRC and print one JSON line")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if args.sellcs_src is not None:
        return sellcs_times(args.sellcs_src, torch)
    if args.kmeans_src is not None:
        return kmeans_times(args.kmeans_src, torch)
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import psc
    from repro_torch.graphs import delaunay_graph
    from repro_torch.grblas import SparseMatrix, api
    from repro_torch.kernels import bsr_spmm as KB
    from repro_torch.kernels import build_all
    from repro_torch.kernels import flash_attention as KF
    from repro_torch.kernels import kmeans_assign as KK
    from repro_torch.kernels import plap_edge as KP
    from repro_torch.kernels import segment_sum as KS
    from repro_torch.kernels import sellcs_spmm as K

    counters = (K, KB, KP, KK, KF, KS)
    phase_s = {}
    t_phase = time.perf_counter()

    def phase_done(name):
        nonlocal t_phase
        now = time.perf_counter()
        phase_s[name] = now - t_phase
        t_phase = now
        print(f"phase {name}: {phase_s[name]!r} s", flush=True)

    smi = _card()
    print(smi, flush=True)
    print(f"torch={torch.__version__} cuda={torch.version.cuda} "
          f"device={torch.cuda.get_device_name(0)}", flush=True)
    print(f"build_s={build_all()!r}", flush=True)
    if (args.newton_iters, args.tcg_iters) != (30, 20):
        print(f"iteration budget cut: newton_iters={args.newton_iters} "
              f"tcg_iters={args.tcg_iters} (PSCConfig default 30/20)",
              flush=True)
    phase_done("build")

    # ---- SELL-C-σ slice
    t0 = time.perf_counter()
    W, _ = delaunay_graph(GRAPH_R, device="cuda", build_sellcs=True,
                          sell_c=32)
    print(f"graph: delaunay_graph({GRAPH_R}) n={W.n_rows} nnz={W.nnz} "
          f"sell_slots={W.sell_kernel.slots} "
          f"sellcs_fill={W.sellcs_fill_ratio()!r} "
          f"runs={len(W.sell_cols)} build_s={time.perf_counter() - t0!r}",
          flush=True)
    rows = sellcs_kernel_phase(W, K, torch)
    phase_done("sellcs_kernels")
    coo_sum = coo_sum_phase(W, KS, torch, api)
    phase_done("coo_sum")
    by_path, final_U, hvp_counts = {}, {}, {}
    for mode in ("graphblas", "matrix_free"):
        used = ["sellcs_spmm", "sellcs_plap_apply", "kmeans_assign"]
        if mode == "matrix_free":
            used.append("sellcs_plap_hvp")
        by_path[f"sellcs/{mode}"], res = flat_phase(
            "main", W, counters, torch, psc, "sellcs", mode, used, args)
        final_U[mode] = res.U
        hvp_counts[f"sellcs/{mode}"] = res.hvp_counts
        shapes = by_path[f"sellcs/{mode}"]["sellcs_spmm_by_shape"]
        want = {"scalar k=8", "scalar k=24"} | (
            {"multivalue k=4"} if mode == "graphblas" else set())
        if not want <= set(shapes):
            raise AssertionError(f"main[{mode}]: sellcs_spmm shapes "
                                 f"{shapes}, expected {sorted(want)}")
    phase_done("sellcs_path")
    for mode, U in final_U.items():
        breakdown_phase("breakdown", W, torch, "sellcs", mode, U)
    phase_done("sellcs_breakdown")

    # ---- BSR slice: the same triangulation, BSR tiles and COO only
    t0 = time.perf_counter()
    Wb = SparseMatrix.from_coo(*W.host_coo(), (W.n_rows, W.n_cols),
                               build_ell=False, build_sellcs=False,
                               build_bsr=True, block_size=BLOCK,
                               device="cuda")
    torch.cuda.synchronize()
    stage3_U = final_U["matrix_free"]
    del W, final_U
    nb = int(Wb.bsr_blocks.shape[0])
    print(f"bsr graph: n={Wb.n_rows} nnz={Wb.nnz} block_size={BLOCK} "
          f"n_blocks={nb} tiles_per_row_block="
          f"{nb / (len(Wb.bsr_indptr) - 1)!r} "
          f"bsr_fill_ratio={Wb.bsr_fill_ratio()!r} "
          f"tile_bytes={Wb.bsr_blocks.numel() * Wb.bsr_blocks.element_size()}"
          f" build_s={time.perf_counter() - t0!r}", flush=True)
    rows += bsr_kernel_phase(Wb, KB, KP, torch)
    print(f"bsr_spmm: csr torch.sparse.mm on the same graph "
          f"library_ms={rows[0]['library_ms']!r}", flush=True)
    phase_done("bsr_kernels")
    flat_rcut, final_U = None, {}
    for mode in ("graphblas", "matrix_free"):
        used = ["bsr_spmm", "plap_apply", "kmeans_assign"]
        if mode == "matrix_free":
            used.append("plap_hvp")
        else:       # the W-hat SpMMs on coo: the fixed-order sum
            used.append("segment_sum")
        by_path[f"bsr/{mode}"], res = flat_phase(
            "bsr", Wb, counters, torch, psc, "edge_pallas", mode, used, args)
        flat_rcut, final_U[mode] = res.rcut, res.U
        hvp_counts[f"bsr/{mode}"] = res.hvp_counts
    phase_done("bsr_path")
    for mode, U in final_U.items():
        breakdown_phase("bsr breakdown", Wb, torch, "edge_pallas", mode, U)
    del final_U
    phase_done("bsr_breakdown")
    by_path["multilevel_bsr/matrix_free"] = multilevel_phase(
        Wb, counters, torch, psc, flat_rcut, args)
    phase_done("multilevel_bsr_path")
    coo, shape = Wb.host_coo(), (Wb.n_rows, Wb.n_cols)
    del Wb
    torch.cuda.empty_cache()
    bsr256 = bsr_large_tile_phase(coo, shape, torch, api)
    del coo
    phase_done("bsr_block_256")

    # ---- dense slice: flash attention, kmeans_assign, Gemma-2B serving
    rows.append(kmeans_kernel_phase(stage3_U, torch, psc))
    rows[-1]["large_k"] = kmeans_large_k_phase(torch, psc)
    rows.append(flash_kernel_phase(torch))
    phase_done("dense_kernels")
    by_path["lm_serve"], lm = lm_serve_phase(torch, counters)
    phase_done("lm_serve")

    for row in rows:
        counter = row.get("counter", row["name"])
        row["launches_by_path"] = {p: c[counter] for p, c in by_path.items()}
        row["launches"] = sum(row["launches_by_path"].values())
        if row["name"] == "bsr_spmm":
            row["launches_by_width"] = {p: c["bsr_spmm_by_width"]
                                        for p, c in by_path.items()
                                        if c.get("bsr_spmm_by_width")}
        if row["name"] == "sellcs_spmm":
            row["launches_by_shape"] = {p: c["sellcs_spmm_by_shape"]
                                        for p, c in by_path.items()
                                        if c.get("sellcs_spmm_by_shape")}
    print(f"kmeans_assign launches per solve: "
          f"{ {p: c['kmeans_assign'] for p, c in by_path.items()} }",
          flush=True)
    coo_sum["launches_by_path"] = {p: c["segment_sum"]
                                   for p, c in by_path.items()}
    hvps = {p: sum(c) for p, c in hvp_counts.items()}
    print(f"hvp counts per solve: {hvps}", flush=True)
    print(f"phase_seconds={phase_s} total_s={sum(phase_s.values())!r}",
          flush=True)
    print(smi, flush=True)           # again, near the end of the output
    print(json.dumps({"lm_serve": lm}), flush=True)
    print(json.dumps({"coo_sum": coo_sum, "bsr_block_256": bsr256,
                      "hvp_counts": hvps}), flush=True)
    print(json.dumps({"kernels": rows, "card": smi}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
