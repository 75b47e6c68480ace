#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py [--newton-iters 30] [--tcg-iters 20] [--scf-sweeps 2]
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
     k = 4, and the apply at k = 1 (the inverse-power driver's one
     column, the generic variant); ``grblas.ops.fused_plap_apply`` at
     k = 4 (one apply launch, equal bit for bit to ``api.mxm`` under
     ``plap_edge_semiring``, within the tolerance of the plain version,
     timed).  Every kernel runs twice, equal bit
     for bit, and (at k = 4) with a NaN in one row of X (the HVP: one
     row of U and one of E), NaN where the plain versions put it.  Then the COO backend's reals SpMM with
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
     with window = 512, at D 128 with group 4 and at mixtral-8x22b's
     prefill shape (B 2, Hq 48, Hkv 8, S 6144, D 128, window 4096; all
     five on the wgmma kernel), then the mma.sync kernel at
     deepseek-v3's MLA prefill shape (B 4, Hq = Hkv = 128, S 2048, q/k
     head dim 192, value head dim 128: the op pads v to 192 and keeps
     128 columns) and at D 32, and the fp32 kernel at
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
 10. LM serve path (``LM_CELLS``), each model at full width with
     seeded weights on the card, bf16 compute, served by the ServeEngine
     with 32 greedy new tokens: Gemma-2B (2.51 B fp32 parameters, all 18
     layers; 4 requests of 2048-token prompts); Mixtral-8x22B (bf16
     parameters, 8 of 56 layers, printed as a cut; 2 requests of
     6144-token prompts, so the 4096-token window masks in prefill and
     decode; capacity factor 1.25); DeepSeek-V3 (bf16 parameters, 5 of
     61 layers: the 3 dense and 2 MoE layers, printed as a cut; 4
     requests of 2048 tokens; MLA, 256 routed experts top 8 plus the
     shared one).  Each fails unless the prefill launched the flash
     kernel its head dim routes to once per layer and no other (wgmma
     for Gemma and mixtral, mma for deepseek's D 192), the logits are
     finite, the last-token prefill logits through the kernel are within
     2^-5 relative of the same prefill through the plain attention (the
     router picks that differ between the two printed beside it), and
     one decode step's logits are within 2^-5 relative of a full
     forward's over the same tokens (the MoE models under a capacity
     factor of n_experts / top_k, C = T, so no pair drops in either; on
     deepseek's 128-token prompts, where the no-drop buffer fits).  Each
     MoE layer's dropped pairs and largest expert load over C in the
     prefill are printed, from the port's router on the layer's input,
     outside the timed run; and a profiler window of one decode step and
     one prefill.
 11. resilience and telemetry, on the SELL-C-σ graph of phases 2-4
     (C = 32, k = 4, fp32): (a) ``solver="guarded", validate=True,
     trace=True`` with matrix_free HVPs: it fails unless the recovery
     report is clean (no rung), the graph is one component
     (``connected_components``, its BFS hops and seconds printed), the
     labels, the HVP count and RCut equal phase 3's matrix_free solve,
     U^T U is within 1e-4 of I and the telemetry has the spans psc,
     init, continuation, solver.level, grblas.mxm and kmeans; its wall
     time is printed beside phase 3's, with ``phase_breakdown()`` and
     ``coverage()``.  (b) ``solver="scf"`` with ``--scf-sweeps`` sweeps
     a level (default 2, printed as a cut of PSCConfig's 12, which
     ``--scf-sweeps 12`` restores): phase 3's checks but the RCut bound (printed beside
     newton's), ``sellcs_spmm`` at scalar k = 8 and 24 beyond stage 1's
     launches, every level's sweeps and subspace drift printed.  (c)
     ``solver="inverse_power", p_target=1.0``: it fails unless the apply
     launched at k = 1, U is finite and orthonormal within 1e-4.  (d)
     the ladder: a NaN injected into the second newton level must end on
     warm_restart, a fault of the ``sellcs`` backend on backend_fallback
     (backend ``coo``, not degraded, through ``segment_sum``), each rung
     in the report, the ``recovery_rungs_total`` counter and a
     ``recovery.<rung>`` span, each RCut within 1.10 x (a)'s.  (e)
     ``validate_graph``: a copy of the graph with one NaN weight and one
     edge stored one way only is repaired to the original's host COO,
     and raises GraphValidationError without ``repair``.
 12. the clustering serve engine (``repro_torch.serve``).  (a) bucket
     lane: 48 cold k = 4 requests through ``ClusterServeEngine(
     PSCConfig(k=4), max_batch=8)``, four-block planted partitions of
     n = 120, 250, 500 and 1000, 12 of each (at least four buckets): it
     fails unless no request failed, the builds
     (``RetraceDetector.serve_buckets()``) are one per bucket key,
     ``segment_sum`` and ``kmeans_assign`` launched, the first request
     of each bucket has the labels of the flat ``p_spectral_cluster`` on
     the card, and a direct call of the largest bucket's built solve has
     exactly zero pad rows and equal bits on two calls (its device busy
     share printed, by the profiler).  Then the same graphs reweighted
     by 1.01: every request warm on the pattern tier, one new build per
     bucket; then one scf batch of 8 graphs of n = 250.  Seconds per
     batch and graphs/s are printed.  (b) solo lane on phase 3's graph,
     ``PSCConfig(k=4, backend="sellcs", hvp_mode="matrix_free")``: the
     cold request equals phase 3's matrix_free solve (labels, RCut); a
     repeat is warm on the exact tier within 1.01 x its RCut; 1% of the
     edges reweighted by 1.5 is warm on the pattern tier; ``update`` with
     0.1% of the edges knocked out is a weight-only churn within 1.02 x
     a scratch solve's RCut.  Each request's seconds, the fingerprint's
     and the delta's host seconds are printed.  (c) multilevel lane:
     ``ml=MultilevelConfig()`` on the same graph, a cold V-cycle (the
     engine keeps its hierarchy), then 0.01% new pairs at weight 0.5: the
     churn request must patch the hierarchy (one record a coarsened
     level); the patch and build seconds, the dirty and re-matched counts
     and the RCut beside a scratch V-cycle's are printed.
 13. the distributed SpMM (``grblas.dist``): ``partition_for_mesh(W, 4,
     sellcs=True)`` places the graph (the V-cycle; its seconds, RCut,
     part sizes, plan mode, halo width and the halo and gather wire bytes
     at k = 1 and 8 printed; it fails unless the plan is a halo plan),
     the single-process ``sellcs`` products and LOBPCG give the
     references, then four ranks spawned on the one card over gloo
     (buffers staged through pinned host memory) each take the
     partition and, from zeroed counts, run ``mxm(Ap, X,
     Descriptor(backend="dist_sellcs", mesh=mesh))`` (reals at k = 4, 8,
     24 and the p-Laplacian apply at k = 4, each within the fp32
     tolerance of the single-process product) and
     ``lobpcg.smallest_eigvecs(W, 4)`` over the same backend (its
     seconds and principal sine against the single-process solve
     printed; it fails on non-finite or non-orthonormal output).  Each
     rank fails unless its shard launches of both kernels ran and no
     plain version did, and unless one product with a NaN halo from
     shard 0 (``halo_corruption``) has NaN exactly in the rows that read
     it.  Then each rank times the collectives (in step) and, ranks in
     turn, its shard launches against their plain versions (CUDA events
     and the profiler's device time), their byte bounds and
     ``torch.sparse.mm`` on the shard's CSR; and whether gloo takes CUDA
     tensors itself is probed and timed.  A rank that fails fails the
     phase with its traceback.

Every clustering solve (3, 7, 8, 11, 12, 13's placement) also assigns its kmeans stages through
``kmeans_assign``, and fails if it did not launch; the bsr graphblas
solve fails unless its W-hat SpMMs ran through the fixed-order sum.  The
HVP count of every flat solve is printed.  The line before the
last is a JSON object with one entry per kernel, its launches summed
over the paths' runs (and split by path, the serve lanes' paths named
``serve/...``, and for ``bsr_spmm`` by
width; the shard launches of phase 13 by path and rank), and the
card's name and power limit; the last line is ``{"ok":
true, "device": {...}}``.  Without a CUDA device, or without
``src/repro_torch`` beside this script, it exits non-zero and prints no
result.
"""
from __future__ import annotations

import argparse
import dataclasses
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
SCF_SWEEPS = 12                # PSCConfig's scf_sweeps
SMOKE_SCF_SWEEPS = 2           # the smoke's default, a cut of SCF_SWEEPS
RUNG_RCUT = 1.10               # a recovered solve's RCut over the clean one
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


def fused_plap_check(W, U, K, torch) -> None:
    """``grblas.ops.fused_plap_apply`` once on the phase's W and U: one
    launch of the SELL-C-σ apply kernel (the backend ``auto`` picks on
    the card), bit for bit ``api.mxm(W, U, plap_edge_semiring(P, EPS))``
    and within the fp32 tolerance of the plain version; its time."""
    from repro_torch.grblas import api, ops
    from repro_torch.grblas.semiring import plap_edge_semiring

    before = K.LAUNCHES["sellcs_plap_apply"]
    got = ops.fused_plap_apply(W, U, P, EPS)
    launched = K.LAUNCHES["sellcs_plap_apply"] - before
    if launched != 1:
        raise AssertionError(f"fused_plap_apply: {launched} launches of "
                             "sellcs_plap_apply, expected 1")
    if not torch.equal(got, api.mxm(W, U, plap_edge_semiring(P, EPS))):
        raise AssertionError("fused_plap_apply: differs from api.mxm under "
                             "plap_edge_semiring")
    print("fused_plap_apply: equal bit for bit to api.mxm(W, U, "
          "plap_edge_semiring(p, eps))", flush=True)
    _compare("fused_plap_apply", got,
             K.sellcs_plap_apply_plain(W, U, P, EPS))
    ms = _time_ms(lambda: ops.fused_plap_apply(W, U, P, EPS))
    print(f"fused_plap_apply k={U.shape[1]}: ms={ms!r} (grblas.ops through "
          f"api.mxm, one sellcs_plap_apply launch)", flush=True)


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
    fused_plap_check(W, U, K, torch)
    # the apply at k = 1: the inverse-power driver's one column (the
    # generic variant)
    U1 = U[:, :1].contiguous()
    err1 = _compare("sellcs_plap_apply k=1", K.sellcs_plap_apply(
        W, U1, P, EPS), K.sellcs_plap_apply_plain(W, U1, P, EPS))
    _repeat("sellcs_plap_apply k=1",
            lambda: K.sellcs_plap_apply(W, U1, P, EPS))
    bound1 = _bound(_layout_bytes(L, item) + 2 * n * item,
                    OPS["apply"] * L.slots)
    rows[-1]["k1"] = dict(
        max_abs_err=err1[0], max_rel_err=err1[1],
        plan=K.launch_plan("sellcs_plap_apply", n, 1, U1.dtype)._asdict(),
        ms=_time_ms(lambda: K.sellcs_plap_apply(W, U1, P, EPS)),
        plain_ms=_time_ms(lambda: K.sellcs_plap_apply_plain(W, U1, P, EPS),
                          3, 3),
        bound_ms=bound1[0], bound_by=bound1[1], library_ms=None)
    print(f"sellcs_plap_apply k=1: kernel_ms={rows[-1]['k1']['ms']!r} "
          f"twin_ms={rows[-1]['k1']['plain_ms']!r} bound_ms={bound1[0]!r} "
          f"({bound1[1]}) plan={rows[-1]['k1']['plan']}", flush=True)
    del U1

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


def _counts(counters) -> dict:
    """Every kernel's launch count since the last reset."""
    return {name: c for K in counters for name, c in K.LAUNCHES.items()}


def _reset(counters) -> None:
    for K in counters:
        K.reset_launch_counts()


def _orthonormality(U, torch) -> float:
    G = U.T @ U
    return float((G - torch.eye(G.shape[0], device=G.device)).abs().max())


def solve_phase(tag, W, counters, torch, psc, cfg, used,
                all_clusters: bool = True) -> tuple:
    """One p_spectral_cluster run from zeroed launch counts; returns
    (counts, result); the wall seconds are in ``counts["wall_s"]``."""
    _reset(counters)
    t0 = time.perf_counter()
    res = psc.p_spectral_cluster(W, cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _counts(counters)
    launches["bsr_spmm_by_width"] = {
        kw: c for K in counters
        for kw, c in getattr(K, "LAUNCHES_BY_WIDTH", {}).items()}
    launches["sellcs_spmm_by_shape"] = {
        shape: c for K in counters
        for shape, c in getattr(K, "LAUNCHES_BY_SHAPE", {}).items()}
    launches["sellcs_plap_apply_by_k"] = {
        kk: c for K in counters
        for kk, c in getattr(K, "APPLY_LAUNCHES_BY_K", {}).items()}
    launches["wall_s"] = wall
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
    if all_clusters and len(np.unique(res.labels)) != cfg.k:
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


def _rung_counts(metrics) -> dict:
    return metrics.DEFAULT.labeled_values("recovery_rungs_total", "rung")


def _span_names(res) -> set:
    return {sp.name for sp in res.telemetry.spans}


def resilience_phase(W, counters, torch, psc, ref, args) -> tuple:
    """Phase 11 on the SELL-C-σ graph: the guarded, validated, traced
    solve held to phase 3's matrix_free solve (``ref``: its labels, HVPs,
    RCut, wall seconds and launches), the scf and inverse_power drivers,
    two injected faults down the recovery ladder and graph validation.
    Returns (launch counts by path, summary)."""
    from repro_torch.graphs import (GraphValidationError, ValidateConfig,
                                    connected_components, validate_graph)
    from repro_torch.grblas import SparseMatrix
    from repro_torch.obs import TraceConfig, metrics
    from repro_torch.testing import backend_fault, nan_in_multivector

    base = dict(k=4, backend="sellcs", hvp_mode="matrix_free",
                newton_iters=args.newton_iters, tcg_iters=args.tcg_iters)
    by_path, out = {}, {}

    # (a) guarded, validated, traced: equal to phase 3's unguarded solve
    rungs0 = _rung_counts(metrics)
    cfg = psc.PSCConfig(solver="guarded", validate=True, trace=True, **base)
    by_path["guarded/matrix_free"], res = solve_phase(
        "guarded[validate,trace]", W, counters, torch, psc, cfg,
        ["sellcs_spmm", "sellcs_plap_apply", "sellcs_plap_hvp",
         "kmeans_assign"])
    rec, tel = res.recovery, res.telemetry
    print(f"guarded: recovery={rec}", flush=True)
    if not (rec is not None and rec.clean and not rec.rungs) \
            or _rung_counts(metrics) != rungs0:
        raise AssertionError(f"guarded: the clean solve recorded rungs {rec}")
    if res.components is not None:
        raise AssertionError(f"guarded: split into components "
                             f"{res.components}")
    t0 = time.perf_counter()
    comps = connected_components(W)
    bfs_s = time.perf_counter() - t0
    print(f"guarded: connected_components n_components="
          f"{comps.n_components} hops={comps.hops} seconds={bfs_s!r}",
          flush=True)
    if comps.n_components != 1:
        raise AssertionError(f"guarded: {comps.n_components} components")
    hvps = sum(res.hvp_counts)
    same = dict(labels=bool(np.array_equal(res.labels, ref["labels"])),
                hvps=hvps == ref["hvps"], rcut=res.rcut == ref["rcut"])
    print(f"guarded: equal to phase 3's matrix_free solve: {same} (hvps "
          f"{hvps} / {ref['hvps']}, rcut {res.rcut!r} / {ref['rcut']!r})",
          flush=True)
    if not all(same.values()):
        raise AssertionError(f"guarded: differs from the unguarded solve "
                             f"{same}")
    want = {"psc", "init", "continuation", "solver.level", "grblas.mxm",
            "kmeans"}
    names = _span_names(res)
    mxm = [sp for sp in tel.spans if sp.name == "grblas.mxm"]
    wall = by_path["guarded/matrix_free"]["wall_s"]
    out["guarded"] = dict(
        wall_s=wall, unguarded_wall_s=ref["wall_s"],
        stage_s=res.stage_seconds, hvps=hvps, rcut=res.rcut,
        spans=len(tel.spans), events=len(tel.events), dropped=tel.dropped,
        grblas_mxm_spans=len(mxm), phase_breakdown=tel.phase_breakdown(),
        coverage=tel.coverage(), bfs_hops=comps.hops, bfs_s=bfs_s)
    print(f"guarded: wall_s={wall!r} (phase 3 unguarded: "
          f"{ref['wall_s']!r}) spans={len(tel.spans)} grblas.mxm="
          f"{len(mxm)} events={len(tel.events)} dropped={tel.dropped} "
          f"phase_breakdown={out['guarded']['phase_breakdown']} "
          f"coverage={out['guarded']['coverage']!r}", flush=True)
    if not want <= names:
        raise AssertionError(f"guarded: spans {sorted(want - names)} "
                             "missing")
    del res, tel, mxm

    # (b) scf: phase 3's checks but the RCut bound
    if args.scf_sweeps != SCF_SWEEPS:
        print(f"scf sweeps cut: scf_sweeps={args.scf_sweeps} (PSCConfig "
              f"default {SCF_SWEEPS})", flush=True)
    cfg = psc.PSCConfig(solver="scf", scf_sweeps=args.scf_sweeps,
                        trace=TraceConfig(fence=False), **base)
    by_path["scf"], res = solve_phase(
        "scf", W, counters, torch, psc, cfg,
        ["sellcs_spmm", "sellcs_plap_apply", "kmeans_assign"])
    shapes = by_path["scf"]["sellcs_spmm_by_shape"]
    stage1 = ref["launches"]["sellcs_spmm_by_shape"]
    for shape in ("scalar k=8", "scalar k=24"):
        if not shapes.get(shape, 0) > stage1.get(shape, 0):
            raise AssertionError(f"scf: sellcs_spmm {shape} launched "
                                 f"{shapes.get(shape, 0)} times, stage 1 "
                                 f"alone {stage1.get(shape, 0)}")
    sweeps = [(e["attrs"]["p"], e["attrs"]["sweep"], e["attrs"]["drift"])
              for e in res.telemetry.events if e["name"] == "scf.sweep"]
    for p, it, rep in zip(res.p_path, res.hvp_counts, res.reports):
        drifts = [d for q, _, d in sweeps if q == p]
        print(f"scf: p={p!r} sweeps={it} converged={rep.converged} "
              f"drift={drifts}", flush=True)
    out["scf"] = dict(
        scf_sweeps=args.scf_sweeps, wall_s=by_path["scf"]["wall_s"],
        stage_s=res.stage_seconds, sweeps=res.hvp_counts, drift=sweeps,
        rcut=res.rcut, init_rcut=res.init_rcut, newton_rcut=ref["rcut"],
        spmm_by_shape=shapes)
    print(f"scf: rcut={res.rcut!r} newton rcut={ref['rcut']!r} (recorded, "
          f"not asserted) init_rcut={res.init_rcut!r}", flush=True)
    del res

    # (c) inverse_power to p = 1: the apply at k = 1
    cfg = psc.PSCConfig(solver="inverse_power", p_target=1.0, **base)
    by_path["inverse_power"], res = solve_phase(
        "inverse_power", W, counters, torch, psc, cfg,
        ["sellcs_plap_apply", "kmeans_assign"], all_clusters=False)
    k1 = by_path["inverse_power"]["sellcs_plap_apply_by_k"].get(1, 0)
    out["inverse_power"] = dict(
        wall_s=by_path["inverse_power"]["wall_s"], stage_s=res.stage_seconds,
        rcut=res.rcut, init_rcut=res.init_rcut, p_path=res.p_path,
        apply_k1_launches=k1, clusters=int(len(np.unique(res.labels))))
    print(f"inverse_power: rcut={res.rcut!r} apply k=1 launches={k1} "
          f"clusters={out['inverse_power']['clusters']}", flush=True)
    if k1 < 1:
        raise AssertionError("inverse_power: the apply never launched at k=1")
    del res

    # (d) the ladder at full size
    def ladder(tag, inject, rung, used):
        before = _rung_counts(metrics)
        cfg = psc.PSCConfig(guard=True, trace=TraceConfig(fence=False),
                            **base)
        with inject() as log:
            by_path[f"ladder/{rung}"], res = solve_phase(
                f"ladder[{tag}]", W, counters, torch, psc, cfg, used)
        rec = res.recovery
        fired = {r: c - before.get(r, 0.0)
                 for r, c in _rung_counts(metrics).items()
                 if c != before.get(r, 0.0)}
        spans = {n for n in _span_names(res) if n.startswith("recovery.")}
        print(f"ladder[{tag}]: injected={log.count()} recovery={rec} "
              f"rungs_total={fired} spans={sorted(spans)} "
              f"rcut={res.rcut!r} clean rcut={out['guarded']['rcut']!r}",
              flush=True)
        if not (log.count() >= 1 and rec.final_rung == rung
                and not rec.degraded and fired.get(rung, 0) >= 1
                and f"recovery.{rung}" in spans
                and sum(fired.values()) == len(rec.rungs)):
            raise AssertionError(f"ladder[{tag}]: expected to end on {rung}")
        if not res.rcut <= RUNG_RCUT * out["guarded"]["rcut"] + 1e-9:
            raise AssertionError(f"ladder[{tag}]: rcut {res.rcut} above "
                                 f"{RUNG_RCUT} x the clean solve's")
        out[f"ladder_{rung}"] = dict(
            wall_s=by_path[f"ladder/{rung}"]["wall_s"],
            stage_s=res.stage_seconds, rcut=res.rcut,
            diverged=rec.diverged_reason, diverged_level=rec.diverged_level,
            rungs=[(r.rung, r.driver, r.backend, r.ok) for r in rec.rungs],
            hvps=sum(res.hvp_counts))
        return res

    ladder("nan in newton level 2",
           lambda: nan_in_multivector("newton", at_call=2, max_calls=1),
           "warm_restart", ["sellcs_plap_apply", "sellcs_plap_hvp"])
    res = ladder("sellcs backend down", lambda: backend_fault("sellcs"),
                 "backend_fallback", ["segment_sum", "kmeans_assign"])
    if res.recovery.rungs[-1].backend != "coo" or \
            by_path["ladder/backend_fallback"]["segment_sum"] <= \
            ref["launches"]["segment_sum"]:
        raise AssertionError("ladder[backend]: the fallback did not run on "
                             "coo through segment_sum")
    del res

    # (e) validation: a NaN weight and an edge stored one way only
    r, c, v = W.host_coo()
    v = v.copy()
    i_nan, j = W.nnz // 3, 2 * W.nnz // 3
    v[i_nan] = np.nan
    one_way = j + ((r[j], c[j]) == (c[i_nan], r[i_nan]))
    keep = np.ones(len(v), bool)
    keep[one_way] = False
    bad = SparseMatrix.from_coo(r[keep], c[keep], v[keep],
                                (W.n_rows, W.n_cols), build_ell=False,
                                build_sellcs=False, device="cuda")
    t0 = time.perf_counter()
    fixed = validate_graph(bad, ValidateConfig(repair=True))
    repair_s = time.perf_counter() - t0
    fr, fc, fv = fixed.host_coo()
    _, _, v0 = W.host_coo()
    equal = (np.array_equal(fr, r) and np.array_equal(fc, c)
             and np.array_equal(fv, v0))
    try:
        validate_graph(bad)
    except GraphValidationError as e:
        issues = e.issues
    else:
        raise AssertionError("validate: the damaged graph passed unrepaired")
    out["validate"] = dict(repaired_equal=equal, repair_s=repair_s,
                           issues=issues)
    print(f"validate: repaired host COO equal to the original: {equal} "
          f"(repair_s={repair_s!r}); without repair: {issues}", flush=True)
    if not equal:
        raise AssertionError("validate: the repaired graph differs")
    del bad, fixed
    return by_path, out


# ---------------------------------------------------------------- phase 12

# the bucket lane's stream: four-block planted partitions of these sizes,
# 12 graphs each, with (p_in, p_out) keeping each size's nnz inside one
# power of two
SERVE_SBM = {120: (0.3, 0.003), 250: (0.2, 0.002), 500: (0.1, 0.001),
             1000: (0.05, 0.0005)}
SERVE_PER_SIZE = 12
SERVE_BATCH = 8


def _require(tag, launches, used) -> None:
    for name in used:
        if launches[name] < 1:
            raise AssertionError(f"{tag}: {name} never launched")


def _busy(fn, torch) -> tuple:
    """(fn's output, wall ms, device ms, busy share, top kernels) of one
    call under the profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
    top = [(e.key[:60], e.self_device_time_total / 1e3, e.count)
           for e in kernels[:6]]
    return out, wall_ms, device_ms, device_ms / wall_ms, top


def _served(tag, results) -> None:
    bad = [r for r in results if not r.ok]
    if bad:
        raise AssertionError(f"{tag}: {len(bad)} request(s) failed, first: "
                             f"{bad[0].stats.failure_kind}: {bad[0].error}")


def bucket_lane_phase(dev, counters, torch, psc) -> tuple:
    """Phase 12 (a): 48 cold requests over four sizes of planted
    partition, a warm wave of the same graphs reweighted by 1.01, one scf
    batch.  Returns (launch counts by path, summary)."""
    from repro_torch.graphs import sbm_graph
    from repro_torch.obs import RetraceDetector
    from repro_torch.serve import ClusterServeEngine, assemble_batch
    from repro_torch.serve import psc_engine

    graphs = {}
    for n, (p_in, p_out) in SERVE_SBM.items():
        sizes = [n // 4 + (i < n % 4) for i in range(4)]
        graphs[n] = [sbm_graph(sizes, p_in, p_out, seed=s, device=dev)[0]
                     for s in range(SERVE_PER_SIZE)]
    stream = [W for n in SERVE_SBM for W in graphs[n]]
    cfg = psc.PSCConfig(k=4)
    eng = ClusterServeEngine(cfg, max_batch=SERVE_BATCH)
    by_path, out = {}, {}

    # cold wave
    det = RetraceDetector()
    _reset(counters)
    t0 = time.perf_counter()
    rids = [eng.submit(W) for W in stream]
    done = eng.flush()
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    by_path["serve/bucket_cold"] = _counts(counters)
    cold = [done[r] for r in rids]
    _served("bucket cold", cold)
    _require("bucket cold", by_path["serve/bucket_cold"],
             ["segment_sum", "kmeans_assign"])
    keys = sorted({r.stats.bucket for r in cold})
    builds = det.serve_buckets()
    print(f"bucket cold: {len(stream)} requests, buckets={keys} "
          f"builds={builds} batches={eng.stats.n_batches} "
          f"wall_s={cold_s!r} graphs_per_s={len(stream) / cold_s!r} "
          f"launches={by_path['serve/bucket_cold']}", flush=True)
    if len(keys) < 4:
        raise AssertionError(f"bucket cold: {len(keys)} buckets, expected "
                             f">= 4")
    if sorted(k[:5] for k in builds) != keys \
            or set(builds.values()) != {1}:
        raise AssertionError(f"bucket cold: builds {builds} are not one "
                             f"per bucket {keys}")
    per_bucket = {}
    for r in cold:
        per_bucket.setdefault(r.stats.bucket, set()).add(
            (r.stats.solve_s, r.stats.batch_size))
    batch_s = {str(k[2:4]): sorted(v) for k, v in per_bucket.items()}
    print(f"bucket cold: seconds and size of each batch per (n_b, nnz_b): "
          f"{batch_s}", flush=True)
    out["cold"] = dict(wall_s=cold_s, graphs_per_s=len(stream) / cold_s,
                       buckets=[list(k) for k in keys],
                       batches=eng.stats.n_batches, batch_s=batch_s)

    # one request of each bucket against the flat pipeline on the card
    first = {}
    for W, r in zip(stream, cold):
        first.setdefault(r.stats.bucket, (W, r))
    for key, (W, r) in first.items():
        t0 = time.perf_counter()
        flat = psc.p_spectral_cluster(W, cfg)
        flat_s = time.perf_counter() - t0
        same = bool(np.array_equal(r.labels, flat.labels))
        print(f"bucket {key[2:4]}: labels equal to the flat solve's: "
              f"{same} rcut={r.rcut!r} flat rcut={flat.rcut!r} "
              f"flat_s={flat_s!r}", flush=True)
        if not same:
            raise AssertionError(f"bucket {key}: labels differ from the "
                                 f"flat pipeline's")

    # a direct call of the largest bucket's built solve on its first
    # batch, under the profiler: pad rows exactly zero, and each
    # element's rows equal bit for bit to what the engine's run of the
    # same batch returned; the device's busy share against the wall
    # time of the engine's (unprofiled) run
    key = max(keys, key=lambda k: k[2])
    spec = psc_engine.BucketSpec(n=key[2], nnz=key[3], k=key[4], mode="cold")
    solve, _ = psc_engine._bucket_solver(spec, cfg)
    members = [(W, r) for W, r in zip(stream, cold)
               if r.stats.bucket == key][:SERVE_BATCH]
    batch = assemble_batch([W for W, _ in members], spec)
    args = [torch.as_tensor(a, device=dev)
            for a in (batch.rows, batch.cols, batch.vals, batch.mask)]
    (U, _), wall_ms, device_ms, busy, top = _busy(lambda: solve(*args),
                                                  torch)
    pads_zero = all(bool((U[b, n:] == 0.0).all())
                    for b, n in enumerate(batch.n_real))
    bitwise = all(bool(torch.equal(U[b, :W.n_rows], r.U))
                  for b, (W, r) in enumerate(members))
    engine_ms = members[0][1].stats.solve_s * 1e3
    print(f"bucket {key[2:4]} direct solve of {len(members)}: pad rows "
          f"exactly zero: {pads_zero}; equal bit for bit to the engine's "
          f"run: {bitwise}; profiled wall_ms={wall_ms!r} "
          f"device_ms={device_ms!r} busy_share={busy!r} (against the "
          f"engine's unprofiled {engine_ms!r} ms: "
          f"{device_ms / engine_ms!r}) top={top}", flush=True)
    if not (pads_zero and bitwise):
        raise AssertionError("bucket direct solve: pad rows not zero or "
                             "the two runs differ")
    out["direct"] = dict(bucket=list(key), wall_ms=wall_ms,
                         device_ms=device_ms, busy_share=busy,
                         engine_ms=engine_ms,
                         busy_share_unprofiled=device_ms / engine_ms)
    del U

    # warm wave: the same graphs reweighted by 1.01 -> pattern tier
    det = RetraceDetector()
    _reset(counters)
    t0 = time.perf_counter()
    rids = [eng.submit(W.with_vals(W.vals * 1.01)) for W in stream]
    done = eng.flush()
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    by_path["serve/bucket_warm"] = _counts(counters)
    warm = [done[r] for r in rids]
    _served("bucket warm", warm)
    tiers = {(r.stats.mode, r.stats.cache_tier) for r in warm}
    wkeys = sorted({r.stats.bucket for r in warm})
    builds = det.serve_buckets()
    print(f"bucket warm: tiers={tiers} builds={builds} wall_s={warm_s!r} "
          f"graphs_per_s={len(stream) / warm_s!r} (cold {cold_s!r})",
          flush=True)
    if tiers != {("warm", "pattern")}:
        raise AssertionError(f"bucket warm: tiers {tiers}")
    if sorted(k[:5] for k in builds) != wkeys or set(builds.values()) != {1} \
            or len(wkeys) != len(keys):
        raise AssertionError(f"bucket warm: builds {builds}, expected one "
                             f"per bucket {wkeys}")
    _require("bucket warm", by_path["serve/bucket_warm"],
             ["segment_sum", "kmeans_assign"])
    out["warm"] = dict(wall_s=warm_s, graphs_per_s=len(stream) / warm_s)

    # one scf batch: 8 graphs of n = 250
    eng_scf = ClusterServeEngine(psc.PSCConfig(k=4, solver="scf"),
                                 max_batch=SERVE_BATCH)
    _reset(counters)
    t0 = time.perf_counter()
    res = eng_scf.serve(graphs[250][:SERVE_BATCH])
    torch.cuda.synchronize()
    scf_s = time.perf_counter() - t0
    by_path["serve/bucket_scf"] = _counts(counters)
    _served("bucket scf", res)
    _require("bucket scf", by_path["serve/bucket_scf"],
             ["segment_sum", "kmeans_assign"])
    print(f"bucket scf: {len(res)} graphs of n=250 in "
          f"{eng_scf.stats.n_batches} batch, wall_s={scf_s!r} "
          f"rcut={[r.rcut for r in res]}", flush=True)
    out["scf"] = dict(wall_s=scf_s, batches=eng_scf.stats.n_batches)
    return by_path, out


class _Timed:
    """Wrap a function, keeping each call's seconds and result."""

    def __init__(self, fn):
        self.fn, self.calls = fn, []

    def __call__(self, *a, **k):
        t0 = time.perf_counter()
        out = self.fn(*a, **k)
        self.calls.append((time.perf_counter() - t0, out))
        return out


def solo_lane_phase(W, counters, torch, psc, ref, args) -> tuple:
    """Phase 12 (b): the solo lane at full size — cold, exact-tier
    repeat, pattern tier, weight-only churn.  ``ref`` is phase 3's
    matrix_free solve."""
    from repro_torch.serve import ClusterServeEngine, EdgeDelta
    from repro_torch.serve import apply_edge_delta

    cfg = psc.PSCConfig(k=4, backend="sellcs", hvp_mode="matrix_free",
                        newton_iters=args.newton_iters,
                        tcg_iters=args.tcg_iters)
    eng = ClusterServeEngine(cfg)
    t0 = time.perf_counter()
    fp = W.fingerprint()
    fp_s = time.perf_counter() - t0
    r, c, _ = W.host_coo()
    und = np.flatnonzero(r < c)
    rng = np.random.default_rng(12)
    out, secs = {"fingerprint_s": fp_s}, {}

    def run(tag, submit):
        t0 = time.perf_counter()
        rid = submit()
        res = eng.flush()[rid]
        torch.cuda.synchronize()
        secs[tag] = time.perf_counter() - t0
        _served(f"solo {tag}", [res])
        print(f"solo {tag}: mode={res.stats.mode} "
              f"tier={res.stats.cache_tier} lane={res.stats.lane} "
              f"wall_s={secs[tag]!r} solve_s={res.stats.solve_s!r} "
              f"rcut={res.rcut!r} p_final={res.stats.p_final!r}", flush=True)
        return res

    _reset(counters)
    cold = run("cold", lambda: eng.submit(W))
    if not (np.array_equal(cold.labels, ref["labels"])
            and cold.rcut == ref["rcut"]):
        raise AssertionError(f"solo cold: differs from phase 3's "
                             f"matrix_free solve (rcut {cold.rcut} vs "
                             f"{ref['rcut']})")
    exact = run("exact", lambda: eng.submit(W))
    if (exact.stats.mode, exact.stats.cache_tier) != ("warm", "exact") \
            or not exact.rcut <= 1.01 * cold.rcut:
        raise AssertionError(f"solo exact: {exact.stats.mode}/"
                             f"{exact.stats.cache_tier} rcut {exact.rcut}")
    pick = rng.choice(und, len(und) // 100, replace=False)
    reweight = EdgeDelta(r[pick], c[pick], np.full(len(pick), 1.5))
    W15 = apply_edge_delta(W, reweight).W
    pattern = run("pattern", lambda: eng.submit(W15))
    if (pattern.stats.mode, pattern.stats.cache_tier) != ("warm", "pattern"):
        raise AssertionError(f"solo pattern: {pattern.stats.mode}/"
                             f"{pattern.stats.cache_tier}")
    knock = rng.choice(und, len(und) // 1000, replace=False)
    delta = EdgeDelta(r[knock], c[knock], np.zeros(len(knock)))
    t0 = time.perf_counter()
    d = apply_edge_delta(W, delta)
    delta_s = time.perf_counter() - t0
    churn = run("churn", lambda: eng.update(W, delta))
    by_path = {"serve/solo": _counts(counters)}
    _require("solo", by_path["serve/solo"],
             ["sellcs_spmm", "sellcs_plap_apply", "sellcs_plap_hvp",
              "kmeans_assign"])
    t0 = time.perf_counter()
    scratch = psc.p_spectral_cluster(d.W, cfg)
    scratch_s = time.perf_counter() - t0
    print(f"solo churn: {len(knock)} edges knocked out, pattern_changed="
          f"{d.pattern_changed} rcut={churn.rcut!r} scratch rcut="
          f"{scratch.rcut!r} (bound 1.02x) scratch_s={scratch_s!r}; "
          f"fingerprint_s={fp_s!r} delta_s={delta_s!r}; seconds "
          f"{secs}", flush=True)
    if churn.stats.mode != "churn" or d.pattern_changed \
            or not churn.rcut <= 1.02 * scratch.rcut + 1e-12:
        raise AssertionError(f"solo churn: mode {churn.stats.mode}, "
                             f"pattern_changed {d.pattern_changed}, rcut "
                             f"{churn.rcut} vs scratch {scratch.rcut}")
    out.update(seconds=secs, delta_s=delta_s, scratch_s=scratch_s,
               rcut={"cold": cold.rcut, "exact": exact.rcut,
                     "pattern": pattern.rcut, "churn": churn.rcut,
                     "scratch": scratch.rcut},
               launches=by_path["serve/solo"])
    return by_path, out


def multilevel_lane_phase(W, counters, torch, psc, args) -> tuple:
    """Phase 12 (c): a cold V-cycle through the engine (its hierarchy
    kept), then a pattern churn that patches it."""
    import repro_torch.multilevel as ML
    from repro_torch.multilevel import MultilevelConfig
    from repro_torch.serve import ClusterServeEngine, EdgeDelta
    from repro_torch.serve import apply_edge_delta

    ml = MultilevelConfig()
    cfg = psc.PSCConfig(k=4, backend="sellcs", hvp_mode="matrix_free",
                        newton_iters=args.newton_iters,
                        tcg_iters=args.tcg_iters)
    eng = ClusterServeEngine(cfg, ml=ml)
    build, patch = _Timed(ML.build_hierarchy), _Timed(ML.patch_hierarchy)
    ML.build_hierarchy, ML.patch_hierarchy = build, patch
    try:
        _reset(counters)
        t0 = time.perf_counter()
        cold = eng.serve([W])[0]
        torch.cuda.synchronize()
        cold_s = time.perf_counter() - t0
        _served("multilevel cold", [cold])
        rng = np.random.default_rng(13)
        m = max(1, W.nnz // 2 // 10000)
        i = rng.integers(0, W.n_rows, m)
        j = (i + 1 + rng.integers(0, W.n_rows - 1, m)) % W.n_rows
        delta = EdgeDelta(i, j, np.full(m, 0.5))
        t0 = time.perf_counter()
        rid = eng.update(W, delta)
        update_s = time.perf_counter() - t0
        res = eng.flush()[rid]
        torch.cuda.synchronize()
        churn_s = time.perf_counter() - t0
    finally:
        ML.build_hierarchy, ML.patch_hierarchy = build.fn, patch.fn
    by_path = {"serve/multilevel": _counts(counters)}
    _served("multilevel churn", [res])
    _require("multilevel", by_path["serve/multilevel"],
             ["sellcs_plap_apply", "sellcs_plap_hvp", "kmeans_assign"])
    hier = eng.cache.peek(W.fingerprint()).hierarchy
    records = patch.calls[-1][1][1] if patch.calls else []
    print(f"multilevel cold: wall_s={cold_s!r} "
          f"solve_s={cold.stats.solve_s!r} rcut={cold.rcut!r}; hierarchy "
          f"kept: {hier.n_levels} levels, build_s="
          f"{[s for s, _ in build.calls]}", flush=True)
    for rec in records:
        print(f"multilevel patch: {rec}", flush=True)
    if res.stats.mode != "churn" or len(patch.calls) != 1 \
            or len(records) != hier.n_levels - 1:
        raise AssertionError(f"multilevel churn: mode {res.stats.mode}, "
                             f"{len(patch.calls)} patches, {len(records)} "
                             f"records for {hier.n_levels} levels")
    W2 = apply_edge_delta(W, delta).W
    t0 = time.perf_counter()
    scratch = psc.p_spectral_cluster(W2, dataclasses.replace(
        cfg, multilevel=ml))
    scratch_s = time.perf_counter() - t0
    print(f"multilevel churn: {m} new pairs, wall_s={churn_s!r} (update "
          f"{update_s!r}) patch_s={patch.calls[0][0]!r} build_s="
          f"{build.calls[0][0]!r} rcut={res.rcut!r} scratch multilevel "
          f"rcut={scratch.rcut!r} scratch_s={scratch_s!r} (recorded, not "
          f"asserted)", flush=True)
    out = dict(cold_s=cold_s, churn_s=churn_s, update_s=update_s,
               patch_s=patch.calls[0][0], build_s=build.calls[0][0],
               records=records, rcut=res.rcut, cold_rcut=cold.rcut,
               scratch_rcut=scratch.rcut, scratch_s=scratch_s)
    return by_path, out


def serve_phase(W, counters, torch, psc, ref, args) -> tuple:
    """Phase 12: the clustering serve engine — the bucket lane, the solo
    lane at full size, the multilevel lane."""
    by_path, out = {}, {}
    paths, out["bucket"] = bucket_lane_phase(W.device, counters, torch, psc)
    by_path.update(paths)
    paths, out["solo"] = solo_lane_phase(W, counters, torch, psc, ref, args)
    by_path.update(paths)
    paths, out["multilevel"] = multilevel_lane_phase(W, counters, torch, psc,
                                                     args)
    by_path.update(paths)
    return by_path, out


# ---------------------------------------------------------------- phase 13

DIST_S = 4                     # ranks, one shard each, all on the one card
DIST_KS = (4, 8, 24)           # the k = 4 multivector, LOBPCG's 8 and 24
DIST_P = 1.5                   # the edge ring's p (eps = EPS)
DIST_SEED = 13
DIST_LOBPCG_ITERS = 100        # a depth cut of LOBPCG's 200 iterations, to
                               # keep the smoke well inside its time limit


def _dist_expected_nan(Ap, shard: int) -> np.ndarray:
    """(n,) bool: the rows whose product reads a halo slot filled by
    ``shard`` (where ``halo_corruption(shard=)`` lands)."""
    S, R, H = Ap.n_shards, Ap.rows_per_shard, Ap.halo_width
    hit = np.zeros(Ap.n_rows, bool)
    for d in range(S):
        if d == shard:
            continue
        c = Ap.ell_cols[d]
        pos = d * R + np.flatnonzero(
            ((c >= R + shard * H) & (c < R + (shard + 1) * H)).any(1))
        pos = pos[pos < Ap.n_rows]
        hit[pos if Ap.perm is None else Ap.perm[pos]] = True
    return hit


def _wall_ms(fn, torch, reps: int = 5) -> float:
    """Median host time of ``fn`` (a collective: every rank calls it in
    step), synchronized, in ms."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    times.sort()
    return times[len(times) // 2]


def _dist_rank(rank: int, tmp: str, port: int) -> None:
    """One rank of phase 13 (a spawned process): joins the gloo group,
    drives the dist_sellcs products and LOBPCG from zeroed counts, then
    times its shard launches alone (ranks in turn) and the collectives
    (in step), and writes its results to ``tmp/rank<r>.json``."""
    import os

    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port),
                      WORLD_SIZE=str(DIST_S), RANK=str(rank),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(DIST_S))
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    import torch.distributed as tdist

    from repro_torch.grblas import dist

    mesh = dist.device_mesh(device="cuda")
    try:
        out = _dist_rank_body(rank, Path(tmp), mesh, torch, tdist)
        with open(Path(tmp) / f"rank{rank}.json", "w") as f:
            json.dump(out, f)
    finally:
        tdist.destroy_process_group()


def _dist_rank_body(rank, tmp, mesh, torch, tdist) -> dict:
    import importlib
    import pickle

    from repro_torch.core import lobpcg
    from repro_torch.grblas import Descriptor, SparseMatrix, dist, mxm
    from repro_torch.grblas.semiring import plap_edge_semiring
    from repro_torch.kernels import sellcs_spmm as K
    from repro_torch.testing import halo_corruption

    KM = importlib.import_module("repro_torch.kernels.sellcs_spmm."
                                 "sellcs_spmm")
    dev = mesh.device
    t0 = time.perf_counter()
    with open(tmp / "part.pkl", "rb") as f:
        Ap = pickle.load(f)
    ref = torch.load(tmp / "ref.pt", map_location=dev)
    coo = np.load(tmp / "coo.npz")
    n = Ap.n_rows
    gen = torch.Generator(device=dev).manual_seed(DIST_SEED)
    Xs = {k: torch.randn((n, k), generator=gen, device=dev)
          for k in DIST_KS}
    desc = Descriptor(backend="dist_sellcs", mesh=mesh)
    edge = plap_edge_semiring(DIST_P, EPS)
    out = {"rank": rank, "device": str(dev), "backend": mesh.backend,
           "staged": mesh.staged, "load_s": time.perf_counter() - t0}

    # the plain versions must never run on the card: count their calls
    plain_calls = {}
    for name in ("sellcs_shard_spmm_plain", "sellcs_shard_plap_apply_plain"):
        def counted(*a, _f=getattr(KM, name), _n=name, **kw):
            plain_calls[_n] = plain_calls.get(_n, 0) + 1
            return _f(*a, **kw)
        setattr(KM, name, counted)

    # ---- the main path: the products, from zeroed counts
    K.reset_launch_counts()
    t0 = time.perf_counter()
    Y = {f"reals k={k}": mxm(Ap, Xs[k], desc=desc) for k in DIST_KS}
    Y["apply k=4"] = mxm(Ap, Xs[4], edge, desc=desc)
    torch.cuda.synchronize()
    out["products_first_s"] = time.perf_counter() - t0
    out["launches_products"] = dict(K.SHARD_LAUNCHES)
    errs = {}
    for name, got in Y.items():
        want = ref[name]
        err = (got - want).abs()
        if not bool(torch.isfinite(got).all()) or bool(
                (err > ATOL + RTOL * want.abs()).any()):
            raise AssertionError(f"rank {rank}: dist {name} disagrees with "
                                 f"the single-process sellcs product")
        errs[name] = float(err.max())
    out["max_abs_err_vs_sellcs"] = errs
    del Y

    # ---- stage 1's eigensolve over the same backend (its own W: the
    # memo partitions it in natural order on the first product)
    Wr = SparseMatrix.from_coo(coo["rows"], coo["cols"], coo["vals"],
                               (n, n), build_ell=True, build_sellcs=False,
                               device=dev)
    t0 = time.perf_counter()
    mxm(Wr, Xs[8], desc=desc)
    torch.cuda.synchronize()
    out["lobpcg_memo_partition_s"] = time.perf_counter() - t0
    Wp = next(iter(Wr._dist_partitions.values()))[1]
    out["lobpcg_partition"] = {"mode": Wp.mode, **Wp.wire_bytes(8)}
    K.reset_launch_counts()
    t0 = time.perf_counter()
    ev, U = lobpcg.smallest_eigvecs(Wr, 4, max_iters=DIST_LOBPCG_ITERS,
                                    desc=desc)
    torch.cuda.synchronize()
    out["lobpcg_s"] = time.perf_counter() - t0
    out["launches_lobpcg"] = dict(K.SHARD_LAUNCHES)
    Qa = torch.linalg.qr(U.double())[0]
    Qb = torch.linalg.qr(ref["lobpcg U"].double())[0]
    out["lobpcg_sin_theta"] = float(torch.linalg.matrix_norm(
        Qb - Qa @ (Qa.T @ Qb), ord=2))
    out["lobpcg_evals"] = ev.tolist()
    out["lobpcg_orthonormality"] = _orthonormality(U, torch)
    if not (bool(torch.isfinite(U).all()) and bool(torch.isfinite(ev).all())
            and out["lobpcg_orthonormality"] <= 1e-4):
        raise AssertionError(f"rank {rank}: LOBPCG over dist_sellcs gave "
                             "non-finite or non-orthonormal output")
    out["plain_calls"] = dict(plain_calls)
    if plain_calls:
        raise AssertionError(f"rank {rank}: a plain version ran on the card "
                             f"({plain_calls})")
    del U, Wr

    # ---- one corrupted product (NaN halo from shard 0)
    with halo_corruption("nan", shard=0) as log:
        Yn = mxm(Ap, Xs[4], desc=desc)
    nan_rows = torch.isnan(Yn).any(1).cpu().numpy()
    expect = _dist_expected_nan(Ap, 0)
    clean = ref["reals k=4"][torch.as_tensor(~expect, device=dev)]
    if not (np.array_equal(nan_rows, expect) and log.count() >= 1
            and bool(((Yn[torch.as_tensor(~expect, device=dev)] - clean)
                      .abs() <= ATOL + RTOL * clean.abs()).all())):
        raise AssertionError(f"rank {rank}: the NaN halo did not land "
                             "exactly where the halo from shard 0 does")
    out["halo_nan_rows"] = int(nan_rows.sum())
    del Yn

    # ---- collectives and whole products, every rank in step
    d = rank
    send = Ap._on_device[(d, str(dev), "send")]
    x_src, times = {}, {}
    for k in DIST_KS:
        x_local = dist._own_rows(Ap, Xs[k], d)
        recv = dist._all_to_all(mesh, x_local[send])
        x_src[k] = torch.cat([x_local, recv]).contiguous()
        block = torch.randn((Ap.rows_per_shard, k), device=dev)
        times[k] = dict(
            own_rows_ms=_wall_ms(lambda: dist._own_rows(Ap, Xs[k], d), torch),
            exchange_ms=_wall_ms(
                lambda: dist._all_to_all(mesh, x_local[send]), torch),
            gather_y_ms=_wall_ms(lambda: dist._all_gather(mesh, block),
                                 torch),
            product_ms=_wall_ms(lambda: mxm(Ap, Xs[k], desc=desc), torch))
    times[4]["apply_product_ms"] = _wall_ms(
        lambda: mxm(Ap, Xs[4], edge, desc=desc), torch)
    out["collectives"] = times

    # does gloo take CUDA tensors itself? (the port stages explicitly)
    probe = {}
    t = dist._own_rows(Ap, Xs[8], d)[send]
    staged = dist._all_to_all(mesh, t)
    try:
        recv = torch.empty_like(t)
        tdist.all_to_all_single(recv, t)
        torch.cuda.synchronize()
        probe["all_to_all_single"] = bool(torch.equal(recv, staged))
        probe["all_to_all_single_ms"] = _wall_ms(
            lambda: tdist.all_to_all_single(recv, t), torch)
    except RuntimeError as e:
        probe["all_to_all_single"] = f"refused: {str(e)[:160]}"
    block = torch.randn((Ap.rows_per_shard, 8), device=dev)
    try:
        parts = [torch.empty_like(block) for _ in range(DIST_S)]
        tdist.all_gather(parts, block)
        torch.cuda.synchronize()
        probe["all_gather"] = bool(torch.equal(
            torch.cat(parts), dist._all_gather(mesh, block)))
        probe["all_gather_ms"] = _wall_ms(
            lambda: tdist.all_gather(parts, block), torch)
    except RuntimeError as e:
        probe["all_gather"] = f"refused: {str(e)[:160]}"
    out["gloo_cuda_probe"] = probe

    # ---- each rank's shard launches alone, ranks in turn
    sh = Ap._on_device[(d, str(dev), "sell")]
    L = sh.kernel
    keep = Ap.ell_vals[d] != 0
    csr = torch.sparse_coo_tensor(
        torch.as_tensor(np.stack([np.nonzero(keep)[0],
                                  Ap.ell_cols[d][keep]]), device=dev),
        torch.as_tensor(Ap.ell_vals[d][keep], device=dev),
        (Ap.rows_per_shard, int(x_src[4].shape[0]))).coalesce() \
        .to_sparse_csr()
    kernels = {}
    for turn in range(DIST_S):
        if turn == rank:
            for k in DIST_KS:
                xs = x_src[k]
                if xs.shape[0] != csr.shape[1]:
                    raise AssertionError("x_src rows differ across k")
                got = K.sellcs_shard_spmm(sh, xs)
                err = _compare(f"rank {rank} sellcs_shard_spmm k={k}", got,
                               K.sellcs_shard_spmm_plain(sh, xs))
                bound = _bound(_layout_bytes(L, 4) + 4 * k * (
                    xs.shape[0] + L.n), OPS["reals"] * L.slots * k)
                kernels[f"sellcs_shard_spmm k={k}"] = dict(
                    max_abs_err=err[0], max_rel_err=err[1],
                    ms=_time_ms(lambda: K.sellcs_shard_spmm(sh, xs)),
                    device_ms=_device_ms(lambda: K.sellcs_shard_spmm(
                        sh, xs))["per_call_ms"],
                    plain_ms=_time_ms(
                        lambda: K.sellcs_shard_spmm_plain(sh, xs), 3, 3),
                    bound_ms=bound[0], bound_by=bound[1],
                    library_ms=_time_ms(lambda: torch.sparse.mm(csr, xs)))
            xs = x_src[4]
            got = K.sellcs_shard_plap_apply(sh, xs, DIST_P, EPS)
            err = _compare(f"rank {rank} sellcs_shard_plap_apply k=4", got,
                           K.sellcs_shard_plap_apply_plain(sh, xs, DIST_P,
                                                           EPS))
            bound = _bound(_layout_bytes(L, 4) + 4 * 4 * (xs.shape[0] + L.n),
                           OPS["apply"] * L.slots * 4)
            kernels["sellcs_shard_plap_apply k=4"] = dict(
                max_abs_err=err[0], max_rel_err=err[1],
                ms=_time_ms(lambda: K.sellcs_shard_plap_apply(
                    sh, xs, DIST_P, EPS)),
                device_ms=_device_ms(lambda: K.sellcs_shard_plap_apply(
                    sh, xs, DIST_P, EPS))["per_call_ms"],
                plain_ms=_time_ms(lambda: K.sellcs_shard_plap_apply_plain(
                    sh, xs, DIST_P, EPS), 3, 3),
                bound_ms=bound[0], bound_by=bound[1], library_ms=None)
        tdist.barrier()
    out["kernels"] = kernels
    out["shard"] = dict(rows=L.n, slots=L.slots, x_src_rows=int(
        x_src[4].shape[0]), halo_width=int(Ap.halo_width))
    return out


def dist_phase(W, counters, torch, args) -> tuple:
    """Phase 13: ``partition_for_mesh(W, 4, sellcs=True)`` in this
    process, the single-process ``sellcs`` references, then four spawned
    ranks on the card over gloo (``_dist_rank``).  Returns (launches by
    path, kernel rows 1d and 2b, the phase's summary)."""
    import pickle
    import socket
    import tempfile

    import torch.multiprocessing as mp

    from repro_torch.core import lobpcg
    from repro_torch.graphs import partition_for_mesh
    from repro_torch.grblas import Descriptor, mxm
    from repro_torch.grblas.semiring import plap_edge_semiring

    summary, by_path = {}, {}
    _reset(counters)
    t0 = time.perf_counter()
    Ap, labels, info = partition_for_mesh(W, DIST_S, sellcs=True)
    torch.cuda.synchronize()
    summary["partition_s"] = time.perf_counter() - t0
    by_path["dist/partition_for_mesh"] = _counts(counters)
    summary["partition"] = dict(
        rcut=info["rcut"], sizes=info["sizes"], mode=Ap.mode,
        halo_width=int(Ap.halo_width), rows_per_shard=Ap.rows_per_shard,
        halo_rows_true=int(Ap.halo_rows_true),
        wire_bytes_k1=Ap.wire_bytes(1), wire_bytes_k8=Ap.wire_bytes(8))
    print(f"dist partition_for_mesh: {summary['partition_s']!r} s "
          f"rcut={info['rcut']!r} sizes={info['sizes']} mode={Ap.mode} "
          f"H={Ap.halo_width} R={Ap.rows_per_shard} "
          f"wire_bytes k=1 {Ap.wire_bytes(1)} k=8 {Ap.wire_bytes(8)}",
          flush=True)
    if Ap.mode != "halo":
        raise AssertionError(f"dist: the placed partition is a {Ap.mode} "
                             "plan, expected halo")

    # single-process references on the card (same inputs as the ranks)
    desc = Descriptor(backend="sellcs")
    gen = torch.Generator(device="cuda").manual_seed(DIST_SEED)
    Xs = {k: torch.randn((W.n_rows, k), generator=gen, device="cuda")
          for k in DIST_KS}
    ref = {f"reals k={k}": mxm(W, Xs[k], desc=desc).cpu() for k in DIST_KS}
    ref["apply k=4"] = mxm(W, Xs[4], plap_edge_semiring(DIST_P, EPS),
                           desc=desc).cpu()
    print(f"dist lobpcg iterations cut: max_iters={DIST_LOBPCG_ITERS} "
          "(smallest_eigvecs default 200)", flush=True)
    t0 = time.perf_counter()
    ev, U = lobpcg.smallest_eigvecs(W, 4, max_iters=DIST_LOBPCG_ITERS,
                                    desc=desc)
    torch.cuda.synchronize()
    summary["lobpcg_single_process_s"] = time.perf_counter() - t0
    summary["lobpcg_single_process_evals"] = ev.tolist()
    ref["lobpcg U"] = U.cpu()
    del Xs, U

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        with open(Path(tmp) / "part.pkl", "wb") as f:
            pickle.dump(Ap, f, protocol=pickle.HIGHEST_PROTOCOL)
        torch.save(ref, Path(tmp) / "ref.pt")
        rows, cols, vals = W.host_coo()
        np.savez(Path(tmp) / "coo.npz", rows=rows, cols=cols, vals=vals)
        summary["handoff_s"] = time.perf_counter() - t0
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        t0 = time.perf_counter()
        mp.spawn(_dist_rank, args=(tmp, port), nprocs=DIST_S, join=True)
        summary["ranks_s"] = time.perf_counter() - t0
        ranks = []
        for r in range(DIST_S):
            with open(Path(tmp) / f"rank{r}.json") as f:
                ranks.append(json.load(f))
    del ref

    for res in ranks:
        r = res["rank"]
        print(f"dist rank {r}: {res['device']} backend={res['backend']} "
              f"staged={res['staged']} launches products="
              f"{res['launches_products']} lobpcg={res['launches_lobpcg']} "
              f"plain_calls={res['plain_calls']} max_abs_err_vs_sellcs="
              f"{res['max_abs_err_vs_sellcs']} halo_nan_rows="
              f"{res['halo_nan_rows']} shard={res['shard']}", flush=True)
        for name, kr in res["kernels"].items():
            print(f"dist rank {r} {name}: kernel_ms={kr['ms']!r} "
                  f"device_ms={kr['device_ms']!r} (profiler) "
                  f"twin_ms={kr['plain_ms']!r} bound_ms={kr['bound_ms']!r} "
                  f"({kr['bound_by']}) library_ms={kr['library_ms']!r}",
                  flush=True)
        for k, t in res["collectives"].items():
            print(f"dist rank {r} k={k}: {t}", flush=True)
        print(f"dist rank {r}: lobpcg_s={res['lobpcg_s']!r} (single process "
              f"{summary['lobpcg_single_process_s']!r}) sin_theta="
              f"{res['lobpcg_sin_theta']!r} evals={res['lobpcg_evals']} "
              f"memo_partition_s={res['lobpcg_memo_partition_s']!r} "
              f"{res['lobpcg_partition']} gloo_cuda_probe="
              f"{res['gloo_cuda_probe']}", flush=True)
    print(f"dist single-process lobpcg evals="
          f"{summary['lobpcg_single_process_evals']}", flush=True)
    for path in ("products", "lobpcg"):
        key = f"launches_{path}"
        want = ({f"sellcs_shard_spmm k={k}" for k in DIST_KS}
                | {"sellcs_shard_plap_apply k=4"} if path == "products"
                else {"sellcs_shard_spmm k=8", "sellcs_shard_spmm k=24"})
        for res in ranks:
            if not want <= {n for n, c in res[key].items() if c > 0}:
                raise AssertionError(f"dist/{path}: rank {res['rank']} "
                                     f"launched {res[key]}, expected {want}")

    def launches(prefix):
        by = {f"dist/{path}": {f"rank {res['rank']}": sum(
            c for n, c in res[f"launches_{path}"].items()
            if n.startswith(prefix)) for res in ranks}
            for path in ("products", "lobpcg")}
        return sum(sum(v.values()) for v in by.values()), by

    src = "src/repro_torch/kernels/sellcs_spmm/csrc/sellcs_kernels.cu"
    refk = "src/repro/kernels/sellcs_spmm/sellcs_spmm.py"
    rows = []
    for name, line, prefix in (("sellcs_shard_spmm", 95,
                                "sellcs_shard_spmm k="),
                               ("sellcs_shard_plap_apply", 109,
                                "sellcs_shard_plap_apply k=")):
        main = f"{name} k=4"
        k4 = ranks[0]["kernels"][main]
        err = max(res["kernels"][main]["max_abs_err"] for res in ranks)
        row = _row(name, src, f"{refk}:{line}", (err, max(
            res["kernels"][main]["max_rel_err"] for res in ranks)),
            k4["ms"], k4["plain_ms"], (k4["bound_ms"], k4["bound_by"]),
            k4["library_ms"])
        row["launches"], row["launches_by_path"] = launches(prefix)
        row["by_rank"] = {f"rank {res['rank']}": {
            n: kr for n, kr in res["kernels"].items() if n.startswith(prefix)}
            for res in ranks}
        rows.append(row)
    summary["ranks"] = [{k: v for k, v in res.items() if k != "kernels"}
                        for res in ranks]
    return by_path, rows, summary


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


def flash_kernel_phase(torch) -> list:
    """Flash attention against its plain version at the serve shape and
    four variants on the wgmma kernel (mixtral's D 128, group 6, window
    4096 among them), then the mma.sync kernel at MLA's D 192 with a
    value head dim of 128 (deepseek's prefill) and at D 32, and the
    fp32 kernel; returns the rows of the two kernels the serve paths
    run: wgmma (Gemma's and mixtral's prefill) and mma (deepseek's)."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as KF

    gen = torch.Generator(device="cuda").manual_seed(2)
    shapes = [  # (tag, B, Hq, Hkv, S, D, Dv, window, dtype)
        ("serve", 4, 8, 1, 2048, 256, 256, None, torch.bfloat16),
        ("ragged_S1000", 4, 8, 1, 1000, 256, 256, None, torch.bfloat16),
        ("window512", 4, 8, 1, 2048, 256, 256, 512, torch.bfloat16),
        ("D128_group4", 4, 8, 2, 2048, 128, 128, None, torch.bfloat16),
        # mixtral-8x22b's prefill: 48 q heads over 8 kv heads, a window
        # that masks at S 6144
        ("mixtral_D128_group6_window4096", 2, 48, 8, 6144, 128, 128, 4096,
         torch.bfloat16),
        # deepseek-v3's MLA prefill: q/k 128 + 64 rotary, v 128 (padded
        # to 192 by the op)
        ("mla_D192_Dv128", 4, 128, 128, 2048, 192, 128, None,
         torch.bfloat16),
        # the kernels of the other routes: a head dim off wgmma's (the
        # reduced test configs' 16 and 32), and fp32
        ("mma_D32", 4, 8, 2, 2048, 32, 32, None, torch.bfloat16),
        ("f32_D128", 1, 8, 2, 2048, 128, 128, None, torch.float32)]
    out = {}
    for tag, B, Hq, Hkv, S, D, Dv, window, dtype in shapes:
        q, k, v = (torch.randn(shape, generator=gen, device="cuda",
                               dtype=dtype)
                   for shape in ((B, Hq, S, D), (B, Hkv, S, D),
                                 (B, Hkv, S, Dv)))
        variant = KF.kernel_variant(dtype, D, S)
        name = f"flash_attention_{variant}"
        before = KF.LAUNCHES[name]
        got = KF.flash_attention(q, k, v, causal=True, window=window)
        if KF.LAUNCHES[name] != before + 1 or got.shape[-1] != Dv:
            raise AssertionError(f"flash_attention[{tag}]: {name} did not "
                                 "launch once, or the output is not Dv wide")
        # fp32 math on the same inputs; query-chunked where the (S, S)
        # scores of every head would not fit beside the rest
        ref = (KF.attention_ref if B * Hq * S * S * 4 <= 2 ** 32
               else KF.attention_ref_chunked)
        ref32 = ref(q.float(), k.float(), v.float(), causal=True,
                    window=window)
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
        nbytes = item * (q.numel() + k.numel() + v.numel()
                         + B * Hq * S * Dv)
        flops = 2 * B * Hq * (D + Dv) * _visible_pairs(S, window)
        bound = _bound(nbytes, flops, BF16_OPS_PER_S
                       if dtype == torch.bfloat16 else FP32_OPS_PER_S)
        row = dict(shape=dict(B=B, Hq=Hq, Hkv=Hkv, S=S, D=D, Dv=Dv,
                              window=window, causal=True,
                              dtype=str(dtype).split(".")[-1]),
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
        out[tag] = row
        del q, k, v
        torch.cuda.empty_cache()

    def kernel_row(variant, source, main, others):
        r = out[main]
        row = _row(f"flash_attention_{variant}" if variant != "wgmma"
                   else "flash_attention",
                   f"src/repro_torch/kernels/flash_attention/csrc/{source}",
                   "src/repro/kernels/flash_attention/flash_attention.py:74",
                   (r["max_abs_err"], r["max_rel_err"]), r["ms"],
                   r["plain_ms"], (r["bound_ms"], r["bound_by"]),
                   r["library_ms"])
        # the serve paths' launches of this kernel are read from this
        # counter
        row["counter"] = f"flash_attention_{variant}"
        row["shape"] = r["shape"]
        row["variants"] = {tag: out[tag] for tag in others}
        return row

    return [kernel_row("wgmma", "flash_attention_wgmma.cu", "serve",
                       ["ragged_S1000", "window512", "D128_group4",
                        "mixtral_D128_group6_window4096"]),
            kernel_row("mma", "flash_attention.cu", "mla_D192_Dv128",
                       ["mma_D32"])]


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


def _routing(MOE, calls, torch, force=None):
    """Patch ``MOE._router`` to record each MoE layer's routing: the
    expert ids its own router picks (``ids``), and for the ids the layer
    runs with, the pairs dropped and the largest expert load over C.
    With ``force`` (one (T, k) id tensor a MoE layer, in call order) the
    layers run with those ids instead, weighed by their own router's
    probabilities (renormalised as the router does): two runs then
    compare with the same routing, so a pick that a rounding difference
    flips does not hide or stand in for the difference being checked."""
    from unittest import mock

    router = MOE._router
    forced = None if force is None else iter(force)

    def _router(cfg, router_w, x):
        m = cfg.moe
        weights, ids, aux = router(cfg, router_w, x)
        run = ids
        if forced is not None:
            run = next(forced)
            probs = torch.softmax((x @ router_w.to(x.dtype)).float(), -1)
            w = probs.gather(1, run)
            if m.router_scale:
                w = w / w.sum(-1, keepdim=True).clamp(min=1e-9)
            weights = w.to(x.dtype)
        T = x.shape[0]
        C = MOE._capacity(cfg, T)
        _, eid, _, keep = MOE._dispatch_indices(cfg, run, T, C, 0,
                                                m.n_experts)
        load = (eid[:, None] == torch.arange(m.n_experts, device=x.device)
                ).sum(0).max()
        calls.append(dict(ids=ids, run=run, C=C, dropped=(~keep).sum(),
                          max_load=load))
        return weights, run, aux

    return mock.patch.object(MOE, "_router", _router)


def _flips(a, b, torch) -> int:
    """Router picks that differ between two runs' (T, k) expert ids,
    each token's picks taken as a set."""
    return int((torch.sort(a, dim=-1)[0] != torch.sort(b, dim=-1)[0]).sum())


LM_CELLS = {  # arch: (layers run or None for all, requests, prompt, new,
              #        decode-check prompt)
    "gemma-2b": (None, 4, 2048, 32, 2048),
    "mixtral-8x22b": (8, 2, 6144, 32, 6144),
    # the no-drop decode check's (256, T, 7168) buffer is 30 GB at 4 x
    # 2049 tokens, 1.9 GB at 4 x 129
    "deepseek-v3-671b": (5, 4, 2048, 32, 128),
}


def lm_serve_phase(torch, counters, arch: str = "gemma-2b") -> tuple:
    """One model of ``LM_CELLS`` at full width (depth cut where the cell
    says, printed) through the ServeEngine; returns (launch counts of the
    served run, summary).  It fails unless the prefill launched the
    flash kernel its head dim routes to once per layer (and no other),
    the logits are finite and the tokens in the vocabulary, the
    last-token prefill logits through the kernel are within 2^-5
    relative of the same prefill through the plain attention, and one
    decode step's logits are within 2^-5 relative of a full forward's
    over the same tokens (MoE: under a capacity factor of n_experts /
    top_k, so that no pair drops in either)."""
    from unittest import mock

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as KF
    from repro_torch.models import attention as ATT
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    from repro_torch.models import moe as MOE
    from repro_torch.serve import GenerationConfig, ServeEngine

    n_layers, B, S, new, check_S = LM_CELLS[arch]
    full = get_config(arch)
    cfg = (full if n_layers is None
           else dataclasses.replace(full, n_layers=n_layers))
    tag = "lm_serve" if arch == "gemma-2b" else f"lm_serve/{arch}"
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = M.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    D = (cfg.mla.nope_dim + cfg.mla.rope_dim if cfg.mla
         else cfg.resolved_head_dim)
    variant = KF.kernel_variant(torch.bfloat16, D)
    print(f"{tag}: {cfg.name} n_layers={cfg.n_layers} "
          f"d_model={cfg.d_model} heads={cfg.n_heads}/{cfg.n_kv_heads} "
          f"qk_head_dim={D} d_ff={cfg.d_ff} moe={cfg.moe} mla={cfg.mla} "
          f"window={cfg.window} vocab={cfg.padded_vocab} params={n_params} "
          f"({cfg.params_dtype}, compute {cfg.compute_dtype}) "
          f"init_s={time.perf_counter() - t0!r}", flush=True)
    if n_layers is not None:
        print(f"{tag}: depth cut to {n_layers} of {full.n_layers} layers "
              "(full width)", flush=True)
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab, (B, S)).astype(np.int32)
    engine = ServeEngine(cfg, params, max_len=S + new)
    engine.generate(prompts, GenerationConfig(max_new_tokens=2))  # warm-up
    _reset(counters)
    t0 = time.perf_counter()
    out = engine.generate(prompts, GenerationConfig(max_new_tokens=new))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _counts(counters)
    t = engine.timing
    flash = {k: v for k, v in launches.items()
             if k.startswith("flash_attention_")}
    summary = dict(
        requests=B, prompt_len=S, new_tokens=new, generated=int(out.size),
        wall_s=wall, prefill_s=t["prefill_s"],
        decode_ms_per_token=t["decode_s"] / t["decode_steps"] * 1e3,
        decode_steps=t["decode_steps"], tokens_per_s=out.size / wall,
        prompt_tokens_per_s=B * S / t["prefill_s"],
        peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
        flash_launches=flash, n_layers=cfg.n_layers,
        full_n_layers=full.n_layers, params=n_params)
    print(f"{tag}: {summary}", flush=True)
    print(f"{tag}: first request's tokens {out[0].tolist()}", flush=True)
    want = {k: cfg.n_layers if k == f"flash_attention_{variant}" else 0
            for k in flash}
    if flash != want:
        raise AssertionError(f"{tag}: flash launches {flash}, expected "
                             f"{want}")
    if not ((out >= 0) & (out < cfg.vocab)).all():
        raise AssertionError(f"{tag}: token ids out of the vocabulary")

    def rel(a, b):
        return float((a.float() - b.float()).norm() / b.float().norm())

    no_drop = cfg
    if cfg.moe is not None:
        no_drop = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))
    tok = torch.as_tensor(prompts, device="cuda")
    plain = mock.patch.object(ATT, "flash_attention", KF.plain_attention)
    kc, pc, qc, cc, dc, fc, gc = ([] for _ in range(7))
    with torch.no_grad():
        with _routing(MOE, kc, torch):
            lk, cache, pos = M.prefill(cfg, params, tok, S + new)
        with _routing(MOE, pc, torch), plain:
            lp = lp_own = M.prefill(cfg, params, tok, S + new)[0]
        if cfg.moe is not None:
            # the plain prefill again with the kernel prefill's routing
            with _routing(MOE, qc, torch, force=[c["run"] for c in kc]), \
                    plain:
                lp = M.prefill(cfg, params, tok, S + new)[0]
        nxt = torch.argmax(lk[:, -1], dim=-1)[:, None].to(torch.int32)
        # decode against a full forward over the same check_S + 1 tokens
        ctok = tok[:, :check_S]
        with _routing(MOE, cc, torch):
            lc, ccache, cpos = M.prefill(no_drop, params, ctok, check_S + 1)
        cnxt = torch.argmax(lc[:, -1], dim=-1)[:, None].to(torch.int32)
        with _routing(MOE, dc, torch):
            ld, _ = M.decode_step(no_drop, params, ccache, cnxt, torch.full(
                (B, 1), cpos, dtype=torch.int32, device="cuda"))
        seq = torch.cat([ctok, cnxt], dim=1)

        def forward_logits():
            x, _ = M.forward_train(no_drop, params, seq)
            return L.unembed_logits(params["embed"], x[:, -1:],
                                    real_vocab=cfg.vocab)

        with _routing(MOE, fc, torch):
            lf = lf_own = forward_logits()
        k = cfg.moe.top_k if cfg.moe else 0
        if cfg.moe is not None:
            # the forward again with the prefill's and the decode's
            # routing
            cache_path = [torch.cat([a["run"].view(B, check_S, k),
                                     b["run"].view(B, 1, k)], 1).view(-1, k)
                          for a, b in zip(cc, dc)]
            with _routing(MOE, gc, torch, force=cache_path):
                lf = forward_logits()
        del ccache

    def flips(a, b, last=False):
        """Router picks that differ, by MoE layer (a forward's calls
        against a decode's: the last position only)."""
        return [_flips(x["ids"].view(B, -1, k)[:, -1] if last else x["ids"],
                       y["ids"], torch) for x, y in zip(a, b)]

    checks = dict(
        prefill_rel_err_kernel_vs_plain=rel(lk, lp),
        prefill_rel_err_kernel_vs_plain_own_routing=rel(lk, lp_own),
        prefill_argmax_equal=int((lk.argmax(-1) == lp.argmax(-1)).sum()),
        prefill_router_flips_kernel_vs_plain=flips(pc, kc),
        decode_check_prompt_len=check_S,
        decode_capacity_factor=no_drop.moe.capacity_factor
        if cfg.moe else None,
        decode_rel_err_vs_full_forward=rel(ld, lf),
        decode_rel_err_vs_full_forward_own_routing=rel(ld, lf_own),
        decode_argmax_equal=int((ld.argmax(-1) == lf.argmax(-1)).sum()),
        decode_router_flips_vs_full_forward=flips(fc, dc, last=True),
        prompt_router_flips_cache_prefill_vs_full_forward=[
            _flips(f["ids"].view(B, -1, k)[:, :-1].reshape(-1, k), c["ids"],
                   torch) for f, c in zip(fc, cc)],
        decode_check_dropped=[int(c["dropped"]) for c in cc + dc + fc + gc],
        tolerance=LM_TOL, logits_finite=bool(torch.isfinite(lk).all()
                                             and torch.isfinite(ld).all()))
    summary.update(checks)
    print(f"{tag} checks (rel_err: both runs with the same routing; "
          f"_own_routing: each with its router's own picks, reported): "
          f"{checks}", flush=True)
    if cfg.moe is not None:
        moe = [dict(layer=i, C=c["C"], dropped=int(c["dropped"]),
                    of_pairs=int(c["ids"].numel()),
                    max_load_over_C=int(c["max_load"]) / c["C"])
               for i, c in enumerate(kc)]
        summary["moe_prefill"] = moe
        print(f"{tag} moe prefill (capacity factor "
              f"{cfg.moe.capacity_factor}): {moe}", flush=True)
    if not (checks["logits_finite"]
            and checks["prefill_rel_err_kernel_vs_plain"] <= LM_TOL
            and checks["decode_rel_err_vs_full_forward"] <= LM_TOL
            and not any(checks["decode_check_dropped"])):
        raise AssertionError(f"{tag}: logits off their plain versions")
    positions = torch.full((B, 1), pos, dtype=torch.int32, device="cuda")
    _profile(f"{tag} decode step", lambda: M.decode_step(
        cfg, params, cache, nxt, positions), torch, reps=3)
    _profile(f"{tag} prefill", lambda: M.prefill(
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
    ap.add_argument("--scf-sweeps", type=int, default=SMOKE_SCF_SWEEPS,
                    help="scf sweeps a level in phase 11 (PSCConfig's is "
                    f"{SCF_SWEEPS}; the default {SMOKE_SCF_SWEEPS} is a cut)")
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
    by_path, final_U, hvp_counts, flat = {}, {}, {}, {}
    for mode in ("graphblas", "matrix_free"):
        used = ["sellcs_spmm", "sellcs_plap_apply", "kmeans_assign"]
        if mode == "matrix_free":
            used.append("sellcs_plap_hvp")
        by_path[f"sellcs/{mode}"], res = flat_phase(
            "main", W, counters, torch, psc, "sellcs", mode, used, args)
        final_U[mode] = res.U
        hvp_counts[f"sellcs/{mode}"] = res.hvp_counts
        flat[mode] = dict(labels=res.labels, hvps=sum(res.hvp_counts),
                          rcut=res.rcut, launches=by_path[f"sellcs/{mode}"],
                          wall_s=by_path[f"sellcs/{mode}"]["wall_s"])
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
    del final_U
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
    rows += flash_kernel_phase(torch)
    phase_done("dense_kernels")
    by_path["lm_serve"], lm = lm_serve_phase(torch, counters)
    phase_done("lm_serve")
    lm = {"gemma-2b": lm}
    for arch in ("mixtral-8x22b", "deepseek-v3-671b"):
        by_path[f"lm_serve/{arch}"], lm[arch] = lm_serve_phase(
            torch, counters, arch)
        phase_done(f"lm_serve/{arch}")

    # ---- resilience and telemetry, on the SELL-C-σ graph again
    paths, resilience = resilience_phase(W, counters, torch, psc,
                                         flat["matrix_free"], args)
    by_path.update(paths)
    phase_done("resilience")

    # ---- the clustering serve engine: bucket, solo and multilevel lanes
    paths, serve = serve_phase(W, counters, torch, psc, flat["matrix_free"],
                               args)
    by_path.update(paths)
    phase_done("serve")

    # ---- the distributed SpMM: four ranks on the one card over gloo
    paths, dist_rows, dist_summary = dist_phase(W, counters, torch, args)
    by_path.update(paths)
    phase_done("dist")

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
        if row["name"] == "sellcs_plap_apply":
            row["launches_by_k"] = {p: c["sellcs_plap_apply_by_k"]
                                    for p, c in by_path.items()
                                    if c.get("sellcs_plap_apply_by_k")}
    rows += dist_rows        # their launches are the ranks' own counts
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
    print(json.dumps({"resilience": resilience}, default=str), flush=True)
    print(json.dumps({"serve": serve}, default=str), flush=True)
    print(json.dumps({"dist": dist_summary}, default=str), flush=True)
    print(json.dumps({"kernels": rows, "card": smi}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
