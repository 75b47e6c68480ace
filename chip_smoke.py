#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py [--newton-iters 30] [--tcg-iters 20]

Phases, none of which catches its own failure:

  1. device: the card's name and power limit (nvidia-smi), the torch and
     CUDA versions, then the build of the SELL-C-σ kernels from
     ``src/repro_torch/kernels/sellcs_spmm/csrc`` into ``build/torch_ext``.
  2. kernels: on ``delaunay_graph(20)`` (n = 2^20, SELL-C-σ with C=32) and
     k=4 fp32 multivectors, each kernel's wrapper against its plain
     PyTorch version on the card, with the tolerance of the fp32 parity
     tests (|kernel - plain| <= 2e-5 + 2e-4 |plain|), and its time
     (median of CUDA-event timed runs), the plain version's time, the
     byte bound of the card and, for the reals ring, ``torch.sparse.mm``
     on the CSR form of W (timed only as a yardstick; the port never
     calls it).
  3. main path: ``p_spectral_cluster(W, PSCConfig(k=4, backend="sellcs"))``
     with ``hvp_mode="graphblas"`` and ``"matrix_free"``.  Each run starts
     from zeroed launch counts; it fails unless every kernel the mode uses
     launched, RCut is finite and at most 1.01 x the p=2 start's, and
     U^T U is within 1e-4 of I.
  4. breakdown: at the final U of each mode and p = 1.2, the host time of
     one value, one gradient and one Hessian apply (the three callbacks of
     the trust-region loop), and a torch.profiler window over a few
     Hessian applies: the device's busy share of the window and the
     kernels that take the most device time.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.  Without a CUDA device, or
without ``src/repro_torch`` beside this script, it exits non-zero and
prints no result.
"""
from __future__ import annotations

import argparse
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
RTOL, ATOL = 2e-4, 2e-5        # fp32 bounds of the kernel parity tests
P, EPS = 1.2, 1e-8             # PSCConfig's p_target and eps
GRAPH_R = 20                   # delaunay_graph(20): n = 1,048,576


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


def _compare(name: str, got, want) -> tuple:
    import torch

    err = (got - want).abs()
    bad = err > ATOL + RTOL * want.abs()
    max_abs = float(err.max())
    max_rel = float((err / want.abs().clamp(min=1e-30)).max())
    print(f"{name}: max_abs_err={max_abs!r} max_rel_err={max_rel!r} "
          f"tolerance=|d|<={ATOL}+{RTOL}|plain| "
          f"violations={int(bad.sum())}", flush=True)
    if not bool(torch.isfinite(got).all()) or bool(bad.any()):
        raise AssertionError(f"{name}: kernel disagrees with its plain version")
    return max_abs, max_rel


def _layout_bytes(L, itemsize: int) -> int:
    """Bytes of the layout arrays a launch reads once (int32 slice
    offsets, widths, perm and column ids; the stored values)."""
    return (4 * (L.slice_ptr.numel() + L.slice_w.numel() + L.perm.numel()
                 + L.cols.numel()) + itemsize * L.vals.numel())


def _bound(bytes_moved: int, ops: int) -> tuple:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_phase(W, K, torch) -> list:
    """Each kernel against its plain version at the main path's shapes."""
    n, k = W.n_rows, 4
    L = W.sell_kernel
    item = 4
    slot_cols = L.slots * k
    gen = torch.Generator(device="cuda").manual_seed(0)
    X = torch.randn((n, k), generator=gen, device="cuda")
    U = torch.linalg.qr(torch.randn((n, k), generator=gen, device="cuda"))[0]
    U = U.contiguous()
    E = 0.1 * torch.randn((n, k), generator=gen, device="cuda")
    dense_bytes = n * k * item
    rows = []

    # reals ring, scalar values (the LOBPCG Laplacian matvec)
    got, want = K.sellcs_spmm(W, X), K.sellcs_spmm_plain(W, X)
    err = _compare("sellcs_spmm", got, want)
    csr = torch.sparse_coo_tensor(
        torch.stack([W.rows.long(), W.cols.long()]), W.vals,
        (n, n)).coalesce().to_sparse_csr()
    lib_want = torch.sparse.mm(csr, X)
    _compare("sellcs_spmm vs torch.sparse.mm", got, lib_want)
    bound = _bound(_layout_bytes(L, item) + 2 * dense_bytes, 2 * slot_cols)
    # reals ring, (nnz, k) multivalues (the Algorithm-1 W-hat SpMM)
    mv = torch.rand((W.nnz, k), generator=gen, device="cuda")
    Wh = W.with_vals(mv)
    got_mv, want_mv = K.sellcs_spmm(Wh, X), K.sellcs_spmm_plain(Wh, X)
    err_mv = _compare("sellcs_spmm multivalue", got_mv, want_mv)
    bound_mv = _bound(_layout_bytes(Wh.sell_kernel, item) + 2 * dense_bytes,
                      2 * slot_cols)
    rows.append(dict(
        name="sellcs_spmm", route="cuda",
        source="src/repro_torch/kernels/sellcs_spmm/csrc/sellcs_kernels.cu",
        replaces="src/repro/kernels/sellcs_spmm/sellcs_spmm.py:95",
        max_abs_err=err[0], max_rel_err=err[1],
        ms=_time_ms(lambda: K.sellcs_spmm(W, X)),
        plain_ms=_time_ms(lambda: K.sellcs_spmm_plain(W, X), 3, 3),
        bound_ms=bound[0], bound_by=bound[1],
        library_ms=_time_ms(lambda: torch.sparse.mm(csr, X)),
        multivalue=dict(
            max_abs_err=err_mv[0], max_rel_err=err_mv[1],
            ms=_time_ms(lambda: K.sellcs_spmm(Wh, X)),
            plain_ms=_time_ms(lambda: K.sellcs_spmm_plain(Wh, X), 3, 3),
            bound_ms=bound_mv[0], bound_by=bound_mv[1])))
    del csr, lib_want, mv, Wh

    # p-Laplacian apply (the gradient op)
    got = K.sellcs_plap_apply(W, U, P, EPS)
    want = K.sellcs_plap_apply_plain(W, U, P, EPS)
    err = _compare("sellcs_plap_apply", got, want)
    bound = _bound(_layout_bytes(L, item) + 2 * dense_bytes, 6 * slot_cols)
    rows.append(dict(
        name="sellcs_plap_apply", route="cuda",
        source="src/repro_torch/kernels/sellcs_spmm/csrc/sellcs_kernels.cu",
        replaces="src/repro/kernels/sellcs_spmm/sellcs_spmm.py:109",
        max_abs_err=err[0], max_rel_err=err[1],
        ms=_time_ms(lambda: K.sellcs_plap_apply(W, U, P, EPS)),
        plain_ms=_time_ms(lambda: K.sellcs_plap_apply_plain(W, U, P, EPS),
                          3, 3),
        bound_ms=bound[0], bound_by=bound[1], library_ms=None))

    # matrix-free Newton HVP
    got = K.sellcs_plap_hvp(W, U, E, P, EPS)
    want = K.sellcs_plap_hvp_plain(W, U, E, P, EPS)
    err = _compare("sellcs_plap_hvp", got, want)
    bound = _bound(_layout_bytes(L, item) + 3 * dense_bytes, 12 * slot_cols)
    rows.append(dict(
        name="sellcs_plap_hvp", route="cuda",
        source="src/repro_torch/kernels/sellcs_spmm/csrc/sellcs_kernels.cu",
        replaces="src/repro/kernels/sellcs_spmm/sellcs_spmm.py:124",
        max_abs_err=err[0], max_rel_err=err[1],
        ms=_time_ms(lambda: K.sellcs_plap_hvp(W, U, E, P, EPS)),
        plain_ms=_time_ms(lambda: K.sellcs_plap_hvp_plain(W, U, E, P, EPS),
                          3, 3),
        bound_ms=bound[0], bound_by=bound[1], library_ms=None))
    for row in rows:
        print(f"{row['name']}: kernel_ms={row['ms']!r} "
              f"twin_ms={row['plain_ms']!r} bound_ms={row['bound_ms']!r} "
              f"({row['bound_by']}) library_ms={row['library_ms']!r}",
              flush=True)
    return rows


def main_path_phase(W, K, torch, psc, mode: str, args) -> dict:
    """One p_spectral_cluster run; returns the launch counts it made."""
    cfg = psc.PSCConfig(k=4, backend="sellcs", hvp_mode=mode,
                        newton_iters=args.newton_iters,
                        tcg_iters=args.tcg_iters)
    K.reset_launch_counts()
    t0 = time.perf_counter()
    res = psc.p_spectral_cluster(W, cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    print(f"main[{mode}]: wall_s={wall!r} stage_s={res.stage_seconds} "
          f"init_rcut={res.init_rcut!r} rcut={res.rcut!r} ncut={res.ncut!r} "
          f"p_path={res.p_path} hvp_counts={res.hvp_counts} "
          f"fvals={res.fvals} launches={launches}", flush=True)
    used = ["sellcs_spmm", "sellcs_plap_apply"]
    if mode == "matrix_free":
        used.append("sellcs_plap_hvp")
    for name in used:
        if launches[name] < 1:
            raise AssertionError(f"main[{mode}]: {name} never launched")
    if not math.isfinite(res.rcut):
        raise AssertionError(f"main[{mode}]: rcut {res.rcut} not finite")
    if not res.rcut <= res.init_rcut * 1.01 + 1e-9:
        raise AssertionError(f"main[{mode}]: rcut {res.rcut} above "
                             f"1.01 x init_rcut {res.init_rcut}")
    G = res.U.T @ res.U
    orth = float((G - torch.eye(G.shape[0], device=G.device)).abs().max())
    print(f"main[{mode}]: max|U^T U - I|={orth!r}", flush=True)
    if not orth <= 1e-4:
        raise AssertionError(f"main[{mode}]: U^T U off identity by {orth}")
    if len(np.unique(res.labels)) != cfg.k:
        raise AssertionError(f"main[{mode}]: labels use "
                             f"{len(np.unique(res.labels))} of {cfg.k} "
                             "clusters")
    return launches, res.U          # in the layout the solver left it


def breakdown_phase(W, torch, mode: str, U) -> None:
    """Host ms of the trust-region callbacks at U, and where the device
    time of a window of Hessian applies goes."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import plap
    from repro_torch.core.grassmann import proj
    from repro_torch.grblas import Descriptor

    desc = Descriptor(backend="sellcs")
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
    print(f"breakdown[{mode}]: host_ms_per_call={host}", flush=True)

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
    print(f"breakdown[{mode}]: hvp window {reps} calls wall_ms={window_ms!r} "
          f"device_ms={device_ms!r} busy_share={device_ms / window_ms!r} "
          f"kernel_launches={sum(e.count for e in kernels)}", flush=True)
    kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
    for e in kernels[:8]:
        print(f"breakdown[{mode}]:   {e.self_device_time_total / 1e3 / reps!r}"
              f" ms/hvp x{e.count // reps} {e.key[:90]}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--newton-iters", type=int, default=30)
    ap.add_argument("--tcg-iters", type=int, default=20)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import psc
    from repro_torch.graphs import delaunay_graph
    from repro_torch.kernels import sellcs_spmm as K

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(f"torch={torch.__version__} cuda={torch.version.cuda} "
          f"device={torch.cuda.get_device_name(0)}", flush=True)
    print(f"build_s={K.build()!r}", flush=True)

    t0 = time.perf_counter()
    W, _ = delaunay_graph(GRAPH_R, device="cuda", build_sellcs=True,
                          sell_c=32)
    print(f"graph: delaunay_graph({GRAPH_R}) n={W.n_rows} nnz={W.nnz} "
          f"sell_slots={W.sell_kernel.slots} "
          f"sellcs_fill={W.sellcs_fill_ratio()!r} "
          f"runs={len(W.sell_cols)} build_s={time.perf_counter() - t0!r}",
          flush=True)

    rows = kernel_phase(W, K, torch)
    if (args.newton_iters, args.tcg_iters) != (30, 20):
        print(f"iteration budget cut: newton_iters={args.newton_iters} "
              f"tcg_iters={args.tcg_iters} (PSCConfig default 30/20)",
              flush=True)
    total = {name: 0 for name in K.LAUNCHES}
    by_mode, final_U = {}, {}
    for mode in ("graphblas", "matrix_free"):
        by_mode[mode], final_U[mode] = main_path_phase(W, K, torch, psc,
                                                       mode, args)
        for name, count in by_mode[mode].items():
            total[name] += count
    for mode, U in final_U.items():
        breakdown_phase(W, torch, mode, U)
    for row in rows:
        row["launches"] = total[row["name"]]
        row["launches_by_mode"] = {m: c[row["name"]] for m, c in by_mode.items()}

    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
