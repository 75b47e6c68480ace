#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py [--newton-iters 30] [--tcg-iters 20] [--scf-sweeps 2]
    python3 chip_smoke.py --sellcs-src SRC
    python3 chip_smoke.py --kmeans-src SRC
    python3 chip_smoke.py --flash-src SRC

The second form only times the SELL-C-σ kernels of the tree whose
``src`` directory is SRC (this one, or an older commit unpacked with
``git archive``) at the shapes of phase 2 and each wrapper at k = 1,
the third ``kmeans_assign``
at the main path's shape, at stage 3's k = 48 fp64 and k = 70 fp32 and
at k = 16, 17, 24 and 32 in both dtypes (2^20 points, 8 sets), also by
the profiler's device time, the fourth the flash kernel at the served
prefill shapes of phase 9 (Gemma's, mixtral's, jamba's and deepseek's
MLA); each prints one JSON line with every call's
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
     k = 4, and the apply at k = 1 (the inverse_power solver's one
     column, the row kernel's width-1 instance: it fails unless equal
     bit for bit to the generic variant, timed beside it);
     ``grblas.ops.fused_plap_apply`` at
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
     with window = 512, at D 128 with group 4, at mixtral-8x22b's
     prefill shape (B 2, Hq 48, Hkv 8, S 6144, D 128, window 4096) and
     at jamba-1.5-large's (B 2, Hq 64, Hkv 8, S 4096, D 128, causal) and
     at deepseek-v3's MLA prefill shape (B 4, Hq = Hkv = 128, S 2048, q/k
     head dim 192, value head dim 128 taken as is, group 1: two query
     tiles of one head a block), at whisper-small's four (B 8, 12 heads
     of 64, group 1: the encoder's non-causal 1500 x 1500, the decoder's
     causal 416 x 416, and the cross-attention's non-causal 416 x 1500
     in prefill and 1 x 1500 in a decode step) and at internvl2-1b's
     prefill (B 4, Hq 14, Hkv 2: group 7, S 2048, D 64, causal; all
     twelve on the wgmma kernel), then the
     mma.sync kernel at D 32 and the fp32 kernel at
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
     shared one); mamba2-780m (fp32 parameters, all 48 layers,
     attention-free; 4 requests of 2048 tokens, 8 SSD chunks each);
     Jamba-1.5-Large (bf16 parameters, 5 of 72 layers: Mamba2 + MLP,
     Mamba2 + MoE twice, then attention + MLP, printed as a cut with its
     parameter count; 2 requests of 4096 tokens; 16 experts top 2 at
     capacity factor 1.25); whisper-small (fp32 parameters, whole: 12
     encoder and 12 decoder layers, LayerNorm, learned positions; 8
     requests of 1500 stub frames and 416-token prompts, 416 + 32 its
     448-token decoder context); internvl2-1b (fp32 parameters, whole:
     24 layers; 4 requests of 256 stub patch embeddings and 1792
     tokens, 2048 positions).  Each fails unless the prefill launched
     the flash kernel its head dim routes to once per attention layer
     (whisper: 12 encoder + 12 self + 12 cross = 36) and no other
     (wgmma for Gemma, mixtral, deepseek's D 192, jamba, whisper and
     InternVL2, none for mamba2, whose kernel-vs-plain check is
     printed as vacuous), the served run launched it that many times
     plus whisper's 12 cross-attentions a decode step, the logits are
     finite, the last-token prefill logits through the kernel are within
     2^-5 relative of the same prefill through the plain attention (the
     router picks that differ between the two printed beside it), and
     one decode step's logits are within 2^-5 relative of a full
     forward's over the same tokens (the MoE models under a capacity
     factor of n_experts / top_k, C = T, so no pair drops in either; on
     deepseek's 128-token prompts, where the no-drop buffer fits; on
     255-token prompts for mamba2 and jamba, whose SSD takes one chunk
     of 256 or a multiple; InternVL2's decode at position 256 + 1792,
     the patches counted, and its forward over the same patches).
     Each MoE layer's dropped pairs and largest expert load over C in
     the prefill are printed, from the port's
     router on the layer's input, outside the timed run; and a profiler
     window of one decode step and one prefill.  For mamba2 and jamba,
     layer 0's ``mamba_train`` over 1024 tokens (4 chunks: the
     inter-chunk scan) must agree within 2^-5 relative, outputs and
     final state, with ``mamba_decode`` run token by token from a zero
     fp32 cache.
 10b. LM training (``lm_train/gemma-2b``, ``lm_train_phase``): Gemma-2B
     whole (2.51 B seeded fp32 parameters, bf16 compute, remat "full",
     AdamW: some 40 GB of parameters, grads and moments) on
     ``SyntheticTokens`` of 4 x 2048 tokens, cycling over 4 batches.  At
     step 0 the loss and grads through the kernel against the same
     through the plain attention: the loss and the global grad norm
     within 2^-5 relative, the grads of ``blocks.0.attn.wq`` and
     ``embed.table`` within 2^-4 (Frobenius).  Then 12 steps of
     ``make_train_step`` (lr 1e-3 after 2 warmup steps, a cosine to
     1e-4): it fails unless every loss is finite, the last is 0.3 or more
     below step 0's (the reference's criterion) and the wgmma flash
     kernel launched 36 times a step (18 forward, 18 in the remat
     recompute).  Printed: the median step time from step 2 on, tokens/s,
     6 N tokens a step over it against 989 TFLOP/s, the peak memory, the
     CUDA-event times of the attention backward (through
     ``attention_ref``) and the optimizer update in the steps, one more
     step under the profiler (busy share, top kernels), and each of the
     two spans alone by the profiler's device time.  No checkpoint at this size
     (40 GB of .npy).  Then ``launch/train.py`` at ``--reduced`` on the
     card in a temporary directory: 6 steps, ``--resume`` to 9 from step
     6; and a bf16 tree through ``CheckpointManager``, restored bit for
     bit.
 10c. LM serving over a mesh (``lm_mesh/mixtral-8x22b``,
     ``lm_mesh_phase``): the one-process meshless run of Mixtral-8x22B at
     full width cut to MESH_LAYERS (2) of 56 layers (seeded bf16
     weights; the last-token prefill logits and one decode step's at
     capacity factor 1.25 and at MESH_NO_DROP_CF, 2.0), then four ranks
     spawned on the one card over gloo as a (data 1, model 4) mesh
     (``make_host_mesh``), each drawing its quarter of the same global
     weights (``init_params(..., mesh=)``): the ServeEngine under the
     mesh serves 2 x 6144 prompts and 32 greedy tokens from zeroed
     counts (the all-to-all MoE in prefill, the EP psum MoE and
     flash-decoding over the sequence-sharded cache in decode); it fails
     unless each rank launched the wgmma flash kernel once a layer, the
     ranks served the same tokens, the prefill and decode logits at 2.0
     are within 2^-5 relative of the meshless run's with no pair dropped
     anywhere, and the kernel on a rank's heads of layer 0 (q (2, 12,
     6144, 128), k/v (2, 2, 6144, 128), window 4096: row 8i, timed
     ranks in turn beside the plain attention, its bound and SDPA) is
     within 2^-5 of the plain attention.  Printed: each rank's mesh
     coordinates and shard bytes, prefill s, decode ms a token, peak
     memory, the drops by layer at 1.25, the error against the meshless
     run at 1.25, and one prefill's collectives (calls, bytes, seconds by
     kind, each synced).  Then, the serving weights freed, the int8
     compressed DP train step on ranks 0-1 (MESH_TRAIN_DATA, a cut of
     four: a replica peaks at some 23 GB): Gemma-2B at full width cut to
     1 layer, DP_RULES, one 2048-token sequence a replica, 3 steps; it
     fails unless every loss is finite and the replicas' parameters and
     residuals are equal bit for bit after each step.  Then, in the
     same four ranks, the other families (``MESH_FAMILIES``, each at full
     width with its depth cut, over (data 1, model 4), their one-process
     meshless runs on the same seeded weights made before the spawn):
     mamba2-780m (2 of 48 layers; 4 x 2048 prompts), Jamba-1.5-Large
     (lm_serve's 5 of 72 layers; 2 x 4096; capacity factor 2.0 on both
     sides), whisper-small (2 of 12 encoder and 2 of 12 decoder layers;
     8 x (1500 frames + 416 tokens)) and internvl2-1b (2 of 24 layers; 4
     x (256 patches + 1792 tokens), its 14 heads spreading the batch),
     8 greedy tokens each, every rank drawing its blocks in turn: each
     fails unless every rank launched the flash kernel once an attention
     layer of the prefill (and whisper's cross-attention once a layer a
     decode step), the ranks served the same tokens, no pair dropped,
     the last-token prefill logits and one decode step's, gathered, are
     within 2^-5 relative of the meshless run's, and the kernel on each
     rank's block of every attention kind it ran is within 2^-5 of the
     plain attention (rows 8j-8m timed on rank 0 alone: jamba's 16 of
     64 heads, whisper's encoder and cross-attention on 3 of 12 heads,
     InternVL2's 14 heads on a quarter of the batch).  Then Gemma-2B at
     full width cut to 1 layer trains 3 AdamW steps over (data 2, model
     2) under DEFAULT_RULES (``lm_mesh_train/gemma-2b``, 2 x 2048 tokens
     a step): it fails unless step 0's loss and gradients, gathered, are
     within 2^-4 relative (Frobenius) of a one-process step's on the same
     weights and batch, every loss is finite and each block's two
     replicas are equal bit for bit after every step.  The seconds of
     these paths with their references are printed (a budget of 90 s).
 10d. the dry-run accounting (``repro_torch.launch.dryrun``), on the meta
     device: (a) the grid, every (arch x shape x mesh) run of the
     reference's, rank 0 of the production meshes (16, 16) and (2, 16,
     16), one line each (status, bytes a device, bottleneck) and the
     grid's seconds, run by a child process of its own (``--dryrun-grid
     OUT``; no card) started before phase 2 and collected after phase
     13; it fails on a FAIL or on counts other than 66 ``ok`` and 14
     ``skip``.  Checked against the card in the phases before it: (b) in ``lm_serve/gemma-2b``, the dry account
     of its prefill on one device: parameter and decode-cache bytes, and
     the dot and flash counts of one prefill counted on the card
     (``dryrun.count_step``), all exactly; the predicted peak over the
     card's (parameters and tokens plus the prefill's rise of
     ``max_memory_allocated``) within 0.75-1.33; (c) in
     ``lm_mesh/mixtral-8x22b``, the dry rank of each real rank: shard
     bytes and one prefill's collective calls and payload bytes by kind
     exactly, its predicted peak over the rank's served peak printed;
     (d) in ``lm_train/gemma-2b``, one dry train step: parameter plus
     AdamW bytes exactly, its predicted peak over the last step's
     (arguments plus the step's rise) within 0.75-1.33; (c') in
     ``lm_mesh/whisper-small``, each rank's dry rank: shard bytes and one
     prefill's collective calls and payload bytes exactly, the predicted
     peak over the card's (shard and input bytes plus the prefill's
     rise) within 0.75-1.33; (d') in ``lm_mesh_train/gemma-2b``, each
     rank's dry train step on a dry (2, 2) mesh: parameter plus AdamW
     bytes and step 1's collective calls and payload bytes exactly, the
     predicted peak over step 1's within 0.75-1.33.
 10e. the lanes' graph: phases 11-13 repeat whole solves and
     products, so they run on ``delaunay_graph(LANE_GRAPH_R)`` (18: n =
     262,144, SELL-C-σ with C = 32; a cut of phase 2's r = 20, printed),
     with a matrix_free sellcs solve there held as phase 3's are (path
     ``lanes/sellcs/matrix_free``): "the lanes' solve" below.
 11. resilience and telemetry, on the lanes' SELL-C-σ graph (C = 32,
     k = 4, fp32): (a) ``solver="guarded", validate=True,
     trace=True`` with matrix_free HVPs: it fails unless the recovery
     report is clean (no rung), the graph is one component
     (``connected_components``, its BFS hops and seconds printed), the
     labels, the HVP count and RCut equal the lanes' matrix_free solve,
     U^T U is within 1e-4 of I and the telemetry has the spans psc,
     init, continuation, solver.level, grblas.mxm and kmeans; its wall
     time is printed beside the lanes' solve's, with ``phase_breakdown()`` and
     ``coverage()``.  (b) ``solver="scf"`` with ``--scf-sweeps`` sweeps
     a level (default 1, printed as a cut of PSCConfig's 12, which
     ``--scf-sweeps 12`` restores): phase 3's checks but the RCut bound (printed beside
     newton's), ``sellcs_spmm`` at scalar k = 8 and 24 beyond stage 1's
     launches, every level's sweeps and subspace drift printed.  (c)
     ``solver="inverse_power", p_target=1.0``: it fails unless the apply
     launched at k = 1, the SELL-C-σ generic variant never did
     (``GENERIC_LAUNCHES``), U is finite and orthonormal within 1e-4.  (d)
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
     batch and graphs/s are printed.  (b) solo lane on the lanes'
     graph, ``PSCConfig(k=4, backend="sellcs", hvp_mode="matrix_free")``:
     the cold request equals the lanes' matrix_free solve (labels, RCut); a
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
     sellcs=True)`` places the lanes' graph (the V-cycle; its seconds, RCut,
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
HVP count of every flat solve is printed.  After each phase its seconds
and the running total are printed (``phase <name>: s (total s)``).

The cuts, each printed where it applies (the old value in brackets):
the lanes' graph ``LANE_GRAPH_R`` 18 (20), scf's ``SMOKE_SCF_SWEEPS``
1 (12), the dist phase's ``DIST_LOBPCG_ITERS`` 100 (200), and the
depths of the LM cells (``LM_CELLS``, ``MESH_LAYERS``,
``MESH_FAMILIES``, ``TP_TRAIN_LAYERS``, ``MESH_TRAIN_LAYERS``).  The
line before the
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
import importlib
import json
import math
import subprocess
import sys
import tempfile
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
LANE_GRAPH_R = 18              # a cut of GRAPH_R (20) for the phases that
                               # repeat whole solves or products (11, 12's
                               # solo and multilevel lanes, 13): n = 262,144,
                               # with a reference solve of their own, so the
                               # whole smoke keeps a quarter of its time limit
SCF_SWEEPS = 12                # PSCConfig's scf_sweeps
SMOKE_SCF_SWEEPS = 1           # the smoke's default, a cut of SCF_SWEEPS
RUNG_RCUT = 1.10               # a recovered solve's RCut over the clean one
BLOCK = 128                    # the reference's default BSR tile
PEAK_BAND = (0.75, 1.33)       # the dry run's predicted peak over the card's
DRYRUN_GRID = {"ok": 66, "skip": 14}   # runs of the grid
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
    # the apply at k = 1: the inverse_power solver's one column (the row
    # kernel's width-1 instance), bit-equal to the generic variant
    U1 = U[:, :1].contiguous()
    err1 = _compare("sellcs_plap_apply k=1", K.sellcs_plap_apply(
        W, U1, P, EPS), K.sellcs_plap_apply_plain(W, U1, P, EPS))
    _repeat("sellcs_plap_apply k=1",
            lambda: K.sellcs_plap_apply(W, U1, P, EPS))
    # the module (the package ``K`` re-exports only the public names)
    KM = importlib.import_module(f"{K.__name__}.sellcs_spmm")
    generic1 = lambda: KM._launch(  # noqa: E731
        "sellcs_plap_apply", W, U1, U1, P, EPS, generic=True)
    if not torch.equal(K.sellcs_plap_apply(W, U1, P, EPS), generic1()):
        raise AssertionError("sellcs_plap_apply k=1: the width-1 instance "
                             "and the generic variant differ")
    print("sellcs_plap_apply k=1: equal bit for bit to the generic variant",
          flush=True)
    bound1 = _bound(_layout_bytes(L, item) + 2 * n * item,
                    OPS["apply"] * L.slots)
    rows[-1]["k1"] = dict(
        max_abs_err=err1[0], max_rel_err=err1[1],
        plan=K.launch_plan("sellcs_plap_apply", n, 1, U1.dtype)._asdict(),
        ms=_time_ms(lambda: K.sellcs_plap_apply(W, U1, P, EPS)),
        generic_ms=_time_ms(generic1),
        device_ms=_device_ms(lambda: K.sellcs_plap_apply(
            W, U1, P, EPS))["per_call_ms"],
        generic_device_ms=_device_ms(generic1)["per_call_ms"],
        plain_ms=_time_ms(lambda: K.sellcs_plap_apply_plain(W, U1, P, EPS),
                          3, 3),
        bound_ms=bound1[0], bound_by=bound1[1], library_ms=None)
    print(f"sellcs_plap_apply k=1: kernel_ms={rows[-1]['k1']['ms']!r} "
          f"generic_variant_ms={rows[-1]['k1']['generic_ms']!r} "
          f"device_ms={rows[-1]['k1']['device_ms']!r} generic_variant_"
          f"device_ms={rows[-1]['k1']['generic_device_ms']!r} "
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
    launches["sellcs_generic"] = {
        name: c for K in counters
        for name, c in getattr(K, "GENERIC_LAUNCHES", {}).items()}
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
    """Phase 11 on the lanes' SELL-C-σ graph: the guarded, validated,
    traced solve held to the lanes' matrix_free solve (``ref``: its
    labels, HVPs, RCut, wall seconds and launches; phase 3's where the
    lanes run on its graph), the scf and inverse_power drivers,
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

    # (a) guarded, validated, traced: equal to the lanes' unguarded solve
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
    print(f"guarded: equal to the lanes' matrix_free solve: {same} (hvps "
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
    print(f"guarded: wall_s={wall!r} (the lanes' unguarded solve: "
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
    generic = by_path["inverse_power"]["sellcs_generic"]
    out["inverse_power"] = dict(
        wall_s=by_path["inverse_power"]["wall_s"], stage_s=res.stage_seconds,
        rcut=res.rcut, init_rcut=res.init_rcut, p_path=res.p_path,
        apply_k1_launches=k1, generic_launches=generic,
        clusters=int(len(np.unique(res.labels))))
    print(f"inverse_power: rcut={res.rcut!r} apply k=1 launches={k1} "
          f"generic variant launches={generic} "
          f"clusters={out['inverse_power']['clusters']}", flush=True)
    if k1 < 1:
        raise AssertionError("inverse_power: the apply never launched at k=1")
    if any(generic.values()):
        raise AssertionError(f"inverse_power: the generic variant launched "
                             f"({generic})")
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
    call under the profiler, which records the device's kernels only (a
    batched solve's millions of host-op events took minutes to
    aggregate).  The kernels' times are summed off the profiler's raw
    events: ``key_averages()`` builds an event object each, which for
    the ~10^5 kernels of a batched solve took 54 s."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    t1 = time.perf_counter()
    kernels = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            k = kernels.setdefault(e.name(), [0.0, 0])
            k[0] += e.duration_ns() / 1e6
            k[1] += 1
    print(f"profiler: {wall_ms / 1e3!r} s profiled, its kernels summed in "
          f"{time.perf_counter() - t1!r} s", flush=True)
    device_ms = sum(ms for ms, _ in kernels.values())
    top = sorted(((name[:60], ms, n) for name, (ms, n) in kernels.items()),
                 key=lambda t: t[1], reverse=True)[:6]
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

    t_lane = time.perf_counter()
    marks = {}

    def mark(name):
        marks[name] = time.perf_counter() - t_lane - sum(marks.values())

    graphs = {}
    for n, (p_in, p_out) in SERVE_SBM.items():
        sizes = [n // 4 + (i < n % 4) for i in range(4)]
        graphs[n] = [sbm_graph(sizes, p_in, p_out, seed=s, device=dev)[0]
                     for s in range(SERVE_PER_SIZE)]
    stream = [W for n in SERVE_SBM for W in graphs[n]]
    mark("graphs")
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

    mark("cold")
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

    mark("flat")
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

    mark("direct")
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
    mark("warm_scf")
    print(f"bucket lane seconds: {marks}", flush=True)
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
    """Phase 12 (b): the solo lane on the lanes' graph — cold,
    exact-tier repeat, pattern tier, weight-only churn.  ``ref`` is the
    lanes' matrix_free solve."""
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
        raise AssertionError(f"solo cold: differs from the lanes' "
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


def lane_graph_phase(W, counters, torch, psc, flat, by_path, args) -> tuple:
    """The graph of phases 11-13 and its reference matrix_free solve:
    ``delaunay_graph(LANE_GRAPH_R)`` (SELL-C-σ, C = 32) and a phase-3
    solve on it, held as phase 3's are (path ``lanes/sellcs/matrix_free``);
    phase 3's graph and solve where LANE_GRAPH_R is GRAPH_R."""
    from repro_torch.graphs import delaunay_graph

    if LANE_GRAPH_R == GRAPH_R:
        return W, flat["matrix_free"]
    print(f"graph cut: phases 11-13 on delaunay_graph({LANE_GRAPH_R}) (a "
          f"cut of delaunay_graph({GRAPH_R}), the flat paths' graph)",
          flush=True)
    del W
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    W, _ = delaunay_graph(LANE_GRAPH_R, device="cuda", build_sellcs=True,
                          sell_c=32)
    print(f"lane graph: delaunay_graph({LANE_GRAPH_R}) n={W.n_rows} "
          f"nnz={W.nnz} build_s={time.perf_counter() - t0!r}", flush=True)
    used = ["sellcs_spmm", "sellcs_plap_apply", "kmeans_assign",
            "sellcs_plap_hvp"]
    launches, res = flat_phase("lanes", W, counters, torch, psc, "sellcs",
                               "matrix_free", used, args)
    by_path["lanes/sellcs/matrix_free"] = launches
    return W, dict(labels=res.labels, hvps=sum(res.hvp_counts),
                   rcut=res.rcut, launches=launches,
                   wall_s=launches["wall_s"])


def serve_phase(W, counters, torch, psc, ref, args) -> tuple:
    """Phase 12: the clustering serve engine — the bucket lane, the solo
    and multilevel lanes on the lanes' graph."""
    by_path, out, secs = {}, {}, {}
    t0 = time.perf_counter()
    paths, out["bucket"] = bucket_lane_phase(W.device, counters, torch, psc)
    by_path.update(paths)
    secs["bucket"] = time.perf_counter() - t0
    paths, out["solo"] = solo_lane_phase(W, counters, torch, psc, ref, args)
    by_path.update(paths)
    secs["solo"] = time.perf_counter() - t0 - secs["bucket"]
    paths, out["multilevel"] = multilevel_lane_phase(W, counters, torch, psc,
                                                     args)
    by_path.update(paths)
    secs["multilevel"] = time.perf_counter() - t0 - sum(secs.values())
    print(f"serve lanes' seconds: {secs}", flush=True)
    out["lane_s"] = secs
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


FLASH_SHAPES = [  # (tag, B, Hq, Hkv, Sq, Sk, D, Dv, causal, window, dtype)
    ("serve", 4, 8, 1, 2048, 2048, 256, 256, True, None, "bfloat16"),
    ("ragged_S1000", 4, 8, 1, 1000, 1000, 256, 256, True, None, "bfloat16"),
    ("window512", 4, 8, 1, 2048, 2048, 256, 256, True, 512, "bfloat16"),
    ("D128_group4", 4, 8, 2, 2048, 2048, 128, 128, True, None, "bfloat16"),
    # mixtral-8x22b's prefill: 48 q heads over 8 kv heads, a window that
    # masks at S 6144
    ("mixtral_D128_group6_window4096", 2, 48, 8, 6144, 6144, 128, 128, True,
     4096, "bfloat16"),
    # jamba-1.5-large's prefill (its one attention layer a group): 64 q
    # heads over 8 kv heads, causal, no window
    ("jamba_D128_group8", 2, 64, 8, 4096, 4096, 128, 128, True, None,
     "bfloat16"),
    # deepseek-v3's MLA prefill: q/k 128 + 64 rotary, v 128 (group 1;
    # the wgmma kernel takes v 128 wide)
    ("mla_D192_Dv128", 4, 128, 128, 2048, 2048, 192, 128, True, None,
     "bfloat16"),
    # whisper-small's served shapes (8 requests, 12 heads of 64, group
    # 1): the encoder over 1500 frames (non-causal, a ragged last key
    # tile), the decoder's causal self-attention over its 416-token
    # prompt, and its cross-attention over the 1500 encoded frames in
    # prefill (Sq 416) and in each decode step (Sq 1)
    ("whisper_encoder", 8, 12, 12, 1500, 1500, 64, 64, False, None,
     "bfloat16"),
    ("whisper_self", 8, 12, 12, 416, 416, 64, 64, True, None, "bfloat16"),
    ("whisper_cross_prefill", 8, 12, 12, 416, 1500, 64, 64, False, None,
     "bfloat16"),
    ("whisper_cross_decode", 8, 12, 12, 1, 1500, 64, 64, False, None,
     "bfloat16"),
    # internvl2-1b's prefill: 256 patches + 1792 tokens, 14 q heads over
    # 2 kv heads (group 7, odd: each kv head's last pair idles a consumer)
    ("internvl2_group7", 4, 14, 2, 2048, 2048, 64, 64, True, None,
     "bfloat16"),
    # the kernels of the other routes: a head dim off wgmma's (the reduced
    # test configs' 16 and 32), and fp32
    ("mma_D32", 4, 8, 2, 2048, 2048, 32, 32, True, None, "bfloat16"),
    ("f32_D128", 1, 8, 2, 2048, 2048, 128, 128, True, None, "float32")]
# the shapes the --flash-src timing takes: the wgmma kernel's on the
# served paths (rows 8, 8a, 8b, 8c)
FLASH_AB = ("serve", "mixtral_D128_group6_window4096", "jamba_D128_group8",
            "mla_D192_Dv128")


def _flash_inputs(shape, gen, torch) -> tuple:
    _, B, Hq, Hkv, Sq, Sk, D, Dv, _, _, name = shape
    dtype = getattr(torch, name)
    return tuple(torch.randn(s, generator=gen, device="cuda", dtype=dtype)
                 for s in ((B, Hq, Sq, D), (B, Hkv, Sk, D),
                           (B, Hkv, Sk, Dv)))


def flash_kernel_phase(torch) -> list:
    """Flash attention against its plain version at the serve shape and
    eleven variants on the wgmma kernel (mixtral's D 128, group 6,
    window 4096, jamba's D 128, group 8, deepseek's MLA, D 192 with a
    value head dim of 128 at group 1, whisper's four at D 64 and group 1
    (its non-causal encoder, its cross-attention with Sq != Sk in prefill
    and decode) and InternVL2's D 64, group 7, among them), then the
    mma.sync kernel at D 32 and the fp32 kernel; returns the rows of the
    two kernels the serve paths run, wgmma at Gemma's shape (its
    launches: every served model's but mamba2's) and at MLA's
    (deepseek's launches), and the mma.sync kernel's (on no served
    path)."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as KF
    from repro_torch.launch.op_count import flash_counts

    gen = torch.Generator(device="cuda").manual_seed(2)
    out = {}
    for shape in FLASH_SHAPES:
        tag, B, Hq, Hkv, Sq, Sk, D, Dv, causal, window, _ = shape
        q, k, v = _flash_inputs(shape, gen, torch)
        dtype = q.dtype
        variant = KF.kernel_variant(dtype, D, Sk)
        name = f"flash_attention_{variant}"
        before = KF.LAUNCHES[name]
        got = KF.flash_attention(q, k, v, causal=causal, window=window)
        if KF.LAUNCHES[name] != before + 1 or got.shape[-1] != Dv:
            raise AssertionError(f"flash_attention[{tag}]: {name} did not "
                                 "launch once, or the output is not Dv wide")
        # fp32 math on the same inputs; query-chunked where the (Sq, Sk)
        # scores of every head would not fit beside the rest
        ref = (KF.attention_ref if B * Hq * Sq * Sk * 4 <= 2 ** 32
               else KF.attention_ref_chunked)
        ref32 = ref(q.float(), k.float(), v.float(), causal=causal,
                    window=window)
        if dtype == torch.float32:
            err = _compare(f"flash_attention[{tag}] ({variant})", got, ref32)
        else:
            err = _compare_bf16(f"flash_attention[{tag}] ({variant})", got,
                                ref32, torch)
        plain = KF.plain_attention(q, k, v, causal=causal, window=window)
        err_plain = float((got.float() - plain.float()).abs().max())
        del ref32, plain
        if window is None:
            # SDPA's is_causal aligns the mask at the top left, as the
            # kernel does (key <= query); the causal shapes have Sq = Sk
            lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                q, k, v, is_causal=causal, enable_gqa=True)
        else:
            i = torch.arange(Sq, device="cuda")
            j = torch.arange(Sk, device="cuda")
            mask = (j[None, :] <= i[:, None]) & (j[None, :] > i[:, None]
                                                 - window)
            lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                q, k, v, attn_mask=mask, enable_gqa=True)
        flops, nbytes = flash_counts(q, k, v, causal, window)
        bound = _bound(nbytes, flops, BF16_OPS_PER_S
                       if dtype == torch.bfloat16 else FP32_OPS_PER_S)
        row = dict(shape=dict(B=B, Hq=Hq, Hkv=Hkv, Sq=Sq, Sk=Sk, D=D, Dv=Dv,
                              window=window, causal=causal,
                              dtype=str(dtype).split(".")[-1]),
                   variant=variant, max_abs_err=err[0], max_rel_err=err[1],
                   max_abs_err_vs_plain=err_plain,
                   ms=_time_ms(lambda: KF.flash_attention(
                       q, k, v, causal=causal, window=window)),
                   plain_ms=_time_ms(lambda: KF.plain_attention(
                       q, k, v, causal=causal, window=window), 3, 3),
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

    def kernel_row(name, variant, source, main, others, paths=None):
        r = out[main]
        if r["variant"] != variant:
            raise AssertionError(f"{name}: {main} ran on {r['variant']}, "
                                 f"not {variant}")
        row = _row(name,
                   f"src/repro_torch/kernels/flash_attention/csrc/{source}",
                   "src/repro/kernels/flash_attention/flash_attention.py:74",
                   (r["max_abs_err"], r["max_rel_err"]), r["ms"],
                   r["plain_ms"], (r["bound_ms"], r["bound_by"]),
                   r["library_ms"])
        # the serve paths' launches of this kernel are read from this
        # counter (on ``paths`` only, where given)
        row["counter"] = f"flash_attention_{variant}"
        row["paths"] = paths
        row["shape"] = r["shape"]
        row["variants"] = {tag: out[tag] for tag in others}
        return row

    return [kernel_row("flash_attention", "wgmma",
                       "flash_attention_wgmma.cu", "serve",
                       ["ragged_S1000", "window512", "D128_group4",
                        "mixtral_D128_group6_window4096",
                        "jamba_D128_group8", "whisper_encoder",
                        "whisper_self", "whisper_cross_prefill",
                        "whisper_cross_decode", "internvl2_group7"]),
            kernel_row("flash_attention_mla", "wgmma",
                       "flash_attention_wgmma.cu", "mla_D192_Dv128", [],
                       paths=["lm_serve/deepseek-v3-671b"]),
            kernel_row("flash_attention_mma", "mma", "flash_attention.cu",
                       "mma_D32", [])]


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
    # the SSD takes a prompt of at most one chunk (256) or a multiple of
    # it, so the decode check's forward runs over 255 + 1 tokens
    "mamba2-780m": (None, 4, 2048, 32, 255),
    # 5 of 72 layers: m+MLP, m+MoE, m+MLP, m+MoE, a+MLP (every kind of
    # layer jamba has; 6 would add a MoE layer, 67 GB of weights)
    "jamba-1.5-large-398b": (5, 2, 4096, 32, 255),
    # 1500 encoder frames a request; 416 + 32 = 448, whisper's decoder
    # context
    "whisper-small": (None, 8, 416, 32, 416),
    # 256 patch embeddings + 1792 tokens: 2048 positions a request
    "internvl2-1b": (None, 4, 1792, 32, 1792),
}
SCAN_CHECK_TOKENS = 1024       # the SSD scan check: 4 chunks of 256


def _cut(full, n_layers):
    """The config at full width with its depth cut to n_layers (a hybrid
    model's group pattern cut with it)."""
    if n_layers is None:
        return full
    if full.family == "hybrid":
        return dataclasses.replace(full, n_layers=n_layers,
                                   hybrid_group=full.hybrid_group[:n_layers])
    return dataclasses.replace(full, n_layers=n_layers)


def _attention_layers(cfg) -> int:
    """Flash launches a prefill: one an attention layer (whisper: its
    encoder's, and its decoder's self- and cross-attention)."""
    if cfg.family == "ssm":
        return 0
    if cfg.family == "hybrid":
        return cfg.hybrid_group.count("a") * (cfg.n_layers
                                              // len(cfg.hybrid_group))
    if cfg.family == "encdec":
        return cfg.enc_layers + 2 * cfg.n_layers
    return cfg.n_layers


def _cross_layers(cfg) -> int:
    """Flash launches a decode step: whisper's cross-attention, one a
    decoder layer (the reference recomputes the memory's k and v at
    every step); the self-attention decodes without the kernel."""
    return cfg.n_layers if cfg.family == "encdec" else 0


def _front_end(cfg, B, torch) -> dict:
    """The stub front end's seeded input on the card: whisper's (B,
    enc_seq, d) frames, InternVL2's (B, vis_seq, d) patch embeddings."""
    rng = np.random.default_rng(1)
    if cfg.family == "encdec":
        shape, name = (B, cfg.enc_seq, cfg.d_model), "enc_frames"
    elif cfg.family == "vlm":
        shape, name = (B, cfg.vis_seq, cfg.d_model), "extra_embeds"
    else:
        return {}
    return {name: torch.as_tensor(rng.standard_normal(shape).astype(
        np.float32), device="cuda")}


def _rel(a, b) -> float:
    return float((a.float() - b.float()).norm() / b.float().norm())


def ssd_scan_check(tag, cfg, params, tok, torch) -> dict:
    """Layer 0's Mamba2 block over SCAN_CHECK_TOKENS tokens (several SSD
    chunks, so the inter-chunk scan runs): ``mamba_train(...,
    return_state=True)`` against ``mamba_decode`` token by token from a
    zero fp32 cache (the exact recurrence), on the layer's real input
    (the normed embeddings of the prompt).  It fails unless the outputs
    and the final state agree within LM_TOL relative."""
    from repro_torch.device import torch_dtype
    from repro_torch.models import layers as L
    from repro_torch.models import mamba2 as SSM

    blk = params["blocks"][0]
    if cfg.family == "hybrid":
        blk = blk["sub0"]
    n = SCAN_CHECK_TOKENS
    with torch.no_grad():
        x = L.embed(params["embed"], tok[:, :n], cfg.embed_scale).to(
            torch_dtype(cfg.compute_dtype))
        h = L.rmsnorm(blk["ln1"], x, cfg.norm_eps)
        y, c = SSM.mamba_train(cfg, blk["mamba"], h, return_state=True)
        cache = SSM.mamba_init_cache(cfg, h.shape[0], torch.float32,
                                     device="cuda")
        t0 = time.perf_counter()
        steps = torch.cat([SSM.mamba_decode(cfg, blk["mamba"],
                                            h[:, t:t + 1], cache)[0]
                           for t in range(n)], dim=1)
        torch.cuda.synchronize()
        out = dict(tokens=n, chunks=n // cfg.ssm.chunk,
                   out_rel_err=_rel(steps, y),
                   state_rel_err=_rel(cache.state, c.state),
                   conv_tail_max_abs_diff=float(
                       (cache.conv - c.conv.float()).abs().max()),
                   recurrence_s=time.perf_counter() - t0,
                   tolerance=LM_TOL)
    print(f"{tag} ssd scan check (layer 0, mamba_train over "
          f"{out['chunks']} chunks vs mamba_decode token by token, fp32 "
          f"cache): {out}", flush=True)
    if not (out["out_rel_err"] <= LM_TOL and out["state_rel_err"] <= LM_TOL):
        raise AssertionError(f"{tag}: the chunked SSD disagrees with the "
                             "recurrence")
    return out


def lm_serve_phase(torch, counters, arch: str = "gemma-2b") -> tuple:
    """One model of ``LM_CELLS`` at full width (depth cut where the cell
    says, printed) through the ServeEngine, with the stub front end's
    seeded input where the model takes one (``_front_end``); returns
    (launch counts of the served run, summary).  It fails unless the
    prefill launched the flash kernel its head dim routes to once per
    attention layer (``_attention_layers``; and no other; none for the
    attention-free mamba2), the served run that many plus
    ``_cross_layers`` a decode step, the next position counts the
    patches, the logits are
    finite and the tokens in the vocabulary, the last-token prefill
    logits through the kernel are within 2^-5 relative of the same
    prefill through the plain attention (vacuous without attention, and
    printed so), and one decode step's logits are within 2^-5 relative
    of a full forward's over the same tokens (MoE: under a capacity
    factor of n_experts / top_k, so that no pair drops in either); a
    model with Mamba2 layers also runs ``ssd_scan_check``."""
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
    cfg = _cut(full, n_layers)
    tag = "lm_serve" if arch == "gemma-2b" else f"lm_serve/{arch}"
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = M.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    param_gb = sum(p.numel() * p.element_size()
                   for p in params.parameters()) / 1e9
    D = (cfg.mla.nope_dim + cfg.mla.rope_dim if cfg.mla
         else cfg.resolved_head_dim)
    n_attn = _attention_layers(cfg)
    variant = KF.kernel_variant(torch.bfloat16, D) if n_attn else None
    front = _front_end(cfg, B, torch)
    patches = cfg.vis_seq if cfg.family == "vlm" else 0
    print(f"{tag}: {cfg.name} family={cfg.family} n_layers={cfg.n_layers} "
          f"enc_layers={cfg.enc_layers} d_model={cfg.d_model} "
          f"heads={cfg.n_heads}/{cfg.n_kv_heads} "
          f"qk_head_dim={D} d_ff={cfg.d_ff} moe={cfg.moe} mla={cfg.mla} "
          f"ssm={cfg.ssm} layer_pattern={''.join(cfg.hybrid_group)} "
          f"window={cfg.window} norm={cfg.norm} "
          f"positions={cfg.pos_embedding} vocab={cfg.padded_vocab} "
          f"params={n_params} ({param_gb!r} GB {cfg.params_dtype}, compute "
          f"{cfg.compute_dtype}) attention_layers={n_attn} front_end="
          f"{ {k: tuple(v.shape) for k, v in front.items()} } "
          f"init_s={time.perf_counter() - t0!r}", flush=True)
    if n_layers is not None:
        print(f"{tag}: depth cut to {n_layers} of {full.n_layers} layers "
              f"(full width): {n_params} parameters, {param_gb!r} GB",
              flush=True)
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab, (B, S)).astype(np.int32)
    max_len = patches + S + new
    engine = ServeEngine(cfg, params, max_len=max_len)
    engine.generate(prompts, GenerationConfig(max_new_tokens=2),
                    **front)                                    # warm-up
    _reset(counters)
    t0 = time.perf_counter()
    out = engine.generate(prompts, GenerationConfig(max_new_tokens=new),
                          **front)
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
        full_n_layers=full.n_layers, params=n_params, params_gb=param_gb,
        attention_layers=n_attn, patches=patches,
        decode_flash_launches_per_step=_cross_layers(cfg))
    print(f"{tag}: {summary}", flush=True)
    print(f"{tag}: first request's tokens {out[0].tolist()}", flush=True)
    served = n_attn + _cross_layers(cfg) * t["decode_steps"]
    want = {k: served if k == f"flash_attention_{variant}" else 0
            for k in flash}
    if flash != want:
        raise AssertionError(f"{tag}: flash launches {flash}, expected "
                             f"{want}")
    if not ((out >= 0) & (out < cfg.vocab)).all():
        raise AssertionError(f"{tag}: token ids out of the vocabulary")

    def rel(a, b):
        # over the real vocabulary: the padded rows' -1e30 logits would
        # overflow the fp32 norm (inf) and read as an error of 0
        return _rel(a[..., :cfg.vocab], b[..., :cfg.vocab])

    no_drop = cfg
    if cfg.moe is not None:
        no_drop = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))
    tok = torch.as_tensor(prompts, device="cuda")
    plain = mock.patch.object(ATT, "flash_attention", KF.plain_attention)
    kc, pc, qc, cc, dc, fc, gc = ([] for _ in range(7))
    with torch.no_grad():
        before = dict(KF.LAUNCHES)
        with _routing(MOE, kc, torch):
            lk, cache, pos = M.prefill(cfg, params, tok, max_len, **front)
        prefill_flash = {k: c - before[k] for k, c in KF.LAUNCHES.items()}
        with _routing(MOE, pc, torch), plain:
            lp = lp_own = M.prefill(cfg, params, tok, max_len, **front)[0]
        if cfg.moe is not None:
            # the plain prefill again with the kernel prefill's routing
            with _routing(MOE, qc, torch, force=[c["run"] for c in kc]), \
                    plain:
                lp = M.prefill(cfg, params, tok, max_len, **front)[0]
        nxt = torch.argmax(lk[:, -1], dim=-1)[:, None].to(torch.int32)
        # decode against a full forward over the same check_S + 1 tokens
        # (and, for InternVL2, the same patches: the decode position
        # counts them)
        ctok = tok[:, :check_S]
        with _routing(MOE, cc, torch):
            lc, ccache, cpos = M.prefill(no_drop, params, ctok,
                                         patches + check_S + 1, **front)
        cnxt = torch.argmax(lc[:, -1], dim=-1)[:, None].to(torch.int32)
        with _routing(MOE, dc, torch):
            ld, _ = M.decode_step(no_drop, params, ccache, cnxt, torch.full(
                (B, 1), cpos, dtype=torch.int32, device="cuda"))
        seq = torch.cat([ctok, cnxt], dim=1)

        def forward_logits():
            x, _ = M.forward_train(no_drop, params, seq, **front)
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
        prefill_flash_launches=prefill_flash,
        decode_position=cpos,
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
    if not n_attn:
        checks["prefill_kernel_vs_plain"] = (
            "vacuous: no attention layer, the two prefills compute the same")
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
    if prefill_flash != {k: n_attn if k == f"flash_attention_{variant}"
                         else 0 for k in prefill_flash}:
        raise AssertionError(f"{tag}: prefill flash launches "
                             f"{prefill_flash}, expected {n_attn} of "
                             f"flash_attention_{variant}")
    if cpos != patches + check_S:
        raise AssertionError(f"{tag}: prefill's next position {cpos}, "
                             f"expected {patches} + {check_S}")
    if not (checks["logits_finite"]
            and checks["prefill_rel_err_kernel_vs_plain"] <= LM_TOL
            and checks["decode_rel_err_vs_full_forward"] <= LM_TOL
            and not any(checks["decode_check_dropped"])):
        raise AssertionError(f"{tag}: logits off their plain versions")
    if cfg.ssm is not None:
        summary["ssd_scan_check"] = ssd_scan_check(tag, cfg, params, tok,
                                                   torch)
    if arch == "gemma-2b":
        summary["dryrun"] = dryrun_serve_check(tag, torch, cfg, params, tok,
                                               max_len)
    positions = torch.full((B, 1), pos, dtype=torch.int32, device="cuda")
    _profile(f"{tag} decode step", lambda: M.decode_step(
        cfg, params, cache, nxt, positions), torch, reps=3)
    _profile(f"{tag} prefill", lambda: M.prefill(
        cfg, params, tok, max_len, **front), torch, reps=1)
    del params, engine, cache
    torch.cuda.empty_cache()
    return launches, summary


# ------------------------------------------------------ the dry run

def _exact(tag, what, dry, card) -> None:
    print(f"{tag} dry run vs card: {what} dry={dry!r} card={card!r} "
          f"equal={dry == card}", flush=True)
    if dry != card:
        raise AssertionError(f"{tag}: the dry run's {what} {dry!r} differ "
                             f"from the card's {card!r}")


def _peak_ratio(tag, predicted: int, measured: int, held: bool) -> float:
    ratio = predicted / measured
    lo, hi = PEAK_BAND
    print(f"{tag} dry run vs card: predicted peak {predicted} B over the "
          f"card's {measured} B = {ratio!r} (band {lo}-{hi}, "
          f"{'held' if held else 'printed'})", flush=True)
    if held and not lo <= ratio <= hi:
        raise AssertionError(f"{tag}: the dry run's peak is {ratio!r} of "
                             f"the card's, outside {PEAK_BAND}")
    return ratio


def dryrun_grid(out: Path) -> int:
    """(a) the dry run's whole grid on the meta device, in a child process
    of its own (``--dryrun-grid OUT``: it uses no card): every (arch,
    shape, mesh) run of ``launch.dryrun.grid()``, one line each
    (``run_cell``: status, bytes a device, bottleneck), the counts and
    each run's figures written to OUT as JSON."""
    import torch

    torch.set_num_threads(2)      # beside the card's phases on the host
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.launch import dryrun as D

    t0 = time.perf_counter()
    counts, cells = {}, {}
    for arch, shape, multi in D.grid():
        r = D.run_cell(arch, shape, multi)
        head = str(r["status"]).split(":")[0]
        counts[head] = counts.get(head, 0) + 1
        cells[f"{arch}__{shape}__{'multi' if multi else 'single'}"] = dict(
            status=r["status"], bytes_per_device=r.get("bytes_per_device"),
            argument_bytes=r.get("memory", {}).get("argument_size_in_bytes"),
            bottleneck=r.get("roofline", {}).get("bottleneck"),
            trace_s=r.get("trace_s"))
    out.write_text(json.dumps(dict(counts=counts, cells=cells,
                                   grid_s=time.perf_counter() - t0),
                              default=str))
    return 0


def dryrun_grid_start(tmp: Path):
    """Start ``dryrun_grid`` in a child process (the grid takes minutes
    of host time and no card), its lines to ``tmp/dryrun.log``."""
    log = open(tmp / "dryrun.log", "w")
    proc = subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"),
                             "--dryrun-grid", str(tmp / "dryrun.json")],
                            stdout=log, stderr=subprocess.STDOUT)
    return proc, log


def dryrun_grid_phase(proc, log, tmp: Path) -> dict:
    """Collect ``dryrun_grid``'s child: its lines printed here, and it
    fails on a FAIL or on counts of ok / skip other than
    ``DRYRUN_GRID``."""
    t0 = time.perf_counter()
    rc = proc.wait()
    log.close()
    print((tmp / "dryrun.log").read_text(), end="", flush=True)
    if rc != 0:
        raise AssertionError(f"dryrun grid: the child exited {rc}")
    res = json.loads((tmp / "dryrun.json").read_text())
    counts, grid_s = res["counts"], res["grid_s"]
    print(f"dryrun grid: {counts} in {grid_s!r} s (a child process beside "
          f"the phases before; waited {time.perf_counter() - t0!r} s)",
          flush=True)
    if counts != DRYRUN_GRID:
        raise AssertionError(f"dryrun grid: {counts}, expected "
                             f"{DRYRUN_GRID}")
    return dict(counts=counts, grid_s=grid_s, cells=res["cells"])


def dryrun_serve_check(tag, torch, cfg, params, tok, max_len) -> dict:
    """(b) the dry account of the served prefill (one device) against the
    card: the parameter bytes and the decode cache's bytes exactly, the
    dot and flash counts of one prefill counted on the card
    (``dryrun.count_step``) exactly, and the predicted peak (arguments
    plus temporaries) over the card's (the parameters and tokens plus
    the prefill's rise of ``max_memory_allocated``) within PEAK_BAND."""
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.shapes import ShapeSpec
    from repro_torch.models import model as M

    B, S = tok.shape
    t0 = time.perf_counter()
    dry = D.trace_cell(cfg, ShapeSpec(tag, S, B, "prefill"), None,
                       max_len=max_len)
    cache_dry = D.argument_bytes(cfg, ShapeSpec(tag, max_len, B, "decode"),
                                 None)["cache_bytes"]
    trace_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    with torch.no_grad():
        (_, cache, _), card = D.count_step(
            lambda: M.prefill(cfg, params, tok, max_len), "cuda")
    torch.cuda.synchronize()
    rise = torch.cuda.max_memory_allocated() - before
    mem = dry["memory"]
    _exact(tag, "parameter bytes", mem["params_bytes"],
           D.tree_bytes(params))
    _exact(tag, "cache bytes", cache_dry, D.tree_bytes(
        (cache.layers, cache.dense_layers, cache.enc_out)))
    for k in ("dot_flops", "dot_bytes", "flash_flops", "flash_bytes",
              "flash_calls", "dots"):
        _exact(tag, k, dry["op_counts"][k], card[k])
    measured = D.tree_bytes(params) + D.tree_bytes(tok) + rise
    out = dict(trace_s=trace_s, predicted_peak=dry["bytes_per_device"],
               measured_peak=measured, rise=rise,
               temp_dry=mem["temp_size_in_bytes"],
               temp_card_counted=card["peak_bytes"],
               op_counts=dry["op_counts"], roofline=dry["roofline"],
               peak_ratio=_peak_ratio(tag, dry["bytes_per_device"],
                                      measured, True))
    print(f"{tag} dry run: {out}", flush=True)
    del cache
    return out


def dryrun_train_check(tag, cfg, measured_args: int, rise: int) -> dict:
    """(d) the dry account of one train step (one device, the config's
    remat, the reference's optimizer pick) against the card's step:
    parameter plus optimizer-state bytes exactly, and the predicted peak
    over the card's (its arguments plus the step's rise) within
    PEAK_BAND."""
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.shapes import ShapeSpec

    t0 = time.perf_counter()
    dry = D.trace_cell(cfg, ShapeSpec(tag, TRAIN_S, TRAIN_B, "train"), None)
    mem = dry["memory"]
    out = dict(trace_s=time.perf_counter() - t0, optimizer=dry["optimizer"],
               memory=mem, predicted_peak=dry["bytes_per_device"],
               op_counts=dry["op_counts"], roofline=dry["roofline"])
    _exact(tag, "parameter + optimizer-state bytes",
           mem["params_bytes"] + mem["opt_state_bytes"],
           measured_args["params"] + measured_args["opt_state"])
    measured = sum(measured_args.values()) + rise
    out.update(measured_peak=measured, rise=rise,
               peak_ratio=_peak_ratio(tag, dry["bytes_per_device"],
                                      measured, True))
    print(f"{tag} dry run: {out}", flush=True)
    return out


def dryrun_mesh_check(tag, cfg, ranks) -> dict:
    """(c) the dry rank of each real rank of the mesh phase (a dry (data
    1, model MESH_RANKS) mesh, DEFAULT_RULES as the ranks run): its shard
    bytes and one prefill's collective calls and payload bytes by kind
    exactly; its predicted peak over the rank's served peak printed."""
    from repro_torch.dist.sharding import DEFAULT_RULES
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import make_dry_mesh
    from repro_torch.launch.shapes import ShapeSpec

    out = {}
    for res in ranks:
        r = res["rank"]
        t0 = time.perf_counter()
        dry = D.trace_cell(cfg, ShapeSpec(tag, MESH_S, MESH_B, "prefill"),
                           make_dry_mesh(("data", "model"), (1, MESH_RANKS),
                                         r),
                           rules=DEFAULT_RULES, max_len=MESH_S + MESH_NEW)
        rt = f"{tag} rank {r}"
        _exact(rt, "shard bytes", dry["memory"]["params_bytes"],
               res["shard_bytes"])
        coll = res["collectives_prefill"]
        _exact(rt, "collective calls", dry["collectives"]["calls"],
               coll["calls"])
        _exact(rt, "collective payload bytes",
               dry["collectives"]["payload_bytes"], coll["bytes"])
        served = int(res["peak_memory_gb_served"] * 1e9)
        out[f"rank {r}"] = dict(
            trace_s=time.perf_counter() - t0,
            predicted_peak=dry["bytes_per_device"], served_peak=served,
            peak_ratio=_peak_ratio(rt, dry["bytes_per_device"], served,
                                   False),
            wire_bytes=dry["collectives"]["by_kind"],
            roofline=dry["roofline"])
    print(f"{tag} dry run: {out}", flush=True)
    return out


TRAIN_ARCH = "gemma-2b"         # trained whole: 18 layers at full width
TRAIN_B, TRAIN_S = 4, 2048     # the serve cell's 4 x 2048 tokens a step
TRAIN_STEPS = 12
TRAIN_BATCHES = 4              # cycled, as test_train_substrate.py does
TRAIN_LR, TRAIN_WARMUP = 1e-3, 2   # lr 0 at step 0, 5e-4 at 1, then a
                                   # cosine from 1e-3 to 1e-4 at step 12
TRAIN_FALL = 0.3               # the reference's criterion (its line 38)
GRAD_TOL = 2.0 ** -4           # relative (Frobenius) grad error, kernel
                               # vs plain


def _frob_rel(a, b) -> float:
    return float((a.float() - b.float()).norm() / b.float().norm())


def _train_launcher_check(tag, torch) -> dict:
    """``launch/train.py`` main at ``--reduced`` on the card, in a
    temporary working directory: 6 steps saving at 3 and 6, then
    ``--resume`` to 9 from step 6; and a bf16 parameter tree through
    ``CheckpointManager``, restored bit for bit on the card."""
    import os
    import tempfile

    from repro_torch.configs import get_reduced_config
    from repro_torch.launch import train as launch_train
    from repro_torch.models import model as M
    from repro_torch.train import CheckpointManager

    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            args = ["--arch", TRAIN_ARCH, "--reduced", "--batch", "4",
                    "--seq", "64", "--save-every", "3", "--log-every", "1",
                    "--ckpt-dir", "ck"]
            first = launch_train.main(args + ["--steps", "6"])
            again = launch_train.main(args + ["--steps", "9", "--resume"])
            saved = sorted(p.name for p in (Path(tmp) / "ck" / TRAIN_ARCH)
                           .iterdir())
            logged = (Path(tmp) / "experiments"
                      / f"train_{TRAIN_ARCH}.json").is_file()
        finally:
            os.chdir(cwd)
        cfg = get_reduced_config(TRAIN_ARCH)
        mgr = CheckpointManager(Path(tmp) / "bf16")
        P = M.init_params(cfg, seed=0, device="cuda", dtype="bfloat16")
        mgr.save(1, P)
        Q = M.init_params(cfg, seed=1, device="cuda", dtype="bfloat16")
        mgr.restore(1, Q)
        bit_equal = all(torch.equal(a.view(torch.int16), b.view(torch.int16))
                        for a, b in zip(P.state_dict().values(),
                                        Q.state_dict().values()))
    losses = [e["loss"] for e in first["log"] + again["log"]]
    out = dict(resumed_from=again["start_step"],
               steps_after_resume=[e["step"] for e in again["log"]],
               checkpoints=saved, log_written=logged,
               losses=losses, bf16_leaves_bit_equal=bit_equal)
    print(f"{tag} launcher (reduced, on the card): {out}", flush=True)
    if not (out["resumed_from"] == 6 and out["steps_after_resume"] == [6, 7, 8]
            and saved == ["step_3", "step_6", "step_9"] and logged
            and bit_equal and np.isfinite(losses).all()):
        raise AssertionError(f"{tag}: the launcher did not save, resume "
                             "and restore as it should")
    return out


def lm_train_phase(torch, counters) -> tuple:
    """Gemma-2B trained whole at full width on the card: seeded fp32
    parameters, bf16 compute, ``remat="full"``, AdamW, ``SyntheticTokens``
    of TRAIN_B x TRAIN_S cycling over TRAIN_BATCHES batches.  At step 0
    the loss and grads through the kernel against the same through the
    plain attention (loss and global grad norm within LM_TOL relative,
    the grads of ``blocks.0.attn.wq`` and ``embed.table`` within
    GRAD_TOL); then TRAIN_STEPS steps of ``make_train_step`` from zeroed
    counts: every loss finite, the last TRAIN_FALL or more below step
    0's, the wgmma flash kernel launched twice an attention layer a step
    (the forward and the remat recompute) and no other flash kernel;
    then one profiled step and the attention backward and the AdamW
    update alone under the profiler; then the launcher at ``--reduced``
    (``_train_launcher_check``).  Returns (launch counts of the steps,
    summary)."""
    import statistics
    from unittest import mock

    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticTokens
    from repro_torch.kernels import flash_attention as KF
    from repro_torch.kernels.flash_attention import ops as KFO
    from repro_torch.launch import dryrun as D
    from repro_torch.models import attention as ATT
    from repro_torch.models import model as M
    from repro_torch.train import (TrainConfig, make_optimizer,
                                   make_train_step)
    from repro_torch.train import optimizer as OPT

    tag = f"lm_train/{TRAIN_ARCH}"
    cfg = get_config(TRAIN_ARCH)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = M.init_params(cfg, seed=0, device="cuda").requires_grad_(True)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    data = SyntheticTokens(cfg, TRAIN_B, TRAIN_S, seed=0, device="cuda")
    batches = [data.batch_at(i) for i in range(TRAIN_BATCHES)]
    n_attn = _attention_layers(cfg)
    print(f"{tag}: {cfg.name} n_layers={cfg.n_layers} d_model={cfg.d_model}"
          f" heads={cfg.n_heads}/{cfg.n_kv_heads} head_dim="
          f"{cfg.resolved_head_dim} d_ff={cfg.d_ff} vocab={cfg.padded_vocab}"
          f" params={n_params} ({cfg.params_dtype}, compute "
          f"{cfg.compute_dtype}, remat {cfg.remat}) batch={TRAIN_B}x"
          f"{TRAIN_S} init_s={time.perf_counter() - t0!r}", flush=True)

    # ---- kernel against plain at step 0, before any update
    names, leaves = zip(*params.named_parameters())
    b0 = batches[0]

    def loss_and_grads():
        loss, _ = M.loss_fn(cfg, params, b0["tokens"], b0["labels"])
        grads = dict(zip(names, torch.autograd.grad(loss, leaves)))
        kept = {k: grads[k] for k in ("blocks.0.attn.wq", "embed.table")}
        return float(loss.detach()), float(OPT.global_norm(grads)), kept

    before = KF.LAUNCHES["flash_attention_wgmma"]
    lk, nk, gk = loss_and_grads()
    step0_launches = KF.LAUNCHES["flash_attention_wgmma"] - before
    with mock.patch.object(ATT, "flash_attention", KF.plain_attention):
        lp, np_, gp = loss_and_grads()
    checks = dict(loss_kernel=lk, loss_plain=lp, loss_rel_err=abs(lk - lp)
                  / abs(lp), grad_norm_kernel=nk, grad_norm_plain=np_,
                  grad_norm_rel_err=abs(nk - np_) / abs(np_),
                  grad_rel_err={k: _frob_rel(gk[k], gp[k]) for k in gk},
                  step0_flash_launches=step0_launches, tolerance=LM_TOL,
                  grad_tolerance=GRAD_TOL)
    del gk, gp
    print(f"{tag} kernel vs plain at step 0: {checks}", flush=True)
    if not (checks["loss_rel_err"] <= LM_TOL
            and checks["grad_norm_rel_err"] <= LM_TOL
            and all(e <= GRAD_TOL for e in checks["grad_rel_err"].values())
            and step0_launches == 2 * n_attn):
        raise AssertionError(f"{tag}: the kernel's loss or grads are off "
                             "the plain attention's")

    # ---- TRAIN_STEPS AdamW steps, the attention backward (the recompute
    # through attention_ref) and the optimizer update timed by CUDA events
    tc = TrainConfig(optimizer="adamw", learning_rate=TRAIN_LR,
                     warmup_steps=TRAIN_WARMUP, total_steps=TRAIN_STEPS)
    adamw = opt = make_optimizer(tc)
    state = opt.init(params)
    spans = {"attention_backward": [], "optimizer_update": []}

    def timed(key, fn):
        def run(*args, **kw):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            out = fn(*args, **kw)
            b.record()
            spans[key].append((a, b))
            return out
        return run

    opt = dataclasses.replace(opt, update=timed("optimizer_update",
                                                opt.update))
    step = make_train_step(cfg, tc, opt=opt)
    backward = mock.patch.object(
        KFO._FlashAttention, "backward", staticmethod(timed(
            "attention_backward", KFO._FlashAttention.backward)))
    losses, step_s, span_ms = [], [], []
    torch.cuda.synchronize()
    _reset(counters)
    with backward:
        for i in range(TRAIN_STEPS):
            for v in spans.values():
                v.clear()
            if i == TRAIN_STEPS - 1:    # the dry run's check: one step's
                phase_peak = torch.cuda.max_memory_allocated()   # rise
                torch.cuda.reset_peak_memory_stats()
                before = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            params, state, m = step(params, state,
                                    batches[i % TRAIN_BATCHES])
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            losses.append(float(m["loss"]))
            span_ms.append({k: sum(a.elapsed_time(b) for a, b in v)
                            for k, v in spans.items()})
    launches = _counts(counters)
    step_rise = torch.cuda.max_memory_allocated() - before
    step_args = dict(params=D.tree_bytes(params),
                     opt_state=D.tree_bytes(tuple(state)),
                     batch=D.tree_bytes(batches[(TRAIN_STEPS - 1)
                                                % TRAIN_BATCHES]))
    median_s = statistics.median(step_s[2:])
    tokens = TRAIN_B * TRAIN_S
    summary = dict(
        arch=TRAIN_ARCH, params=n_params, batch=TRAIN_B, seq=TRAIN_S,
        steps=TRAIN_STEPS, lr=TRAIN_LR, warmup_steps=TRAIN_WARMUP,
        losses=losses, step_s=step_s, median_step_s=median_s,
        tokens_per_s=tokens / median_s,
        model_tflops_per_s=6 * n_params * tokens / median_s / 1e12,
        mfu_6N_vs_989=6 * n_params * tokens / median_s / BF16_OPS_PER_S,
        peak_memory_gb=max(phase_peak, torch.cuda.max_memory_allocated())
        / 1e9,
        attention_backward_ms=statistics.median(
            s["attention_backward"] for s in span_ms[2:]),
        attention_backward_launches_per_step=n_attn,
        optimizer_update_ms=statistics.median(
            s["optimizer_update"] for s in span_ms[2:]),
        flash_launches={k: v for k, v in launches.items()
                        if k.startswith("flash_attention_")},
        **checks)
    print(f"{tag}: {summary}", flush=True)
    _require(tag, launches, ["flash_attention_wgmma"])
    want = {k: 2 * n_attn * TRAIN_STEPS if k == "flash_attention_wgmma"
            else 0 for k in summary["flash_launches"]}
    if summary["flash_launches"] != want:
        raise AssertionError(f"{tag}: flash launches "
                             f"{summary['flash_launches']}, expected {want}"
                             f" ({2 * n_attn} a step)")
    if not (np.isfinite(losses).all()
            and losses[-1] < losses[0] - TRAIN_FALL):
        raise AssertionError(f"{tag}: losses {losses} not finite or not "
                             f"{TRAIN_FALL} below step 0's")
    summary["dryrun"] = dryrun_train_check(tag, cfg, step_args, step_rise)

    # ---- one more step under the profiler: busy share, top kernels
    _, wall_ms, device_ms, busy, top = _busy(lambda: step(
        params, state, batches[TRAIN_STEPS % TRAIN_BATCHES]), torch)
    summary.update(profiled_step_wall_ms=wall_ms,
                   profiled_step_device_ms=device_ms, busy_share=busy,
                   top_kernels=top)
    print(f"{tag} profiled step: wall_ms={wall_ms!r} device_ms="
          f"{device_ms!r} busy_share={busy!r}", flush=True)
    for name, ms, count in top:
        print(f"{tag}:   {ms!r} ms x{count} {name}", flush=True)

    # ---- the two spans alone, by the profiler's device time: one
    # layer's attention backward (the recompute through attention_ref
    # and its grads, at the layer's shape) and one AdamW update (zero
    # grads: the same passes over the same bytes)
    gen = torch.Generator(device="cuda").manual_seed(3)

    def randn(heads):
        return torch.randn((TRAIN_B, heads, TRAIN_S, cfg.resolved_head_dim),
                           generator=gen, device="cuda",
                           dtype=torch.bfloat16).requires_grad_()

    q, k, v = randn(cfg.n_heads), randn(cfg.n_kv_heads), randn(
        cfg.n_kv_heads)
    g = torch.randn_like(q)
    att = _device_ms(lambda: torch.autograd.grad(
        KF.attention_ref(q, k, v, causal=True), (q, k, v), g), calls=5)
    del q, k, v, g
    zeros = {n: torch.zeros_like(p) for n, p in params.named_parameters()}
    upd = _device_ms(lambda: adamw.update(zeros, state, params, TRAIN_LR),
                     calls=3)
    del zeros
    summary.update(
        attention_backward_device_ms_per_layer=att["per_call_ms"],
        attention_backward_device_ms_per_step=att["per_call_ms"] * n_attn,
        optimizer_update_device_ms=upd["per_call_ms"])
    print(f"{tag} alone, device time (profiler): attention backward "
          f"{att['per_call_ms']!r} ms a layer, x{n_attn} = "
          f"{att['per_call_ms'] * n_attn!r} ms a step; AdamW update "
          f"{upd['per_call_ms']!r} ms", flush=True)
    del params, state, batches, data, leaves, b0, m
    torch.cuda.empty_cache()
    summary["launcher"] = _train_launcher_check(tag, torch)
    return launches, summary


# ---------------------------------------------------------- the mesh phase

MESH_ARCH = "mixtral-8x22b"
MESH_RANKS = 4                 # ranks on the one card: a (data 1, model 4)
                               # mesh, gloo staged through pinned memory
MESH_LAYERS = 2                # a depth cut (56 layers): the fewest that run
                               # the seq_sp hand-off between two blocks
MESH_B, MESH_S, MESH_NEW = 2, 6144, 32
MESH_SEED = 0
MESH_TIMED_RANKS = 1           # row 8i timed on rank 0 alone (a cut of 4,
                               # every rank in turn: the row is recorded);
                               # every rank's error is held
MESH_NO_DROP_CF = 2.0          # the no-drop check's capacity factor (the
                               # phase fails if a pair drops): at n_experts /
                               # top_k = 4 the all-to-all's C2 buffers take
                               # ~20 GB a rank, more than four fit on the card
MESH_TRAIN_ARCH = "gemma-2b"
MESH_TRAIN_LAYERS = 1          # a depth cut (18 layers) of the DP train step
MESH_TRAIN_DATA = 2            # replicas, on ranks 0 and 1: four of some 18
                               # GB each (0.63 B fp32 parameters, grads, two
                               # moments, the residual, the loss's chunks)
                               # did not fit the card beside one another
MESH_TRAIN_SEQ = 2048          # one sequence a replica
MESH_TRAIN_STEPS = 3


def _mesh_cfgs():
    """(the served config cut to MESH_LAYERS, the same at the no-drop
    check's capacity factor MESH_NO_DROP_CF)."""
    from repro_torch.configs import get_config

    cfg = _cut(get_config(MESH_ARCH), MESH_LAYERS)
    no_drop = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=MESH_NO_DROP_CF))
    return cfg, no_drop


def _mesh_prompts(cfg):
    return np.random.default_rng(MESH_SEED).integers(
        0, cfg.vocab, (MESH_B, MESH_S)).astype(np.int32)


def _mesh_reference(torch, tmp: Path) -> dict:
    """The one-process meshless run on the same seeded weights (the
    global tree the ranks take their blocks of): the last-token prefill
    logits and one decode step's, at the config's capacity factor and at
    the no-drop one, saved for the ranks."""
    from repro_torch.models import model as M
    from repro_torch.models import moe as MOE

    cfg, no_drop = _mesh_cfgs()
    t0 = time.perf_counter()
    params = M.init_params(cfg, seed=MESH_SEED, device="cuda")
    tok = torch.as_tensor(_mesh_prompts(cfg), device="cuda")
    max_len = MESH_S + MESH_NEW
    ref = {}
    # the no-drop run first: its greedy pick is the token both runs decode
    with torch.no_grad():
        for tag, c in (("no_drop", no_drop), ("cf", cfg)):
            with MOE.record_drops() as drops:
                lk, cache, pos = M.prefill(c, params, tok, max_len)
                if "next" not in ref:
                    ref["next"] = torch.argmax(lk[:, -1], -1)[:, None].to(
                        torch.int32)
                ld, _ = M.decode_step(c, params, cache, ref["next"],
                                      torch.full((MESH_B, 1), pos,
                                                 dtype=torch.int32,
                                                 device="cuda"))
            ref[f"prefill_{tag}"] = lk.float().cpu()
            ref[f"decode_{tag}"] = ld.float().cpu()
            ref[f"drops_{tag}"] = [int(d) for d in drops]
            del cache, lk, ld
    ref["next"] = ref["next"].cpu()
    ref["seconds"] = time.perf_counter() - t0
    torch.save(ref, tmp / "ref.pt")
    del params, tok
    torch.cuda.empty_cache()
    return ref


def _mesh_rank(rank: int, tmp: str, port: int) -> None:
    """One rank of the mesh phase (a spawned process): joins the gloo
    group, runs ``_mesh_rank_body`` and writes ``tmp/rank<r>.json``."""
    import os

    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port),
                      WORLD_SIZE=str(MESH_RANKS), RANK=str(rank),
                      LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE=str(MESH_RANKS))
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    import torch.distributed as tdist

    from repro_torch.launch.mesh import make_host_mesh

    mesh = make_host_mesh(MESH_RANKS, device="cuda")
    try:
        out = _mesh_rank_body(rank, Path(tmp), mesh, torch, tdist)
        with open(Path(tmp) / f"rank{rank}.json", "w") as f:
            json.dump(out, f, default=str)
    finally:
        tdist.destroy_process_group()


def _mesh_rank_body(rank, tmp, mesh, torch, tdist) -> dict:
    from unittest import mock

    import torch.nn.functional as F

    from repro_torch.dist.sharding import NamedSharding
    from repro_torch.kernels import bsr_spmm as KB
    from repro_torch.kernels import flash_attention as KF
    from repro_torch.kernels import kmeans_assign as KK
    from repro_torch.kernels import plap_edge as KP
    from repro_torch.kernels import segment_sum as KS
    from repro_torch.kernels import sellcs_spmm as K
    from repro_torch.launch.mesh import record_collectives
    from repro_torch.launch.op_count import flash_counts
    from repro_torch.models import attention as ATT
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    from repro_torch.models import moe as MOE
    from repro_torch.serve import GenerationConfig, ServeEngine

    counters = (K, KB, KP, KK, KF, KS)
    dev = mesh.device
    cfg, no_drop = _mesh_cfgs()
    ref = torch.load(tmp / "ref.pt")
    out = {"rank": rank, "coords": mesh.coords, "device": str(dev),
           "backend": mesh.backend, "staged": mesh.staged}
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = M.init_params(cfg, seed=MESH_SEED, device=dev, mesh=mesh)
    torch.cuda.synchronize(dev)
    out["init_s"] = time.perf_counter() - t0
    out["shard_bytes"] = sum(p.numel() * p.element_size()
                             for p in params.parameters())
    out["full_bytes"] = sum(int(np.prod(ab.shape)) * 2 for _, ab in
                            L.named_leaves(M.abstract_params(cfg)))
    prompts = _mesh_prompts(cfg)
    tok = torch.as_tensor(prompts, device=dev)
    max_len = MESH_S + MESH_NEW
    engine = ServeEngine(cfg, params, max_len=max_len, mesh=mesh)
    engine.generate(prompts[:, :256], GenerationConfig(max_new_tokens=2))
    tdist.barrier()

    # ---- the main path: 2 x 6144 prompts, 32 greedy tokens, from zeroed
    # counts
    _reset(counters)
    with MOE.record_drops() as drops:
        served = engine.generate(prompts, GenerationConfig(
            max_new_tokens=MESH_NEW))
    torch.cuda.synchronize(dev)
    out["launches"] = _counts(counters)
    out["timing"] = dict(engine.timing)
    out["decode_ms_per_token"] = (engine.timing["decode_s"]
                                  / engine.timing["decode_steps"] * 1e3)
    out["prefill_drops_by_layer"] = [int(d) for d in drops[:cfg.n_layers]]
    out["tokens"] = served.tolist()
    out["peak_memory_gb_served"] = torch.cuda.max_memory_allocated(dev) / 1e9

    # ---- one prefill with its collectives counted (each synced), and
    # layer 0's attention inputs kept for the kernel check
    kept = {}
    flash = ATT.flash_attention

    def keep(q, k, v, **kw):
        kept.setdefault("qkv", (q, k, v, kw))
        return flash(q, k, v, **kw)

    tdist.barrier()
    with torch.no_grad(), record_collectives() as stats, \
            mock.patch.object(ATT, "flash_attention", keep):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        lk, cache, pos = M.prefill(cfg, params, tok, max_len, mesh)
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
    out["collectives_prefill"] = dict(
        wall_s=wall, calls=stats.calls, bytes=stats.bytes,
        seconds=stats.seconds, share=sum(stats.seconds.values()) / wall)
    table = M._table_sharding(cfg, mesh)
    whole = NamedSharding(mesh, (None, None, table.spec[0]))

    def rel(a, b):
        a, b = a[..., :cfg.vocab].float().cpu(), b[..., :cfg.vocab]
        return float((a - b).norm() / b.norm())

    with torch.no_grad():
        nxt = ref["next"].to(dev)
        positions = torch.full((MESH_B, 1), pos, dtype=torch.int32,
                               device=dev)
        ld, _ = M.decode_step(cfg, params, cache, nxt, positions, mesh)
        out["rel_err_vs_meshless_cf"] = dict(
            prefill=rel(whole.gather(lk), ref["prefill_cf"]),
            decode=rel(whole.gather(ld), ref["decode_cf"]),
            capacity_factor=cfg.moe.capacity_factor)
        del cache
        with MOE.record_drops() as nd:
            lk, cache, _ = M.prefill(no_drop, params, tok, max_len, mesh)
            ld, _ = M.decode_step(no_drop, params, cache, nxt, positions,
                                  mesh)
        del cache
        out["no_drop"] = dict(
            capacity_factor=no_drop.moe.capacity_factor,
            prefill_rel_err=rel(whole.gather(lk), ref["prefill_no_drop"]),
            decode_rel_err=rel(whole.gather(ld), ref["decode_no_drop"]),
            dropped=int(sum(int(d) for d in nd)), tolerance=LM_TOL)
    if not (out["no_drop"]["prefill_rel_err"] <= LM_TOL
            and out["no_drop"]["decode_rel_err"] <= LM_TOL
            and out["no_drop"]["dropped"] == 0):
        raise AssertionError(f"mesh rank {rank}: logits off the meshless "
                             f"run at no-drop capacity: {out['no_drop']}")

    # ---- row 8i: the kernel on this rank's heads of layer 0, against the
    # plain attention on every rank, timed on the first MESH_TIMED_RANKS
    # (in turn)
    q, k, v, kw = kept["qkv"]
    B, Hq, Sq, D = q.shape
    Sk, Dv = k.shape[2], v.shape[3]
    i = torch.arange(Sq, device=dev)
    j = torch.arange(Sk, device=dev)
    mask = (j[None, :] <= i[:, None]) & (j[None, :] > i[:, None]
                                         - cfg.window)
    with torch.no_grad():
        got = KF.flash_attention(q, k, v, **kw)
        plain = KF.plain_attention(q, k, v, **kw)
    err = (got.float() - plain.float())
    flops, nbytes = flash_counts(q, k, v, kw.get("causal", True),
                                 kw.get("window"))
    bound = _bound(nbytes, flops, BF16_OPS_PER_S)
    out["kernel"] = dict(
        shape=dict(B=B, Hq=Hq, Hkv=k.shape[1], Sq=Sq, Sk=Sk, D=D, Dv=Dv,
                   window=kw.get("window"), causal=kw.get("causal", True),
                   dtype=str(q.dtype).split(".")[-1]),
        variant=KF.kernel_variant(q.dtype, D, Sk),
        rel_err=float(err.norm() / plain.float().norm()),
        max_abs_err=float(err.abs().max()),
        max_rel_err=float((err.abs() / plain.float().abs()
                           .clamp(min=1e-30)).max()),
        ms=None, plain_ms=None, library_ms=None, bound_ms=bound[0],
        bound_by=bound[1], gflop=flops / 1e9)
    del got, plain, err
    for turn in range(MESH_TIMED_RANKS):
        if turn == rank:
            with torch.no_grad():
                out["kernel"].update(
                    ms=_time_ms(lambda: KF.flash_attention(q, k, v, **kw)),
                    plain_ms=_time_ms(lambda: KF.plain_attention(
                        q, k, v, **kw), 3, 3),
                    library_ms=_time_ms(lambda: F.scaled_dot_product_attention(
                        q, k, v, attn_mask=mask, enable_gqa=True)))
        tdist.barrier()
    if not out["kernel"]["rel_err"] <= LM_TOL:
        raise AssertionError(f"mesh rank {rank}: the flash kernel on its "
                             f"heads is off the plain attention: "
                             f"{out['kernel']}")
    out["peak_memory_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    del params, engine, kept, q, k, v, lk, ld
    torch.cuda.empty_cache()
    tdist.barrier()
    free, total = torch.cuda.mem_get_info(dev)
    out["before_train"] = dict(card_free_gb=free / 1e9,
                               reserved_gb=torch.cuda.memory_reserved(dev)
                               / 1e9)
    out["train"] = _mesh_train(rank, torch, tdist)
    torch.cuda.empty_cache()
    tdist.barrier()
    t0 = time.perf_counter()
    out["families"] = {arch: _mesh_family(rank, tmp, mesh, torch, tdist,
                                          counters, arch)
                       for arch in MESH_FAMILIES}
    out["tp_train"] = _tp_train(rank, tmp, torch, tdist)
    out["families_s"] = time.perf_counter() - t0
    tdist.barrier()
    return out


def _fingerprint(tree, torch):
    """Two int64 sums a leaf of its bit patterns (equal trees give equal
    fingerprints; a change of one bit changes one)."""
    out = []
    for t in tree.values():
        w = t.detach().contiguous().view(torch.int32).to(torch.int64)
        out.append(torch.stack([w.sum(), (w * (w >> 11)).sum()]))
    return torch.stack(out)


def _mesh_train(rank, torch, tdist) -> dict:
    """The int8 compressed DP step: Gemma-2B at full width cut to
    MESH_TRAIN_LAYERS, a (data MESH_TRAIN_DATA, model 1) mesh over the
    first ranks under DP_RULES, one sequence of MESH_TRAIN_SEQ a
    replica, MESH_TRAIN_STEPS steps; every loss finite and the replicas'
    parameters and residuals equal bit for bit after each step."""
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticTokens
    from repro_torch.dist.sharding import DP_RULES, use_rules
    from repro_torch.launch.mesh import all_gather, make_host_mesh
    from repro_torch.models import model as M
    from repro_torch.train import (TrainConfig, init_compression_state,
                                   make_optimizer, make_train_step)
    from repro_torch.train import optimizer as OPT

    dp = make_host_mesh(1, device="cuda", ranks=range(MESH_TRAIN_DATA))
    if dp is None:                      # a rank outside the replicas
        return dict(mesh=None, replica=False)
    dev = dp.device
    cfg = _cut(get_config(MESH_TRAIN_ARCH), MESH_TRAIN_LAYERS)
    torch.cuda.reset_peak_memory_stats(dev)
    out = dict(mesh=dp.shape, steps=[], identical=[])
    with use_rules(DP_RULES):
        params = M.init_params(cfg, seed=0, device=dev, mesh=dp)
        out["params"] = sum(p.numel() for p in params.parameters())
        tc = TrainConfig(optimizer="adamw", learning_rate=TRAIN_LR,
                         warmup_steps=1, total_steps=MESH_TRAIN_STEPS,
                         grad_compression="int8", compression_axis="data")
        opt = make_optimizer(tc)
        state = opt.init(params)
        err = init_compression_state(params)
        step = make_train_step(cfg, tc, opt=opt, mesh=dp)
        data = SyntheticTokens(cfg, dp.shape["data"], MESH_TRAIN_SEQ,
                               seed=0, device=dev)
        for i in range(MESH_TRAIN_STEPS):
            batch = data.batch_at(i)
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            params, state, err, m = step(params, state, err, batch)
            torch.cuda.synchronize(dev)
            out["steps"].append(dict(
                s=time.perf_counter() - t0, loss=float(m["loss"]),
                grad_norm=float(m["grad_norm"])))
            fp = torch.cat([_fingerprint(OPT.named_leaves(params), torch),
                            _fingerprint(err, torch)])
            every = all_gather(dp, fp[None], "data", 0)
            out["identical"].append(bool((every == every[:1]).all()))
    out["peak_memory_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    if not (all(out["identical"]) and all(
            math.isfinite(s["loss"]) for s in out["steps"])):
        raise AssertionError(f"mesh rank {rank}: the compressed DP replicas "
                             f"differ or a loss is not finite: {out}")
    return out


MESH_FAMILIES = {  # arch: (layers, encoder layers, requests, prompt, new)
    # a depth cut of 48 layers: two run the seq_sp hand-off between
    # Mamba2 layers
    "mamba2-780m": (2, None, 4, 2048, 8),
    # lm_serve's cut of 72 layers: m+MLP, m+MoE, m+MLP, m+MoE, a+MLP
    "jamba-1.5-large-398b": (5, None, 2, 4096, 8),
    # depth cuts of 12 + 12 layers; 1500 frames and 416 tokens a request
    "whisper-small": (2, 2, 8, 416, 8),
    # a depth cut of 24 layers; 256 patches + 1792 tokens a request; its
    # 14 heads do not divide 4, so the batch spreads (attn_batch)
    "internvl2-1b": (2, None, 4, 1792, 8),
}
MESH_FAMILY_CF = 2.0           # jamba's capacity factor on both sides (the
                               # phase fails if a pair drops), as mixtral's
MESH_DRY_FAMILY = "whisper-small"   # the served path dryrun_mesh_check holds
MESH_ROWS = {                  # the flash shapes timed on rank 0 (8j-8m)
    "jamba-1.5-large-398b": ("self",),
    "whisper-small": ("encoder", "cross"),
    "internvl2-1b": ("self",),
}
TP_TRAIN_ARCH = "gemma-2b"
TP_TRAIN_LAYERS = 1            # a depth cut (18 layers)
TP_TRAIN_MESH = (2, 2)         # (data, model): both axes at once
TP_TRAIN_B, TP_TRAIN_S, TP_TRAIN_STEPS = 2, 2048, 3


def _family_cfg(arch):
    """A MESH_FAMILIES config at full width, its depth cut (whisper's
    encoder too), a MoE at MESH_FAMILY_CF."""
    from repro_torch.configs import get_config

    layers, enc = MESH_FAMILIES[arch][:2]
    cfg = _cut(get_config(arch), layers)
    if enc is not None:
        cfg = dataclasses.replace(cfg, enc_layers=enc)
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=MESH_FAMILY_CF))
    return cfg


def _family_inputs(cfg, arch, torch, dev="cuda"):
    """(numpy prompts, the tokens on ``dev``, the front end's input, the
    cache's length)."""
    B, S, new = MESH_FAMILIES[arch][2:]
    prompts = np.random.default_rng(MESH_SEED).integers(
        0, cfg.vocab, (B, S)).astype(np.int32)
    patches = cfg.vis_seq if cfg.family == "vlm" else 0
    return (prompts, torch.as_tensor(prompts, device=dev),
            _front_end(cfg, B, torch), patches + S + new)


def _family_references(torch, tmp: Path) -> dict:
    """Each MESH_FAMILIES model's one-process meshless run on the seeded
    weights the ranks take their blocks of: the last-token prefill
    logits, the greedy next token and one decode step's logits, saved
    for the ranks; and the TP train step's step 0 (``_tp_train_ref``)."""
    from repro_torch.models import model as M
    from repro_torch.models import moe as MOE

    out = {}
    for arch in MESH_FAMILIES:
        cfg = _family_cfg(arch)
        t0 = time.perf_counter()
        params = M.init_params(cfg, seed=MESH_SEED, device="cuda")
        _, tok, front, max_len = _family_inputs(cfg, arch, torch)
        pc, dc = [], []
        with torch.no_grad(), MOE.record_drops() as drops:
            with _routing(MOE, pc, torch):
                lk, cache, pos = M.prefill(cfg, params, tok, max_len,
                                           **front)
            nxt = torch.argmax(lk[:, -1, :cfg.vocab], -1)[:, None].to(
                torch.int32)
            with _routing(MOE, dc, torch):
                ld, _ = M.decode_step(cfg, params, cache, nxt, torch.full(
                    (tok.shape[0], 1), pos, dtype=torch.int32,
                    device="cuda"))
        ref = dict(prefill=lk.float().cpu(), decode=ld.float().cpu(),
                   next=nxt.cpu(), drops=[int(d) for d in drops],
                   routes_prefill=[c["ids"].cpu() for c in pc],
                   routes_decode=[c["ids"].cpu() for c in dc])
        torch.save(ref, tmp / f"fam_{arch}.pt")
        out[arch] = dict(seconds=time.perf_counter() - t0,
                         drops=ref["drops"])
        del params, cache, lk, ld, front, tok
        torch.cuda.empty_cache()
    out["tp_train"] = _tp_train_ref(torch, tmp)
    return out


def _tp_cfg():
    from repro_torch.configs import get_config

    return _cut(get_config(TP_TRAIN_ARCH), TP_TRAIN_LAYERS)


def _tp_tc():
    from repro_torch.train import TrainConfig

    return TrainConfig(optimizer="adamw", learning_rate=TRAIN_LR,
                       warmup_steps=1, total_steps=TP_TRAIN_STEPS)


def _capture_grads(store: list):
    """A stand-in for ``optimizer.clip_by_global_norm`` that keeps a copy
    of the first gradients the train step hands it (the reduced,
    unclipped gradients), then clips as the step does."""
    from repro_torch.train import optimizer as OPT

    clip = OPT.clip_by_global_norm

    def wrapped(tree, max_norm, norm=None):
        if not store:
            store.append({k: g.detach().clone() for k, g in tree.items()})
        return clip(tree, max_norm, norm)

    return wrapped


def _tp_train_ref(torch, tmp: Path) -> dict:
    """The TP train step's one-process reference: step 0 of the same
    seeded weights and batch meshless, its loss and its gradients saved
    for the ranks."""
    from unittest import mock

    from repro_torch.data import SyntheticTokens
    from repro_torch.models import model as M
    from repro_torch.train import loop as LOOP
    from repro_torch.train import make_optimizer, make_train_step

    t0 = time.perf_counter()
    cfg, tc = _tp_cfg(), _tp_tc()
    params = M.init_params(cfg, seed=MESH_SEED, device="cuda")
    opt = make_optimizer(tc)
    state = opt.init(params)
    batch = SyntheticTokens(cfg, TP_TRAIN_B, TP_TRAIN_S, seed=0,
                            device="cuda").batch_at(0)
    grads = []
    with mock.patch.object(LOOP.OPT, "clip_by_global_norm",
                           _capture_grads(grads)):
        _, _, m = make_train_step(cfg, tc, opt=opt)(params, state, batch)
    torch.save(dict(loss=float(m["loss"]), grads={
        k: g.cpu() for k, g in grads[0].items()}), tmp / "tp_ref.pt")
    out = dict(seconds=time.perf_counter() - t0, loss=float(m["loss"]),
               grad_norm=float(m["grad_norm"]))
    del params, state, grads, opt
    torch.cuda.empty_cache()
    return out


def _clone_tree(tree):
    """A copy of every tensor of a nest of tuples, dicts and NamedTuples
    (a decode cache: decode steps write theirs in place)."""
    if hasattr(tree, "clone"):
        return tree.clone()
    if isinstance(tree, dict):
        return {k: _clone_tree(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_clone_tree(t) for t in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_clone_tree(t) for t in tree)
    return tree


def _mesh_family(rank, tmp, mesh, torch, tdist, counters, arch) -> dict:
    """One MESH_FAMILIES model on this rank of the (data 1, model 4)
    mesh: its blocks drawn (one rank at a time: a leaf is drawn whole,
    up to 6.4 GB for jamba's experts), the engine's served run from
    zeroed counts, its prefill probed (its collectives counted, its
    rise of memory, the flash inputs kept by kind, the logits and a copy
    of the cache), one decode step from that cache; the logits of both
    against the meshless run (a MoE model: a prefill and a decode step
    of their own under the meshless run's routing, ``_routing``, so a
    pick that a rounding difference flips is printed, not compared);
    the kept flash inputs against the plain attention, the MESH_ROWS
    shapes timed on rank 0 alone."""
    from unittest import mock

    import torch.nn.functional as F

    from repro_torch.dist.sharding import NamedSharding
    from repro_torch.kernels import flash_attention as KF
    from repro_torch.launch.mesh import record_collectives
    from repro_torch.launch.op_count import flash_counts
    from repro_torch.models import attention as ATT
    from repro_torch.models import model as M
    from repro_torch.models import moe as MOE
    from repro_torch.serve import GenerationConfig, ServeEngine

    dev = mesh.device
    cfg = _family_cfg(arch)
    ref = torch.load(tmp / f"fam_{arch}.pt")
    t0 = time.perf_counter()
    for turn in range(MESH_RANKS):
        if turn == rank:
            params = M.init_params(cfg, seed=MESH_SEED, device=dev,
                                   mesh=mesh)
            torch.cuda.synchronize(dev)
            torch.cuda.empty_cache()
        tdist.barrier()
    out = dict(init_s=time.perf_counter() - t0, shard_bytes=sum(
        p.numel() * p.element_size() for p in params.parameters()))
    prompts, tok, front, max_len = _family_inputs(cfg, arch, torch, dev)
    new = MESH_FAMILIES[arch][4]
    kept, probe = {}, {}
    flash, prefill = ATT.flash_attention, M.prefill

    def keep(q, k, v, **kw):
        kind = ("self" if kw.get("causal", True) else
                "encoder" if q.shape[2] == k.shape[2] else "cross")
        kept.setdefault(kind, (q, k, v, kw))
        return flash(q, k, v, **kw)

    def probed_prefill(*a, **kw):
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        before = torch.cuda.memory_allocated(dev)
        with record_collectives() as stats, \
                mock.patch.object(ATT, "flash_attention", keep):
            t0 = time.perf_counter()
            res = prefill(*a, **kw)
            torch.cuda.synchronize(dev)
            wall = time.perf_counter() - t0
        probe.update(rise=torch.cuda.max_memory_allocated(dev) - before,
                     collectives=dict(
                         wall_s=wall, calls=stats.calls, bytes=stats.bytes,
                         seconds=stats.seconds,
                         share=sum(stats.seconds.values()) / wall),
                     logits=res[0].clone(), cache=_clone_tree(res[1]),
                     pos=res[2])
        return res

    engine = ServeEngine(cfg, params, max_len=max_len, mesh=mesh)
    tdist.barrier()
    _reset(counters)
    with MOE.record_drops() as drops, \
            mock.patch.object(M, "prefill", probed_prefill):
        served = engine.generate(prompts, GenerationConfig(
            max_new_tokens=new), **front)
    torch.cuda.synchronize(dev)
    out.update(launches=_counts(counters), timing=dict(engine.timing),
               tokens=served.tolist(), drops=int(sum(int(d) for d in drops)),
               prefill_rise=probe["rise"],
               collectives_prefill=probe["collectives"])
    whole = NamedSharding(mesh, (None, None,
                                 M._table_sharding(cfg, mesh).spec[0]))
    positions = torch.full((tok.shape[0], 1), probe["pos"],
                           dtype=torch.int32, device=dev)
    nxt = ref["next"].to(dev)
    with torch.no_grad():
        if cfg.moe is None:
            lk = probe["logits"]
            ld, _ = M.decode_step(cfg, params, probe["cache"], nxt,
                                  positions, mesh)
        else:               # the meshless run's routing on both sides
            own = []
            with MOE.record_drops() as cd, _routing(
                    MOE, own, torch, force=_rank_routes(ref, mesh, tok)):
                lk, cache, _ = M.prefill(cfg, params, tok, max_len, mesh,
                                         **front)
                ld, _ = M.decode_step(cfg, params, cache, nxt, positions,
                                      mesh)
            del cache
            out["router_flips"] = [int((c["ids"] != c["run"]).any(-1).sum())
                                   for c in own]
            out["drops"] += int(sum(int(d) for d in cd))
        out["rel_err"] = dict(
            prefill=_rel(whole.gather(lk)[..., :cfg.vocab].cpu(),
                         ref["prefill"][..., :cfg.vocab]),
            decode=_rel(whole.gather(ld)[..., :cfg.vocab].cpu(),
                        ref["decode"][..., :cfg.vocab]),
            tolerance=LM_TOL)
    del lk, ld, probe
    out["kernels"] = {}
    for kind, (q, k, v, kw) in sorted(kept.items()):
        with torch.no_grad():
            got = KF.flash_attention(q, k, v, **kw)
            plain = KF.plain_attention(q, k, v, **kw)
        err = got.float() - plain.float()
        res = dict(shape=dict(B=q.shape[0], Hq=q.shape[1], Hkv=k.shape[1],
                              Sq=q.shape[2], Sk=k.shape[2], D=q.shape[3],
                              causal=kw.get("causal", True)),
                   variant=KF.kernel_variant(q.dtype, q.shape[3],
                                             k.shape[2]),
                   rel_err=float(err.norm() / plain.float().norm()),
                   max_abs_err=float(err.abs().max()),
                   max_rel_err=float((err.abs() / plain.float().abs()
                                      .clamp(min=1e-30)).max()))
        del got, plain, err
        if rank == 0 and kind in MESH_ROWS.get(arch, ()):
            flops, nbytes = flash_counts(q, k, v, res["shape"]["causal"],
                                         kw.get("window"))
            bound = _bound(nbytes, flops, BF16_OPS_PER_S)
            causal = res["shape"]["causal"]
            res.update(
                ms=_time_ms(lambda: KF.flash_attention(q, k, v, **kw)),
                plain_ms=_time_ms(lambda: KF.plain_attention(
                    q, k, v, **kw), 3, 3),
                library_ms=_time_ms(lambda: F.scaled_dot_product_attention(
                    q, k, v, is_causal=causal, enable_gqa=True)),
                bound_ms=bound[0], bound_by=bound[1], gflop=flops / 1e9)
        out["kernels"][kind] = res
        tdist.barrier()                 # rank 0 times alone
    bad = {k: r["rel_err"] for k, r in out["kernels"].items()
           if not r["rel_err"] <= LM_TOL}
    if bad or not (out["rel_err"]["prefill"] <= LM_TOL
                   and out["rel_err"]["decode"] <= LM_TOL
                   and out["drops"] == 0):
        raise AssertionError(f"mesh rank {rank} {arch}: off the meshless "
                             f"run or the plain attention ({bad}), or "
                             f"pairs dropped: {out}")
    out["peak_memory_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    del params, engine, kept, front, tok
    torch.cuda.empty_cache()
    out["s"] = time.perf_counter() - t0
    if rank == 0:
        print(f"lm_mesh/{arch} rank 0: done in {out['s']!r} s", flush=True)
    tdist.barrier()
    return out


def _rank_routes(ref, mesh, tok):
    """The meshless run's expert ids of each MoE call (prefill's, then
    the decode step's), cut to this rank's tokens: the prefill's
    all-to-all schedule routes its sequence block over ``model``, the
    decode step's EP psum every token of the batch."""
    B, S = tok.shape
    n, r = mesh.count("model"), mesh.index("model")
    out = []
    for ids in ref["routes_prefill"]:
        k = ids.shape[-1]
        out.append(ids.view(B, S, k)[:, r * S // n:(r + 1) * S // n]
                   .reshape(-1, k).to(mesh.device))
    return out + [ids.to(mesh.device) for ids in ref["routes_decode"]]


def _tp_train(rank, tmp, torch, tdist) -> dict:
    """Gemma-2B at full width cut to TP_TRAIN_LAYERS over a (data 2,
    model 2) mesh under DEFAULT_RULES (the weights split over model, the
    batch over data), AdamW, TP_TRAIN_STEPS steps of the global batch of
    TP_TRAIN_B x TP_TRAIN_S: step 0's loss and its gradients (gathered
    over the ranks) within GRAD_TOL of the one-process step's, step 1's
    collectives and peak kept for the dry run, and the two replicas of
    each block equal bit for bit after every step."""
    from unittest import mock

    from repro_torch.data import SyntheticTokens
    from repro_torch.dist.sharding import DEFAULT_RULES, use_rules
    from repro_torch.launch.dryrun import tree_bytes
    from repro_torch.launch.mesh import (all_gather, all_reduce,
                                         make_host_mesh, record_collectives)
    from repro_torch.models import model as M
    from repro_torch.train import loop as LOOP
    from repro_torch.train import make_optimizer, make_train_step
    from repro_torch.train import optimizer as OPT

    mesh = make_host_mesh(TP_TRAIN_MESH[1], device="cuda")
    dev = mesh.device
    cfg, tc = _tp_cfg(), _tp_tc()
    ref = torch.load(tmp / "tp_ref.pt", mmap=True)
    out = dict(mesh=mesh.shape, steps=[], identical=[])
    with use_rules(DEFAULT_RULES):
        params = M.init_params(cfg, seed=MESH_SEED, device=dev, mesh=mesh)
        opt = make_optimizer(tc)
        state = opt.init(params)
        step = make_train_step(cfg, tc, opt=opt, mesh=mesh)
        data = SyntheticTokens(cfg, TP_TRAIN_B, TP_TRAIN_S, seed=0,
                               device=dev)
        out["args"] = dict(params=tree_bytes(params),
                           opt_state=tree_bytes(tuple(state)))
        grads = []
        for i in range(TP_TRAIN_STEPS):
            batch = data.batch_at(i)
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            before = torch.cuda.memory_allocated(dev)
            t0 = time.perf_counter()
            with record_collectives() as stats, mock.patch.object(
                    LOOP.OPT, "clip_by_global_norm", _capture_grads(grads)):
                params, state, m = step(params, state, batch)
            torch.cuda.synchronize(dev)
            out["steps"].append(dict(
                s=time.perf_counter() - t0, loss=float(m["loss"]),
                grad_norm=float(m["grad_norm"]),
                rise=torch.cuda.max_memory_allocated(dev) - before,
                calls=dict(stats.calls), bytes=dict(stats.bytes)))
            fp = _fingerprint(OPT.named_leaves(params), torch)
            every = all_gather(mesh, fp[None], "data", 0)
            out["identical"].append(bool((every == every[:1]).all()))
            if i == 0:                 # step 0's gradients against the ref
                axes = LOOP.leaf_axes(cfg, mesh)
                specs = M.param_specs(cfg, mesh)
                sums = torch.zeros(2, dtype=torch.float64, device=dev)
                for k, g in grads[0].items():
                    want = specs[k].shard(ref["grads"][k]).to(dev)
                    share = 1.0 / mesh.count(axes[k][1])
                    sums += share * torch.stack([
                        (g.double() - want.double()).square().sum(),
                        want.double().square().sum()])
                sums = all_reduce(mesh, sums, ("data", "model"))
                out["step0"] = dict(
                    loss=float(m["loss"]), ref_loss=ref["loss"],
                    loss_rel_err=abs(float(m["loss"]) - ref["loss"])
                    / abs(ref["loss"]),
                    grad_rel_err=float(sums[0].sqrt() / sums[1].sqrt()),
                    tolerance=GRAD_TOL)
                grads.clear()
                grads.append(None)      # capture no more
    out["peak_memory_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    s0 = out["step0"]
    if not (all(out["identical"]) and s0["loss_rel_err"] <= GRAD_TOL
            and s0["grad_rel_err"] <= GRAD_TOL
            and all(math.isfinite(s["loss"]) for s in out["steps"])):
        raise AssertionError(f"mesh rank {rank}: the TP train step is off "
                             f"the one-process step, a loss is not finite "
                             f"or the replicas differ: {out}")
    del params, state, opt, step
    torch.cuda.empty_cache()
    return out


def dryrun_family_check(tag, arch, ranks) -> dict:
    """(c') the dry rank of each real rank of one MESH_FAMILIES path: its
    shard bytes and one prefill's collective calls and payload bytes by
    kind exactly, and its predicted peak over the card's (shard and
    input bytes plus the prefill's rise) within PEAK_BAND."""
    from repro_torch.dist.sharding import DEFAULT_RULES
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import make_dry_mesh
    from repro_torch.launch.shapes import ShapeSpec

    cfg = _family_cfg(arch)
    B, S = MESH_FAMILIES[arch][2:4]
    max_len = ((cfg.vis_seq if cfg.family == "vlm" else 0) + S
               + MESH_FAMILIES[arch][4])
    out = {}
    for res in ranks:
        r, fam = res["rank"], res["families"][arch]
        t0 = time.perf_counter()
        dry = D.trace_cell(cfg, ShapeSpec(tag, S, B, "prefill"),
                           make_dry_mesh(("data", "model"), (1, MESH_RANKS),
                                         r),
                           rules=DEFAULT_RULES, max_len=max_len)
        rt = f"{tag} rank {r}"
        mem = dry["memory"]
        _exact(rt, "shard bytes", mem["params_bytes"], fam["shard_bytes"])
        coll = fam["collectives_prefill"]
        _exact(rt, "collective calls", dry["collectives"]["calls"],
               coll["calls"])
        _exact(rt, "collective payload bytes",
               dry["collectives"]["payload_bytes"], coll["bytes"])
        measured = (fam["shard_bytes"] + mem["inputs_bytes"]
                    + fam["prefill_rise"])
        out[f"rank {r}"] = dict(
            trace_s=time.perf_counter() - t0,
            predicted_peak=dry["bytes_per_device"], measured_peak=measured,
            peak_ratio=_peak_ratio(rt, dry["bytes_per_device"], measured,
                                   True),
            wire_bytes=dry["collectives"]["by_kind"],
            roofline=dry["roofline"])
    print(f"{tag} dry run: {out}", flush=True)
    return out


def dryrun_tp_train_check(tag, ranks) -> dict:
    """(d') the dry rank of each real rank of the TP train step: its
    parameter plus AdamW bytes and step 1's collective calls and payload
    bytes by kind exactly, and its predicted peak over step 1's
    (arguments plus the step's rise) within PEAK_BAND."""
    from repro_torch.dist.sharding import DEFAULT_RULES
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import make_dry_mesh
    from repro_torch.launch.shapes import ShapeSpec

    cfg = _tp_cfg()
    out = {}
    for res in ranks:
        r, tr = res["rank"], res["tp_train"]
        t0 = time.perf_counter()
        dry = D.trace_cell(cfg, ShapeSpec(tag, TP_TRAIN_S, TP_TRAIN_B,
                                          "train"),
                           make_dry_mesh(("data", "model"), TP_TRAIN_MESH, r),
                           rules=DEFAULT_RULES)
        rt = f"{tag} rank {r}"
        mem = dry["memory"]
        _exact(rt, "parameter + optimizer-state bytes",
               mem["params_bytes"] + mem["opt_state_bytes"],
               tr["args"]["params"] + tr["args"]["opt_state"])
        step = tr["steps"][1]
        _exact(rt, "collective calls", dry["collectives"]["calls"],
               step["calls"])
        _exact(rt, "collective payload bytes",
               dry["collectives"]["payload_bytes"], step["bytes"])
        measured = (tr["args"]["params"] + tr["args"]["opt_state"]
                    + mem["inputs_bytes"] + step["rise"])
        out[f"rank {r}"] = dict(
            trace_s=time.perf_counter() - t0,
            predicted_peak=dry["bytes_per_device"], measured_peak=measured,
            peak_ratio=_peak_ratio(rt, dry["bytes_per_device"], measured,
                                   True),
            wire_bytes=dry["collectives"]["by_kind"],
            roofline=dry["roofline"])
    print(f"{tag} dry run: {out}", flush=True)
    return out


def _family_rows(ranks) -> list:
    """Rows 8j-8m: the flash kernel at each MESH_ROWS shape on rank 0's
    block, its launches the wgmma kernel's on that path by rank."""
    rows = []
    for arch, kinds in MESH_ROWS.items():
        for kind in kinds:
            k0 = ranks[0]["families"][arch]["kernels"][kind]
            name = "flash_attention_" + k0["variant"]
            by_rank = {f"rank {res['rank']}":
                       res["families"][arch]["launches"].get(name, 0)
                       for res in ranks}
            row = _row(f"flash_attention_mesh/{arch}/{kind}",
                       "src/repro_torch/kernels/flash_attention/csrc/"
                       "flash_attention_wgmma.cu",
                       "src/repro/kernels/flash_attention/"
                       "flash_attention.py:74",
                       (k0["max_abs_err"], k0["max_rel_err"]), k0["ms"],
                       k0["plain_ms"], (k0["bound_ms"], k0["bound_by"]),
                       k0["library_ms"])
            row.update(counter=name, launches=sum(by_rank.values()),
                       launches_by_path={f"lm_mesh/{arch}": by_rank},
                       shape=k0["shape"], rel_err_by_rank={
                           f"rank {res['rank']}":
                           res["families"][arch]["kernels"][kind]["rel_err"]
                           for res in ranks})
            rows.append(row)
    return rows


def _check_families(ranks) -> dict:
    """Per MESH_FAMILIES path: every rank launched the flash kernel once
    an attention layer of the prefill and once a cross-attention layer
    a decode step (none for mamba2), and the ranks served the same
    tokens.  Prints each rank's figures."""
    out = {}
    for arch in MESH_FAMILIES:
        cfg = _family_cfg(arch)
        tag = f"lm_mesh/{arch}"
        by_rank = {}
        for res in ranks:
            fam = res["families"][arch]
            flash = {k: v for k, v in fam["launches"].items()
                     if k.startswith("flash_attention_") and v}
            want = (_attention_layers(cfg) + _cross_layers(cfg)
                    * fam["timing"]["decode_steps"])
            got = sum(flash.values())
            by_rank[f"rank {res['rank']}"] = flash
            print(f"{tag} rank {res['rank']}: shard_bytes="
                  f"{fam['shard_bytes']} init_s={fam['init_s']!r} "
                  f"prefill_s={fam['timing']['prefill_s']!r} "
                  f"decode_ms_per_token={fam['timing']['decode_s'] / fam['timing']['decode_steps'] * 1e3!r} "
                  f"peak_memory_gb={fam['peak_memory_gb']!r} flash={flash} "
                  f"(expected {want}) drops={fam['drops']} router flips "
                  f"against the meshless routing {fam.get('router_flips')} "
                  f"vs the meshless run {fam['rel_err']}; in {fam['s']!r} "
                  f"s; collectives of one prefill "
                  f"{fam['collectives_prefill']}; kernels vs plain "
                  f"{fam['kernels']}", flush=True)
            if got != want or len(flash) > 1:
                raise AssertionError(f"{tag} rank {res['rank']}: flash "
                                     f"launches {flash}, expected {want} of "
                                     "one kernel")
        if len({json.dumps(res["families"][arch]["tokens"])
                for res in ranks}) != 1:
            raise AssertionError(f"{tag}: the ranks served different tokens")
        out[arch] = dict(flash_by_rank=by_rank, first_request_tokens=ranks[0][
            "families"][arch]["tokens"][0], rel_err={
                f"rank {res['rank']}": res["families"][arch]["rel_err"]
                for res in ranks})
    return out


def lm_mesh_phase(torch) -> tuple:
    """Mixtral-8x22B served at full width (depth cut to MESH_LAYERS) over
    a (data 1, model 4) mesh of four ranks on the one card; then the int8
    compressed DP train step; then, in the same ranks, the MESH_FAMILIES
    paths and the TP train step (``_mesh_family``, ``_tp_train``).
    Returns (the kernel rows 8i-8m, summary)."""
    import socket
    import tempfile

    import torch.multiprocessing as mp

    tag = f"lm_mesh/{MESH_ARCH}"
    cfg, no_drop = _mesh_cfgs()
    full = _cut(cfg, None)
    print(f"{tag}: {cfg.name} at full width (d {cfg.d_model}, heads "
          f"{cfg.n_heads}/{cfg.n_kv_heads}, {cfg.moe.n_experts} experts of "
          f"{cfg.moe.d_expert}, vocab {cfg.padded_vocab}, window "
          f"{cfg.window}); depth cut to {cfg.n_layers} of 56 layers; "
          f"{MESH_RANKS} ranks as a (data 1, model {MESH_RANKS}) mesh; "
          f"{MESH_B} x {MESH_S} prompts, {MESH_NEW} greedy tokens; capacity "
          f"factor {cfg.moe.capacity_factor} served, "
          f"{no_drop.moe.capacity_factor} for the no-drop check; then "
          f"{MESH_TRAIN_ARCH} at full width cut to {MESH_TRAIN_LAYERS} "
          f"layer over (data {MESH_TRAIN_DATA}, model 1) on ranks 0-"
          f"{MESH_TRAIN_DATA - 1} (data cut from {MESH_RANKS}), int8 "
          f"compression, "
          f"{MESH_TRAIN_STEPS} steps", flush=True)
    del full
    summary = {}
    with tempfile.TemporaryDirectory() as tmp:
        ref = _mesh_reference(torch, Path(tmp))
        summary["meshless"] = dict(seconds=ref["seconds"],
                                   drops_cf=ref["drops_cf"],
                                   drops_no_drop=ref["drops_no_drop"])
        print(f"{tag} meshless reference: {summary['meshless']}",
              flush=True)
        if any(ref["drops_no_drop"]):
            raise AssertionError(f"{tag}: the meshless run dropped pairs at "
                                 "the no-drop capacity factor")
        t0 = time.perf_counter()
        summary["family_refs"] = _family_references(torch, Path(tmp))
        fam_ref_s = time.perf_counter() - t0
        print(f"lm_mesh families meshless references: "
              f"{summary['family_refs']} in {fam_ref_s!r} s", flush=True)
        if any(sum(r["drops"]) for a, r in summary["family_refs"].items()
               if a != "tp_train"):
            raise AssertionError("lm_mesh families: a meshless run dropped "
                                 f"pairs at capacity factor {MESH_FAMILY_CF}")
        torch.cuda.empty_cache()
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        t0 = time.perf_counter()
        mp.spawn(_mesh_rank, args=(tmp, port), nprocs=MESH_RANKS, join=True)
        summary["ranks_s"] = time.perf_counter() - t0
        ranks = []
        for r in range(MESH_RANKS):
            with open(Path(tmp) / f"rank{r}.json") as f:
                ranks.append(json.load(f))
    for res in ranks:
        r = res["rank"]
        kern = res["kernel"]
        print(f"{tag} rank {r}: coords={res['coords']} {res['device']} "
              f"backend={res['backend']} staged={res['staged']} "
              f"shard_bytes={res['shard_bytes']} of {res['full_bytes']} "
              f"({res['shard_bytes'] / res['full_bytes']!r}) init_s="
              f"{res['init_s']!r}", flush=True)
        print(f"{tag} rank {r}: prefill_s={res['timing']['prefill_s']!r} "
              f"decode_ms_per_token={res['decode_ms_per_token']!r} "
              f"peak_memory_gb={res['peak_memory_gb']!r} (served "
              f"{res['peak_memory_gb_served']!r}) launches="
              f"{ {k: v for k, v in res['launches'].items() if v} } "
              f"prefill_drops_by_layer={res['prefill_drops_by_layer']} "
              f"(capacity factor {cfg.moe.capacity_factor})", flush=True)
        print(f"{tag} rank {r}: collectives of one prefill "
              f"{res['collectives_prefill']}", flush=True)
        print(f"{tag} rank {r}: vs the meshless run at capacity factor "
              f"{cfg.moe.capacity_factor} (printed, not held): "
              f"{res['rel_err_vs_meshless_cf']}; at the no-drop "
              f"{res['no_drop']}", flush=True)
        print(f"{tag} rank {r}: flash on its heads of layer 0 "
              f"{kern['shape']} ({kern['variant']}): rel_err="
              f"{kern['rel_err']!r} max_abs_err={kern['max_abs_err']!r} "
              f"kernel_ms={kern['ms']!r} plain_ms={kern['plain_ms']!r} "
              f"sdpa_ms={kern['library_ms']!r} bound_ms={kern['bound_ms']!r}"
              f" ({kern['bound_by']}, {kern['gflop']!r} GFLOP)", flush=True)
        print(f"{tag} rank {r}: before the train step "
              f"{res['before_train']}; train {res['train']}", flush=True)
    summary["dryrun"] = dryrun_mesh_check(tag, cfg, ranks)
    t0 = time.perf_counter()
    summary["families"] = _check_families(ranks)
    for res in ranks:
        tr = res["tp_train"]
        print(f"lm_mesh_train/{TP_TRAIN_ARCH} rank {res['rank']}: "
              f"mesh={tr['mesh']} step0={tr['step0']} steps="
              f"{[{k: v for k, v in st.items() if k not in ('calls', 'bytes')} for st in tr['steps']]} "
              f"replicas identical={tr['identical']} peak_memory_gb="
              f"{tr['peak_memory_gb']!r}", flush=True)
    summary["tp_train"] = {f"rank {res['rank']}": res["tp_train"]
                           for res in ranks}
    summary["dryrun_families"] = {
        MESH_DRY_FAMILY: dryrun_family_check(f"lm_mesh/{MESH_DRY_FAMILY}",
                                             MESH_DRY_FAMILY, ranks),
        f"train/{TP_TRAIN_ARCH}": dryrun_tp_train_check(
            f"lm_mesh_train/{TP_TRAIN_ARCH}", ranks)}
    ranks_fam_s = max(res["families_s"] for res in ranks)
    summary["families_s"] = dict(
        meshless_refs=fam_ref_s, ranks=ranks_fam_s,
        checks=time.perf_counter() - t0,
        total=fam_ref_s + ranks_fam_s + time.perf_counter() - t0)
    print(f"lm_mesh families (the ssm, hybrid, encdec and vlm paths and the "
          f"TP train step): {summary['families_s']} s", flush=True)
    name = "flash_attention_" + ranks[0]["kernel"]["variant"]
    by_rank = {f"rank {res['rank']}": res["launches"].get(name, 0)
               for res in ranks}
    if set(by_rank.values()) != {cfg.n_layers}:
        raise AssertionError(f"{tag}: flash launches by rank {by_rank}, "
                             f"expected {cfg.n_layers} each (one a layer)")
    if len({json.dumps(res["tokens"]) for res in ranks}) != 1:
        raise AssertionError(f"{tag}: the ranks served different tokens")
    k0 = ranks[0]["kernel"]
    row = _row("flash_attention_mesh",
               "src/repro_torch/kernels/flash_attention/csrc/"
               "flash_attention_wgmma.cu",
               "src/repro/kernels/flash_attention/flash_attention.py:74",
               (k0["max_abs_err"], k0["max_rel_err"]), k0["ms"],
               k0["plain_ms"], (k0["bound_ms"], k0["bound_by"]),
               k0["library_ms"])
    row["counter"] = name
    row["launches"] = sum(by_rank.values())
    row["launches_by_path"] = {tag: by_rank}
    row["shape"] = k0["shape"]
    row["by_rank"] = {f"rank {res['rank']}": res["kernel"] for res in ranks}
    summary.update(
        n_layers=cfg.n_layers, ranks=[{k: v for k, v in res.items()
                                       if k not in ("kernel", "tokens",
                                                    "families", "tp_train")}
                                      for res in ranks],
        first_request_tokens=ranks[0]["tokens"][0])
    return [row] + _family_rows(ranks), summary


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def _digest(out) -> str:
    """A digest of the bytes of a tensor or a tuple of tensors: equal
    digests, equal bits."""
    import torch

    h = hashlib.sha1()
    for t in out if isinstance(out, tuple) else (out,):
        # the raw bytes: numpy has no bfloat16
        h.update(t.contiguous().view(-1).view(torch.uint8).cpu().numpy()
                 .tobytes())
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
    ``delaunay_graph(20)`` and at k = 1, with the inputs and timer of the
    full run and by the profiler's device time, and print one JSON line
    with the card's name and power limit."""
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
    # k = 1: the inverse_power solver's column, and the other two wrappers
    X1, U1, E1 = (T[:, :1].contiguous() for T in (X, U, E))
    calls["sellcs_spmm scalar k=1"] = lambda: K.sellcs_spmm(W, X1)
    calls["sellcs_plap_apply k=1"] = lambda: K.sellcs_plap_apply(
        W, U1, P, EPS)
    calls["sellcs_plap_hvp k=1"] = lambda: K.sellcs_plap_hvp(
        W, U1, E1, P, EPS)
    _ab_line(src, calls, device=True)
    return 0


def flash_times(src: Path, torch) -> int:
    """``--flash-src``: time ``flash_attention`` of the tree at ``src``
    (its ``repro_torch`` imported and built) at the shapes of
    ``FLASH_AB``, with the inputs and timer of phase 9, by CUDA events
    and by the profiler's device time, and print one JSON line with the
    card's name and power limit."""
    sys.path.insert(0, str(src.resolve()))
    from repro_torch.kernels import flash_attention as KF

    KF.build()
    gen = torch.Generator(device="cuda").manual_seed(2)
    calls = {}
    for shape in FLASH_SHAPES:
        if shape[0] in FLASH_AB:
            q, k, v = _flash_inputs(shape, gen, torch)
            calls[shape[0]] = (
                lambda q=q, k=k, v=v, c=shape[8], w=shape[9]:
                KF.flash_attention(q, k, v, causal=c, window=w))
    _ab_line(src, calls, device=True)
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
    ap.add_argument("--flash-src", type=Path, metavar="SRC",
                    help="only time flash attention of the tree whose src "
                    "directory is SRC and print one JSON line")
    ap.add_argument("--dryrun-grid", type=Path, metavar="OUT",
                    help="only run the dry run's grid (phase 10d (a)) and "
                    "write its counts to OUT: the smoke's child process")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if args.sellcs_src is not None:
        return sellcs_times(args.sellcs_src, torch)
    if args.kmeans_src is not None:
        return kmeans_times(args.kmeans_src, torch)
    if args.flash_src is not None:
        return flash_times(args.flash_src, torch)
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script",
              file=sys.stderr)
        return 2
    if args.dryrun_grid is not None:
        return dryrun_grid(args.dryrun_grid)
    with tempfile.TemporaryDirectory() as tmp:
        grid = dryrun_grid_start(Path(tmp))
        try:
            return _smoke(args, torch, grid, Path(tmp))
        finally:
            if grid[0].poll() is None:          # a phase failed first
                grid[0].kill()
                grid[0].wait()


def _smoke(args, torch, grid, tmp: Path) -> int:
    """Every phase, in order (the module docstring's); ``grid`` is the dry
    run's child, collected after phase 13."""
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
        print(f"phase {name}: {phase_s[name]!r} s (total "
              f"{sum(phase_s.values())!r} s)", flush=True)

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
    for arch in ("mixtral-8x22b", "deepseek-v3-671b", "mamba2-780m",
                 "jamba-1.5-large-398b", "whisper-small", "internvl2-1b"):
        by_path[f"lm_serve/{arch}"], lm[arch] = lm_serve_phase(
            torch, counters, arch)
        phase_done(f"lm_serve/{arch}")
    by_path[f"lm_train/{TRAIN_ARCH}"], lm_train = lm_train_phase(
        torch, counters)
    phase_done(f"lm_train/{TRAIN_ARCH}")
    mesh_rows, lm_mesh = lm_mesh_phase(torch)
    phase_done(f"lm_mesh/{MESH_ARCH}")

    # ---- the lanes that repeat whole solves, on delaunay_graph(
    # LANE_GRAPH_R) (a cut), each against the matrix_free solve there
    W, lane_ref = lane_graph_phase(W, counters, torch, psc, flat, by_path,
                                   args)
    phase_done("lane_graph")

    # ---- resilience and telemetry, on the lanes' SELL-C-σ graph
    paths, resilience = resilience_phase(W, counters, torch, psc, lane_ref,
                                         args)
    by_path.update(paths)
    phase_done("resilience")

    # ---- the clustering serve engine: bucket, solo and multilevel lanes
    paths, serve = serve_phase(W, counters, torch, psc, lane_ref, args)
    by_path.update(paths)
    phase_done("serve")

    # ---- the distributed SpMM: four ranks on the one card over gloo
    paths, dist_rows, dist_summary = dist_phase(W, counters, torch, args)
    by_path.update(paths)
    phase_done("dist")
    dryrun = dryrun_grid_phase(*grid, tmp)
    dryrun.update(lm_serve=lm["gemma-2b"]["dryrun"],
                  lm_train=lm_train["dryrun"], lm_mesh=lm_mesh["dryrun"],
                  lm_mesh_families=lm_mesh["dryrun_families"])
    phase_done("dryrun_grid")

    for row in rows:
        counter = row.get("counter", row["name"])
        row["launches_by_path"] = {p: c[counter] for p, c in by_path.items()
                                   if row.get("paths") is None
                                   or p in row["paths"]}
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
    rows += mesh_rows
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
    print(json.dumps({"lm_train": lm_train}, default=str), flush=True)
    print(json.dumps({"lm_mesh": lm_mesh}, default=str), flush=True)
    print(json.dumps({"dryrun": dryrun}, default=str), flush=True)
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
