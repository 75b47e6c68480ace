"""The pure-Python plans of the port's redesigned kernels, and their
plain versions at the shapes those plans serve, on the CPU.

  * flash attention: which kernel serves (dtype, head dim, key length),
    which takes v of a narrower value head dim as is, how the wgmma
    kernel pairs the q heads of a GQA group in one block (or, at group 1,
    two query tiles of one head), and its grid;
  * the SELL-C-σ row kernel at k = 1 (the inverse_power solver's one
    column): the width-1 instance, aligned or not;
  * BSR SpMM: the column windows and register-tile widths of a launch;
  * the BSR phi kernels (plap_apply, plap_hvp): the mode a call is routed
    to (skip zero weights, or evaluate every entry), the premise that
    makes skipping exact (a zero weight's term is exactly +-0, through
    the port's and the reference's phi), the column windows, and the tile
    limit;
  * the plain versions at the head dims and group sizes the wgmma kernel
    serves, and at the widths the main path gives the BSR kernels,
    against the reference's oracles and its Pallas kernels in interpret
    mode.

Tolerances: fp32 flash to 1e-5 (the bound of
tests/test_torch_dense_kernels.py); BSR fp32 to rtol 2e-4 / atol 2e-5 and
fp64 to 1e-12 (the bounds of tests/test_torch_bsr.py); the premise
exactly (== 0)."""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the reference-only CI has no torch

import jax.numpy as jnp
from repro.core import phi as REF_PHI
from repro.kernels.bsr_spmm import bsr_spmm_pallas, bsr_spmm_ref
from repro.kernels.flash_attention.flash_attention import \
    flash_attention_pallas
from repro.kernels.flash_attention.ref import attention_ref as ref_attention
from repro.kernels.plap_edge import (plap_apply_pallas, plap_apply_ref,
                                     plap_hvp_edge_ref, plap_hvp_pallas)

from repro_torch import convert
from repro_torch.core import phi as PHI
from repro_torch.kernels.flash_attention import flash_attention

torch.set_num_threads(1)

KF = importlib.import_module(
    "repro_torch.kernels.flash_attention.flash_attention")
KB = importlib.import_module("repro_torch.kernels.bsr_spmm.bsr_spmm")
KP = importlib.import_module("repro_torch.kernels.plap_edge.plap_edge")

BSR_TOL = {np.float32: dict(rtol=2e-4, atol=2e-5),
           np.float64: dict(rtol=1e-12, atol=1e-12)}


# ------------------------------------------------------- flash: routing

@pytest.mark.parametrize("D", [64, 128, 192, 256])
def test_flash_bf16_at_wgmma_head_dims_takes_wgmma(D):
    assert KF.kernel_variant(torch.bfloat16, D) == "wgmma"
    assert KF.kernel_variant(torch.float32, D) == "f32"
    # no keys: the mma kernel writes the zero rows
    assert KF.kernel_variant(torch.bfloat16, D, Sk=0) == "mma"


@pytest.mark.parametrize("D", [8, 16, 32, 96, 136, 248])
def test_flash_bf16_at_other_head_dims_takes_mma(D):
    assert KF.kernel_variant(torch.bfloat16, D) == "mma"
    assert KF.kernel_variant(torch.float32, D) == "f32"


@pytest.mark.parametrize("dtype,D,Dv,Sk,want", [
    (torch.bfloat16, 192, 128, 2048, True),    # MLA on wgmma: no pad
    (torch.bfloat16, 192, 192, 1, True),
    (torch.bfloat16, 128, 64, 200, False),     # wgmma, (128, 64) not compiled
    (torch.bfloat16, 192, 128, 0, False),      # no keys: the mma kernel
    (torch.bfloat16, 32, 16, 10, False),       # mma
    (torch.float32, 192, 128, 10, False),      # f32
    (torch.float32, 24, 24, 10, True),
])
def test_flash_value_dim_taken_as_is_only_where_compiled(dtype, D, Dv, Sk,
                                                          want):
    """The op pads v to D exactly where the routed kernel does not take
    its width."""
    assert KF.takes_value_dim(dtype, D, Dv, Sk) is want
    assert {s for s in KF.WGMMA_SHAPES if s[0] != s[1]} == {(192, 128)}
    assert set(KF.WGMMA_HEAD_DIMS) == {d for d, d2 in KF.WGMMA_SHAPES
                                       if d == d2}


def test_flash_variant_rejects_other_dtypes():
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        KF.kernel_variant(torch.float16, 128)


def test_flash_every_variant_has_a_launch_count():
    variants = {KF.kernel_variant(dt, D, Sk)
                for dt in (torch.bfloat16, torch.float32)
                for D in (16, 64, 256) for Sk in (0, 1)}
    assert {f"flash_attention_{v}" for v in variants} == set(KF.LAUNCHES)


# ------------------------------------------------ flash: the head pairs

@pytest.mark.parametrize("Hq,Hkv", [(8, 8), (8, 2), (14, 2), (8, 1),
                                    (16, 1), (48, 8), (32, 2)])
def test_flash_head_pairs_cover_each_q_head_once(Hq, Hkv):
    """Groups 1, 4, 7, 8, 16 and the configs' 6 and 16: every q head in
    exactly one block slot, both slots of a block on one kv head."""
    group = Hq // Hkv
    pairs = KF.head_pairs(Hq, Hkv)
    assert len(pairs) == Hkv * ((group + 1) // 2)
    heads = [h for _, h0, h1 in pairs for h in (h0, h1) if h is not None]
    assert sorted(heads) == list(range(Hq))
    for kvh, h0, h1 in pairs:
        assert h0 // group == kvh
        assert h1 is None or (h1 == h0 + 1 and h1 // group == kvh)
    idle = sum(h1 is None for _, _, h1 in pairs)
    assert idle == (Hkv if group % 2 else 0)


def test_flash_head_pairs_of_an_odd_group_idle_the_last_slot():
    """InternVL2 (14 q heads over 2 kv heads): the second warpgroup of
    each kv head's last pair is idle."""
    assert KF.head_pairs(14, 2) == [
        (0, 0, 1), (0, 2, 3), (0, 4, 5), (0, 6, None),
        (1, 7, 8), (1, 9, 10), (1, 11, 12), (1, 13, None)]
    assert KF.head_pairs(2, 2) == [(0, 0, None), (1, 1, None)]


@pytest.mark.parametrize("B,Hq,Hkv,Sq,grid", [
    (4, 8, 1, 2048, (16, 32)),      # Gemma-2B serve: 4 pairs x 4 batches
    (4, 8, 2, 2048, (16, 32)),      # group 4
    (1, 14, 2, 1000, (8, 16)),      # InternVL2, ragged
    (2, 32, 8, 1, (32, 1)),         # Granite, one token
    (1, 2, 2, 129, (2, 2)),         # group 1: 128-row tiles of one head
    (4, 128, 128, 2048, (512, 16)),  # deepseek-v3's MLA prefill
])
def test_flash_wgmma_grid(B, Hq, Hkv, Sq, grid):
    assert KF.wgmma_grid(B, Hq, Hkv, Sq) == grid


@pytest.mark.parametrize("Hq,Sq", [(2, 129), (3, 128), (1, 64), (2, 1),
                                   (4, 2048), (2, 300), (1, 320)])
def test_flash_group1_blocks_cover_each_query_tile_once(Hq, Sq):
    """At group 1 the two consumers of a block take adjacent 64-row tiles
    of its one head: every (head, 64-row tile) in exactly one slot; the
    upper slot idle only in the last tile of an odd tile count; the
    heaviest tiles first."""
    blocks = KF.wgmma_blocks(Hq, Hq, Sq)
    x_blocks, y_blocks = KF.wgmma_grid(1, Hq, Hq, Sq)
    assert (x_blocks, y_blocks) == (Hq, -(-Sq // 128))
    assert [(x, y) for x, y, _, _ in blocks] == [
        (x, y) for x in range(x_blocks) for y in range(y_blocks)]
    slots = [s for _, _, s0, s1 in blocks for s in (s0, s1) if s is not None]
    tiles = -(-Sq // 64)
    assert sorted(slots) == [(h, 64 * t) for h in range(Hq)
                             for t in range(tiles)]
    for x, y, s0, s1 in blocks:
        assert s0[0] == x and s0[1] == 128 * (y_blocks - 1 - y)
        assert s1 == (x, s0[1] + 64) or (
            s1 is None and tiles % 2 == 1 and y == 0)
    assert sum(s1 is None for *_, s1 in blocks) == (Hq if tiles % 2 else 0)


def test_flash_grouped_blocks_keep_the_head_pairs():
    """Groups of 2 or more: a block's slots are its pair of q heads at one
    64-row tile (InternVL2's group 7 leaves the last slot idle)."""
    blocks = KF.wgmma_blocks(14, 2, 130)
    assert len(blocks) == 8 * 3
    for x, y, s0, s1 in blocks:
        _, h0, h1 = KF.head_pairs(14, 2)[x]
        assert s0 == (h0, 64 * (2 - y))
        assert s1 == (None if h1 is None else (h1, 64 * (2 - y)))


# --------------------------------------------------- BSR SpMM: windows

@pytest.mark.parametrize("dtype,k,want", [
    (torch.float32, 4, [(0, 4, 4)]),
    (torch.float32, 8, [(0, 8, 8)]),
    (torch.float32, 24, [(0, 24, 24)]),
    (torch.float32, 120, [(0, 32, 32), (32, 32, 32), (64, 32, 32),
                          (96, 24, 24)]),
    (torch.float32, 1, [(0, 1, 4)]),
    (torch.float32, 13, [(0, 13, 16)]),
    (torch.float64, 4, [(0, 4, 4)]),
    (torch.float64, 8, [(0, 8, 8)]),
    (torch.float64, 24, [(0, 16, 16), (16, 8, 8)]),
    (torch.float64, 120, [(c0, 16, 16) for c0 in range(0, 112, 16)]
     + [(112, 8, 8)]),
])
def test_bsr_spmm_window_plan(dtype, k, want):
    windows = KB.spmm_windows(k, dtype)
    assert windows == want
    assert windows[0][0] == 0
    for (c0, kc, width), nxt in zip(windows, windows[1:] + [(k, 0, 0)]):
        assert c0 + kc == nxt[0] and kc <= width
        assert width in KB.SPMM_WIDTHS[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_bsr_spmm_main_path_widths_are_one_launch(dtype):
    """LOBPCG's matvec (8 columns) and its [X, R, P] block (24, fp32),
    and the k = 4 of the other stages, each run in one launch."""
    assert len(KB.spmm_windows(4, dtype)) == 1
    assert len(KB.spmm_windows(8, dtype)) == 1
    if dtype == torch.float32:
        assert len(KB.spmm_windows(24, dtype)) == 1


# ------------------------------------------- SELL-C-σ: the k = 1 instance

KS = importlib.import_module("repro_torch.kernels.sellcs_spmm.sellcs_spmm")


@pytest.mark.parametrize("name", ["sellcs_spmm", "sellcs_plap_apply",
                                  "sellcs_plap_hvp"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("aligned", [True, False])
def test_sellcs_k1_takes_the_row_kernel_at_width_1(name, dtype, aligned):
    """k = 1 runs the width-1 row instance (one value a thread, element
    alignment only), never the generic variant's chunk of 4."""
    n = 1 << 20
    assert 1 in KS.ROW_WIDTHS
    assert KS.launch_plan(name, n, 1, dtype, aligned) == KS.Plan(
        "row", 1, 1, (n // 256, 1), 256, name == "sellcs_spmm")


def test_sellcs_generic_launches_are_counted_by_wrapper():
    assert set(KS.GENERIC_LAUNCHES) == set(KS.LAUNCHES)
    KS.GENERIC_LAUNCHES["sellcs_plap_apply"] = 3
    KS.reset_launch_counts()
    assert not any(KS.GENERIC_LAUNCHES.values())


def test_import_builds_no_wgmma_library():
    lib = KF.WGMMA_LIBRARY
    assert lib._lib is None and lib._proc is None
    assert lib.path.name.startswith("flash_attention_wgmma-")


# ------------------------------------- the plain versions at those shapes

def _qkv(B, Hq, Hkv, S, D, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, Hq, S, D), (B, Hkv, S, D), (B, Hkv, S, D))]


@pytest.mark.parametrize("D,Hq,Hkv,window", [
    (64, 14, 2, None),       # InternVL2's group 7
    (128, 8, 2, 64),         # group 4, window
    (256, 8, 1, None),       # Gemma-2B's group 8
    (64, 2, 2, None),        # group 1
])
def test_flash_plain_at_wgmma_shapes_matches_reference(D, Hq, Hkv, window):
    arrs = _qkv(1, Hq, Hkv, 128, D, seed=D + Hq)
    got = flash_attention(*[torch.from_numpy(a) for a in arrs], causal=True,
                          window=window).numpy()
    jarrs = [jnp.asarray(a) for a in arrs]
    want = np.asarray(ref_attention(*jarrs, causal=True, window=window))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    pallas = np.asarray(flash_attention_pallas(*jarrs, causal=True,
                                               window=window, interpret=True))
    np.testing.assert_allclose(got, pallas, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("k", [4, 8, 24])
def test_bsr_spmm_plain_at_main_path_widths_matches_reference(dtype, k):
    """The CPU op (the plain version) against the reference's Pallas
    kernel and its oracle at each width the main path uses, on a Delaunay
    mesh with a ragged last block."""
    from repro.graphs import delaunay_graph

    ref, _ = delaunay_graph(8, build_bsr=True, block_size=32, dtype=dtype)
    W = convert.sparse_matrix(ref.host_coo(), (ref.n_rows, ref.n_cols),
                              device="cpu", build_bsr=True, block_size=32,
                              dtype=dtype)
    rng = np.random.default_rng(k)
    X = rng.standard_normal((ref.n_rows, k)).astype(dtype)
    got = convert.to_numpy(KB.bsr_spmm(W, convert.tensor(X, device="cpu")))
    n_rb = len(ref.bsr_indptr) - 1
    Xp = np.zeros((n_rb * 32, k), dtype)
    Xp[:ref.n_rows] = X
    args = [jnp.asarray(np.asarray(a)) for a in (ref.bsr_blocks,
                                                 ref.bsr_indices,
                                                 ref.bsr_row_ids)]
    pallas = bsr_spmm_pallas(*args, jnp.asarray(Xp), n_row_blocks=n_rb,
                             block_size=32, interpret=True)
    oracle = bsr_spmm_ref(*args, jnp.asarray(Xp), n_rb, 32)
    np.testing.assert_allclose(got, np.asarray(pallas)[:ref.n_rows],
                               **BSR_TOL[dtype])
    np.testing.assert_allclose(got, np.asarray(oracle)[:ref.n_rows],
                               **BSR_TOL[dtype])


# ---------------------------------------------------- BSR phi: the modes

@pytest.mark.parametrize("name,p,eps,dtype,want", [
    # the main path: p from 2 down to 1.2 at PSCConfig's eps = 1e-8
    ("plap_apply", 2.0, 1e-8, torch.float32, "skip"),
    ("plap_apply", 1.2, 1e-8, torch.float32, "skip"),
    ("plap_hvp", 2.0, 1e-8, torch.float32, "skip"),
    ("plap_hvp", 1.2, 1e-8, torch.float32, "skip"),
    ("plap_hvp", 1.2, 1e-12, torch.float64, "skip"),
    ("plap_hvp", 1.0, 1e-8, torch.float64, "skip"),
    # eps = 0: phi(0) = 0 (the apply skips), phi'(0) = inf (the hvp not)
    ("plap_apply", 1.5, 0.0, torch.float32, "skip"),
    ("plap_apply", 1.0, 0.0, torch.float64, "skip"),
    ("plap_hvp", 1.5, 0.0, torch.float32, "full"),
    ("plap_hvp", 2.0, 0.0, torch.float64, "full"),
    # p outside [1, 2]: pows of large differences overflow, phi(0) = NaN
    ("plap_apply", 2.5, 1e-8, torch.float32, "full"),
    ("plap_hvp", 3.0, 1e-8, torch.float64, "full"),
    ("plap_apply", 0.9, 0.0, torch.float64, "full"),
    # eps that fp32 cannot hold (rounds to 0), or whose eps^((p-4)/2)
    # overflows fp32 but not fp64
    ("plap_apply", 1.2, 1e-50, torch.float32, "full"),
    ("plap_apply", 1.2, 1e-50, torch.float64, "skip"),
    ("plap_hvp", 1.2, 1e-30, torch.float32, "full"),
    ("plap_hvp", 1.2, 1e-30, torch.float64, "skip"),
    # a negative eps: (x^2 + eps) < 0 near x = 0
    ("plap_apply", 1.5, -1e-8, torch.float32, "full"),
    ("plap_hvp", 1.5, -1e-8, torch.float64, "full"),
])
def test_phi_mode_routes_by_the_calls_arguments(name, p, eps, dtype, want):
    assert KP.phi_mode(name, p, eps, dtype) == want


def test_phi_every_mode_has_a_launch_count():
    keys = {KP.counter(name, mode) for name in ("plap_apply", "plap_hvp")
            for mode in ("skip", "full", "divergent")}
    assert keys == set(KP.LAUNCHES)
    assert KP.counter("plap_hvp", "skip") == "plap_hvp"
    assert KP.counter("plap_hvp", "full") == "plap_hvp_full"


def _premise_values(dtype):
    """Differences and E differences the skip mode can meet: 0, the
    smallest subnormal, tiny, unit and large values, and the largest
    below 2 x OVERFLOW_AT (the most a difference of two inputs below the
    threshold can reach), with both signs."""
    np_dt = np.dtype(dtype)
    top = np.nextafter(np_dt.type(2 * KP.OVERFLOW_AT[
        torch.float32 if np_dt == np.float32 else torch.float64]),
        np_dt.type(0))
    mags = np.array([0.0, np.finfo(np_dt).smallest_subnormal, 1e-30, 1e-4,
                     1.0, 3.5, 1e6, 1e15, top / 2, top], np_dt)
    return np.concatenate([mags, -mags[1:]])


def _zero_weight_terms(impl, name, d, de, p, eps):
    """(0 * phi(d)) or (0 * phi'(d)) * de, through the port's phi or the
    reference's, in d's dtype."""
    if impl == "port":
        d, de = torch.from_numpy(d), torch.from_numpy(de)
        zero = torch.zeros((), dtype=d.dtype)
        if name == "plap_apply":
            return (zero * PHI.phi(d, p, eps)).numpy()
        return (zero * PHI.phi_prime(d, p, eps) * de).numpy()
    d, de = jnp.asarray(d), jnp.asarray(de)
    zero = jnp.zeros((), d.dtype)
    if name == "plap_apply":
        return np.asarray(zero * REF_PHI.phi(d, p, eps))
    return np.asarray(zero * REF_PHI.phi_prime(d, p, eps) * de)


@pytest.mark.parametrize("impl", ["port", "reference"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("eps", [1e-8, 1e-12])
@pytest.mark.parametrize("p", [1.1, 1.2, 1.5, 2.0])
def test_zero_weight_terms_are_exactly_zero_in_skip_mode(impl, dtype, eps,
                                                         p):
    """The premise of the skip mode: for finite differences below the
    threshold, 0 * phi(d) and (0 * phi'(d)) * de are exactly +-0, so
    skipping a zero weight leaves every partial sum as it was."""
    vals = _premise_values(dtype)
    d, de = np.meshgrid(vals, vals, indexing="ij")
    tdt = torch.float32 if dtype == np.float32 else torch.float64
    for name in ("plap_apply", "plap_hvp"):
        assert KP.phi_mode(name, p, eps, tdt) == "skip"
        terms = _zero_weight_terms(impl, name, d.ravel(), de.ravel(), p, eps)
        assert terms.dtype == dtype
        assert np.all(terms == 0), (name, d.ravel()[terms != 0])


@pytest.mark.parametrize("impl", ["port", "reference"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("p", [1.1, 1.2, 1.5, 2.0])
def test_zero_weight_apply_terms_are_exactly_zero_at_eps_zero(impl, dtype,
                                                              p):
    """At eps = 0 the apply stays in skip mode: |d|^(p-1) sign(d) is finite
    for 1 <= p <= 2, 0 at d = 0."""
    vals = _premise_values(dtype)
    tdt = torch.float32 if dtype == np.float32 else torch.float64
    assert KP.phi_mode("plap_apply", p, 0.0, tdt) == "skip"
    terms = _zero_weight_terms(impl, "plap_apply", vals, vals, p, 0.0)
    assert np.all(terms == 0)


@pytest.mark.parametrize("impl", ["port", "reference"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("p", [1.1, 1.5])
def test_zero_weight_hvp_term_at_eps_zero_is_nan(impl, dtype, p):
    """Why the hvp at eps = 0 runs in full mode: phi'(0) = inf for p < 2,
    and a zero weight's term is 0 * inf = NaN in the reference."""
    zero = np.zeros(1, dtype)
    tdt = torch.float32 if dtype == np.float32 else torch.float64
    assert KP.phi_mode("plap_hvp", p, 0.0, tdt) == "full"
    assert np.isnan(_zero_weight_terms(impl, "plap_hvp", zero, zero + 1.0,
                                       p, 0.0)).all()


# -------------------------------------------- BSR phi: windows and tiles

@pytest.mark.parametrize("dtype,k,want", [
    (torch.float32, 1, [(0, 1, 1)]),
    (torch.float32, 3, [(0, 3, 4)]),
    (torch.float32, 4, [(0, 4, 4)]),
    (torch.float32, 8, [(0, 8, 8)]),
    (torch.float32, 20, [(0, 8, 8), (8, 8, 8), (16, 4, 4)]),
    (torch.float32, 120, [(c0, 8, 8) for c0 in range(0, 120, 8)]),
    (torch.float64, 1, [(0, 1, 1)]),
    (torch.float64, 2, [(0, 2, 2)]),
    (torch.float64, 4, [(0, 4, 4)]),
    (torch.float64, 8, [(0, 4, 4), (4, 4, 4)]),
    (torch.float64, 13, [(0, 4, 4), (4, 4, 4), (8, 4, 4), (12, 1, 1)]),
])
def test_phi_window_plan(dtype, k, want):
    windows = KP.phi_windows(k, dtype)
    assert windows == want
    for (c0, kc, width), nxt in zip(windows, windows[1:] + [(k, 0, 0)]):
        assert c0 + kc == nxt[0] and kc <= width
        assert width in KP.PHI_WIDTHS[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_phi_main_path_width_is_one_launch(dtype):
    """The k = 4 multivectors of the continuation take one launch, on the
    width-4 instance."""
    assert KP.phi_windows(4, dtype) == [(0, 4, 4)]


@pytest.mark.parametrize("name", ["plap_apply", "plap_hvp"])
def test_phi_launch_plan_takes_tiles_up_to_128(name):
    mode, windows = KP.launch_plan(name, 128, 4, torch.float32, 1.2, 1e-8)
    assert (mode, windows) == ("skip", [(0, 4, 4)])
    with pytest.raises(ValueError, match="at most 128"):
        KP.launch_plan(name, 256, 4, torch.float32, 1.2, 1e-8)


# ------------------------------------- BSR phi: the plain versions served

@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("k", [1, 4, 8])
def test_plap_plain_at_phi_widths_matches_reference(dtype, k):
    """The CPU ops (the plain versions) against the reference's Pallas
    kernels in interpret mode and its oracles, at widths of one window
    (1, 4) and of more than one in fp64 (8), on a Delaunay mesh with a
    ragged last block."""
    from repro.graphs import delaunay_graph

    ref, _ = delaunay_graph(8, build_bsr=True, block_size=32, dtype=dtype)
    W = convert.sparse_matrix(ref.host_coo(), (ref.n_rows, ref.n_cols),
                              device="cpu", build_bsr=True, block_size=32,
                              dtype=dtype)
    rng = np.random.default_rng(10 + k)
    X = rng.standard_normal((ref.n_rows, k)).astype(dtype)
    E = rng.standard_normal((ref.n_rows, k)).astype(dtype)
    p, eps = 1.3, 1e-8
    got_a = convert.to_numpy(KP.plap_apply(
        W, convert.tensor(X, device="cpu"), p, eps))
    got_h = convert.to_numpy(KP.plap_hvp(
        W, convert.tensor(X, device="cpu"), convert.tensor(E, device="cpu"),
        p, eps))
    n_rb = len(ref.bsr_indptr) - 1
    Xp, Ep = (np.zeros((n_rb * 32, k), dtype) for _ in range(2))
    Xp[:ref.n_rows], Ep[:ref.n_rows] = X, E
    args = [jnp.asarray(np.asarray(a)) for a in (ref.bsr_blocks,
                                                 ref.bsr_indices,
                                                 ref.bsr_row_ids)]
    jX, jE = jnp.asarray(Xp), jnp.asarray(Ep)
    for got, pallas, oracle in (
            (got_a,
             plap_apply_pallas(*args, jX, n_row_blocks=n_rb, block_size=32,
                               p=p, eps=eps, interpret=True),
             plap_apply_ref(*args, jX, n_rb, 32, p, eps)),
            (got_h,
             plap_hvp_pallas(*args, jX, jE, n_row_blocks=n_rb,
                             block_size=32, p=p, eps=eps, interpret=True),
             plap_hvp_edge_ref(*args, jX, jE, n_rb, 32, p, eps))):
        np.testing.assert_allclose(got, np.asarray(pallas)[:ref.n_rows],
                                   **BSR_TOL[dtype])
        np.testing.assert_allclose(got, np.asarray(oracle)[:ref.n_rows],
                                   **BSR_TOL[dtype])
