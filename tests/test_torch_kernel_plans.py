"""The pure-Python plans of the port's two redesigned kernels, and their
plain versions at the shapes those plans serve, on the CPU.

  * flash attention: which kernel serves (dtype, head dim, key length),
    how the wgmma kernel pairs the q heads of a GQA group in one block,
    and its grid;
  * BSR SpMM: the column windows and register-tile widths of a launch;
  * the plain versions at the head dims and group sizes the wgmma kernel
    serves, and at the widths the main path gives the SpMM (4, 8, 24),
    against the reference's oracles and its Pallas kernels in interpret
    mode.

Tolerances: fp32 flash to 1e-5 (the bound of
tests/test_torch_dense_kernels.py); BSR fp32 to rtol 2e-4 / atol 2e-5 and
fp64 to 1e-12 (the bounds of tests/test_torch_bsr.py)."""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the reference-only CI has no torch

import jax.numpy as jnp
from repro.kernels.bsr_spmm import bsr_spmm_pallas, bsr_spmm_ref
from repro.kernels.flash_attention.flash_attention import \
    flash_attention_pallas
from repro.kernels.flash_attention.ref import attention_ref as ref_attention

from repro_torch import convert
from repro_torch.kernels.flash_attention import flash_attention

torch.set_num_threads(1)

KF = importlib.import_module(
    "repro_torch.kernels.flash_attention.flash_attention")
KB = importlib.import_module("repro_torch.kernels.bsr_spmm.bsr_spmm")

BSR_TOL = {np.float32: dict(rtol=2e-4, atol=2e-5),
           np.float64: dict(rtol=1e-12, atol=1e-12)}


# ------------------------------------------------------- flash: routing

@pytest.mark.parametrize("D", [64, 128, 256])
def test_flash_bf16_at_wgmma_head_dims_takes_wgmma(D):
    assert KF.kernel_variant(torch.bfloat16, D) == "wgmma"
    assert KF.kernel_variant(torch.float32, D) == "f32"
    # no keys: the mma kernel writes the zero rows
    assert KF.kernel_variant(torch.bfloat16, D, Sk=0) == "mma"


@pytest.mark.parametrize("D", [8, 16, 32, 96, 136, 192, 248])
def test_flash_bf16_at_other_head_dims_takes_mma(D):
    assert KF.kernel_variant(torch.bfloat16, D) == "mma"
    assert KF.kernel_variant(torch.float32, D) == "f32"


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
    (1, 2, 2, 129, (2, 3)),         # group 1
])
def test_flash_wgmma_grid(B, Hq, Hkv, Sq, grid):
    assert KF.wgmma_grid(B, Hq, Hkv, Sq) == grid


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
