"""The SELL-C-σ kernels' launch plan, and their plain versions at the
shapes the main path gives them, on the CPU.

  * the plan: every wrapper (``sellcs_spmm``, ``sellcs_plap_apply``,
    ``sellcs_plap_hvp``) runs the row kernel at a compiled width (k = 4,
    8, 16, 24, operands on 16-byte boundaries; k = 1 at any alignment)
    or its generic variant on chunks of 4 columns; the threads a row
    takes; the grid; the block order;
  * the plain versions at LOBPCG's widths (k = 8 and 24) and with the
    graphblas HVP's (nnz, 4) multivalues, run by run, against the
    reference's Pallas kernels in interpret mode and its ref.py oracles,
    and through the wrappers against the reference's ``mxm``, in fp32
    and fp64, at slice heights 8 and 32.

Tolerances: fp64 to 1e-12; fp32 to rtol 2e-4 / atol 2e-5, the bounds of
tests/test_torch_kernels.py (sums run in another order)."""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the reference-only CI has no torch

import jax.numpy as jnp
from repro.grblas import Descriptor as RefDesc
from repro.grblas import SparseMatrix as RefMatrix
from repro.grblas import mxm as ref_mxm
from repro.grblas.semiring import plap_edge_semiring as ref_plap
from repro.kernels import sellcs_spmm as RK

from repro_torch import convert
from repro_torch.grblas import Descriptor, mxm, plap_edge_semiring

torch.set_num_threads(1)

K = importlib.import_module("repro_torch.kernels.sellcs_spmm.sellcs_spmm")

TOL = {np.float32: dict(rtol=2e-4, atol=2e-5),
       np.float64: dict(rtol=1e-12, atol=1e-12)}


# --------------------------------------------------------------- the plan

@pytest.mark.parametrize("dtype,k,lanes", [
    (torch.float32, 4, 1), (torch.float32, 8, 1),
    (torch.float32, 16, 2), (torch.float32, 24, 3),
    (torch.float64, 4, 1), (torch.float64, 8, 2),
    (torch.float64, 16, 4), (torch.float64, 24, 6)])
def test_main_path_widths_take_the_row_kernel(dtype, k, lanes):
    """One thread per 32 bytes of a row; the reals ring visits the blocks
    in order."""
    n = 1 << 20
    grid = (n * lanes // 256, 1)
    assert K.launch_plan("sellcs_spmm", n, k, dtype) == K.Plan(
        "row", k, lanes, grid, 256, True)
    assert K.launch_plan("sellcs_plap_apply", n, k, dtype) == K.Plan(
        "row", k, lanes, grid, 256, False)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("k", [2, 3, 5, 7, 12, 33, 120])
def test_other_widths_take_the_generic_variant(dtype, k):
    plan = K.launch_plan("sellcs_spmm", 1000, k, dtype)
    assert plan == K.Plan("row_generic", 4, 1, (4, -(-k // 4)), 256, True)
    # every column in exactly one chunk of 4
    chunks = [list(range(4 * y, min(k, 4 * y + 4)))
              for y in range(plan.grid[1])]
    assert sum(chunks, []) == list(range(k))


@pytest.mark.parametrize("k", [4, 8, 16, 24])
def test_misaligned_operands_take_the_generic_variant(k):
    plan = K.launch_plan("sellcs_plap_apply", 300, k, torch.float32,
                         aligned=False)
    assert plan.variant == "row_generic" and plan.grid == (2, -(-k // 4))
    assert plan.lanes == 1 and not plan.ordered


@pytest.mark.parametrize("dtype,k,lanes", [
    (torch.float32, 4, 1), (torch.float32, 8, 1),
    (torch.float32, 16, 2), (torch.float32, 24, 3),
    (torch.float64, 4, 1), (torch.float64, 8, 2),
    (torch.float64, 16, 4), (torch.float64, 24, 6)])
def test_hvp_takes_the_row_kernel_at_compiled_widths(dtype, k, lanes):
    """The HVP runs the row kernel like the apply: one thread per 32 bytes
    of a row, blocks in launch order."""
    n = 1 << 20
    assert K.launch_plan("sellcs_plap_hvp", n, k, dtype) == K.Plan(
        "row", k, lanes, (n * lanes // 256, 1), 256, False)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("k", [5, 7, 12, 33])
def test_hvp_other_widths_take_the_generic_variant(dtype, k):
    assert K.launch_plan("sellcs_plap_hvp", 1000, k, dtype) == K.Plan(
        "row_generic", 4, 1, (4, -(-k // 4)), 256, False)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("k", [4, 8, 16, 24])
def test_hvp_misaligned_operands_take_the_generic_variant(dtype, k):
    plan = K.launch_plan("sellcs_plap_hvp", 300, k, dtype, aligned=False)
    assert plan == K.Plan("row_generic", 4, 1, (2, -(-k // 4)), 256, False)


@pytest.mark.parametrize("row_bytes,want", [
    (4, 1), (16, 1), (32, 1), (64, 2), (96, 3), (128, 4), (192, 6)])
def test_lanes_one_per_32_bytes(row_bytes, want):
    assert K.lanes(row_bytes) == want


def test_plan_rejects_unknown_kernels():
    with pytest.raises(ValueError):
        K.launch_plan("sellcs_spgemm", 10, 4, torch.float32)


@pytest.mark.parametrize("k,dtype", [(4, torch.float32), (24, torch.float32),
                                     (24, torch.float64), (5, torch.float32)])
def test_block_order_sorts_blocks_by_their_first_rows_original_id(k, dtype):
    """A permutation of the blocks, by the original id of each block's
    first row; cached on the layout and shared with a with_vals copy."""
    coo, shape = _graph(n=2000)
    W = convert.sparse_matrix(coo, shape, device="cpu", dtype=np.float32,
                              build_sellcs=True, sell_c=32)
    L = W.sell_kernel
    plan = K.launch_plan("sellcs_spmm", W.n_rows, k, dtype)
    order = K.block_order(L, plan)
    assert order.dtype == torch.int32
    assert sorted(order.tolist()) == list(range(plan.grid[0]))
    first = [min(b * 256 // plan.lanes, W.n_rows - 1)
             for b in order.tolist()]
    keys = convert.to_numpy(L.perm)[first]
    assert np.all(np.diff(keys) >= 0)
    assert K.block_order(L, plan) is order
    Wh = W.with_vals(torch.ones(W.nnz))
    assert K.block_order(Wh.sell_kernel, plan) is order


# --------------------------------------- the plain versions at those shapes

def _graph(seed=0, n=200):
    """Background degree ~6 plus a hub, so runs of several widths."""
    rng = np.random.default_rng(seed)
    r = rng.integers(0, n, 3 * n)
    c = rng.integers(0, n, 3 * n)
    hub_c = rng.integers(1, n, 50)
    rows = np.concatenate([r, c, np.zeros(50, int), hub_c])
    cols = np.concatenate([c, r, hub_c, np.zeros(50, int)])
    keep = rows != cols
    key = rows[keep] * n + cols[keep]
    _, idx = np.unique(key, return_index=True)
    rows, cols = rows[keep][idx], cols[keep][idx]
    return (rows, cols, rng.uniform(0.5, 1.5, rows.size)), (n, n)


def _runs(dtype, k, C):
    coo, shape = _graph()
    ref = RefMatrix.from_coo(*coo, shape, dtype=dtype, build_sellcs=True,
                             sell_c=C)
    Xp = np.random.default_rng(k).standard_normal(
        (ref.sell_n_pad, k)).astype(dtype)
    for r, (cols, vals) in enumerate(zip(ref.sell_cols, ref.sell_vals)):
        yield ref.sell_row0[r], np.asarray(cols), np.asarray(vals), Xp


def _t(a):
    return convert.tensor(a, device="cpu")


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("k", [8, 24])
@pytest.mark.parametrize("C", [8, 32])
def test_reals_plain_at_lobpcg_widths_matches_pallas(dtype, k, C):
    for row0, cols, vals, Xp in _runs(dtype, k, C):
        got = convert.to_numpy(K.sellcs_spmm_ref(_t(cols), _t(vals), _t(Xp)))
        pallas = RK.sellcs_spmm_pallas(jnp.asarray(cols), jnp.asarray(vals),
                                       jnp.asarray(Xp), C, slice0=row0 // C,
                                       interpret=True)
        np.testing.assert_allclose(got, np.asarray(pallas), **TOL[dtype])


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("k", [4, 8, 24])
def test_apply_plain_at_main_path_widths_matches_pallas(dtype, k):
    for row0, cols, vals, Xp in _runs(dtype, k, 32):
        got = convert.to_numpy(K.sellcs_plap_apply_ref(
            _t(cols), _t(vals), _t(Xp), row0, 1.2, 1e-8))
        pallas = RK.sellcs_plap_apply_pallas(
            jnp.asarray(cols), jnp.asarray(vals), jnp.asarray(Xp), 32,
            slice0=row0 // 32, p=1.2, eps=1e-8, interpret=True)
        np.testing.assert_allclose(got, np.asarray(pallas), **TOL[dtype])


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("C", [8, 32])
def test_multivalue_plain_at_k4_matches_ref(dtype, C):
    rng = np.random.default_rng(3)
    for _, cols, vals, Xp in _runs(dtype, 4, C):
        mv = (vals[..., None] * rng.uniform(0.5, 2.0, vals.shape + (4,))
              ).astype(dtype)
        got = convert.to_numpy(K.sellcs_spmm_ref(_t(cols), _t(mv), _t(Xp)))
        want = RK.sellcs_spmm_ref(jnp.asarray(cols), jnp.asarray(mv),
                                  jnp.asarray(Xp))
        np.testing.assert_allclose(got, np.asarray(want), **TOL[dtype])


def _pair(dtype, C):
    coo, shape = _graph(seed=1)
    layout = dict(build_sellcs=True, sell_c=C)
    ref = RefMatrix.from_coo(*coo, shape, dtype=dtype, **layout)
    port = convert.sparse_matrix(coo, shape, device="cpu", dtype=dtype,
                                 **layout)
    return ref, port


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("C", [8, 32])
@pytest.mark.parametrize("case", ["scalar_k8", "scalar_k24", "multivalue_k4",
                                  "apply_k4"])
def test_wrappers_plain_path_matches_reference_mxm(dtype, C, case):
    """The wrappers on CPU tensors (the plain versions, un-permuted)
    against the reference's api.mxm on its coo backend."""
    ref, port = _pair(dtype, C)
    k = {"scalar_k8": 8, "scalar_k24": 24}.get(case, 4)
    rng = np.random.default_rng(k)
    X = rng.standard_normal((port.n_rows, k)).astype(dtype)
    if case == "multivalue_k4":
        mv = rng.uniform(0.5, 2.0, (port.nnz, 4)).astype(dtype)
        port = port.with_vals(_t(mv))
        ref = ref.with_vals(jnp.asarray(mv))
    if case == "apply_k4":
        got = K.sellcs_plap_apply(port, _t(X), 1.2, 1e-8)
        want = ref_mxm(ref, jnp.asarray(X), ref_plap(1.2, 1e-8),
                       desc=RefDesc(backend="coo"))
        via_api = mxm(port, _t(X), plap_edge_semiring(1.2, 1e-8),
                      desc=Descriptor(backend="sellcs"))
    else:
        got = K.sellcs_spmm(port, _t(X))
        want = ref_mxm(ref, jnp.asarray(X), desc=RefDesc(backend="coo"))
        via_api = mxm(port, _t(X), desc=Descriptor(backend="sellcs"))
    np.testing.assert_allclose(convert.to_numpy(got), np.asarray(want),
                               **TOL[dtype])
    np.testing.assert_array_equal(convert.to_numpy(via_api),
                                  convert.to_numpy(got))
