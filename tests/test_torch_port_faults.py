"""The port's repairs of three faults against the reference, on the CPU.

  * BSR tiles above the kernels' limit: the two BSR backends decline a
    matrix whose tiles live on CUDA at block_size > 128, so ``auto`` falls
    through to ``coo`` and a named BSR backend raises
    BackendUnavailableError; CPU tiles keep their plain versions.  The
    decision reads the tiles' device only, so a stand-in for CUDA tiles
    tests it without a card.
  * kmeans at any k: the launch plan splits the restarts into groups that
    fit the narrow kernel's shared memory and routes d > 16 or kc > 128 to
    one launch of the tiled variant; the plain assignment at stage 3's shapes for
    k = 48 (fp64) and k = 70 (fp32) against the reference's
    ``core/kmeans.py::lloyd`` with the same injected C0.
  * fixed-order float sums: the COO backend's segmented sum and
    ``row_sums`` add in entry order; the segment pointers the CUDA kernel
    walks (a matrix's ``row_ptr`` or ``csr_pointers`` for sorted ids,
    ``segment_pointers`` for any ids) give each segment its entries in
    their original order, and summing them in that order equals
    ``index_add_`` bit for bit (0 ulps: both add sequentially from 0 in
    entry order); ``row_sums`` against the reference's degree vector.

Tolerances: the degree vector and the COO products to 1e-12 in fp64 and
2 ulps of the largest row sum in fp32 (the reference's XLA scatter-add
may add in another order); kmeans inertia to 1e-10 (fp64) / 1e-4 (fp32)
relative and centroids to 1e-8 / 1e-4, labels equal."""
import importlib
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the reference-only CI has no torch

import jax.numpy as jnp
from repro.core import kmeans as REF_KM
from repro.grblas import Descriptor as RefDesc
from repro.grblas import SparseMatrix as RefMatrix
from repro.grblas import mxm as ref_mxm

from repro_torch import convert
from repro_torch.core import kmeans as KM
from repro_torch.grblas import (BackendUnavailableError, Descriptor, mxm,
                                plap_edge_semiring, plap_hvp_edge_semiring,
                                reals_ring)
from repro_torch.grblas import backends as BE
from repro_torch.kernels import segment_sum as KS

KK = importlib.import_module(
    "repro_torch.kernels.kmeans_assign.kmeans_assign")

torch.set_num_threads(1)


def _graph(n=300, seed=0, weighted=True):
    """Degree ~6 plus a hub, non-integer weights."""
    rng = np.random.default_rng(seed)
    r = rng.integers(0, n, 3 * n)
    c = rng.integers(0, n, 3 * n)
    hub_c = rng.integers(1, n, 60)
    rows = np.concatenate([r, c, np.zeros(60, int), hub_c])
    cols = np.concatenate([c, r, hub_c, np.zeros(60, int)])
    keep = rows != cols
    key = rows[keep] * n + cols[keep]
    _, idx = np.unique(key, return_index=True)
    rows, cols = rows[keep][idx], cols[keep][idx]
    vals = rng.uniform(0.1, 3.0, rows.size) if weighted else np.ones(rows.size)
    return (rows, cols, vals), (n, n)


# ------------------------------------------------ fault 1: BSR tile limit

@pytest.mark.parametrize("block_size,device,fits", [
    (128, "cuda", True), (129, "cuda", False), (256, "cuda", False),
    (32, "cuda", True), (256, "cpu", True), (512, "cpu", True),
    (256, "meta", True)])
def test_bsr_tiles_fit_decides_by_the_tiles_device(block_size, device, fits):
    assert BE.bsr_tiles_fit(block_size, torch.device(device)) is fits


def _cuda_tiles(W):
    """W with its BSR tiles standing in for tiles on the card: the
    predicates read only their device."""
    W.bsr_blocks = types.SimpleNamespace(device=torch.device("cuda"),
                                         shape=W.bsr_blocks.shape)
    return W


@pytest.mark.parametrize("block_size,on_card", [(256, True), (128, True),
                                                (256, False)])
def test_bsr_backends_decline_cuda_tiles_above_128(block_size, on_card):
    coo, shape = _graph()
    W = convert.sparse_matrix(coo, shape, device="cpu", dtype=np.float32,
                              build_ell=False, build_sellcs=False,
                              build_bsr=True, block_size=block_size)
    if on_card:
        W = _cuda_tiles(W)
    # can_execute probes with meta tensors: the multivector's device does
    # not decide
    X = torch.empty((shape[0], 4), device="meta")
    apply_ring = plap_edge_semiring(1.5, 1e-8)
    hvp_ring = plap_hvp_edge_semiring(1.5, 1e-8)
    expect = not (on_card and block_size > 128)
    reals = BE.available_backends(W, X, reals_ring, Descriptor())
    edge = BE.available_backends(W, X, apply_ring, Descriptor())
    pair = BE.available_backends(W, (X, X), hvp_ring, Descriptor())
    assert ("bsr_pallas" in reals) is expect
    assert ("edge_pallas" in edge) is expect
    assert ("edge_pallas" in pair) is expect
    # auto falls through to coo where the BSR backends decline
    want = "bsr_pallas" if expect else "coo"
    assert BE.select_backend(W, X, reals_ring, Descriptor()).name == want
    want = "edge_pallas" if expect else "coo"
    assert BE.select_backend(W, X, apply_ring, Descriptor()).name == want
    for name, ring, Z in (("bsr_pallas", reals_ring, X),
                          ("edge_pallas", apply_ring, X),
                          ("edge_pallas", hvp_ring, (X, X))):
        desc = Descriptor(backend=name)
        assert BE.can_execute(W, Z, ring, desc) is expect
        if not expect:
            with pytest.raises(BackendUnavailableError):
                BE.select_backend(W, Z, ring, desc)


def test_auto_on_cpu_tiles_above_128_keeps_the_bsr_plain_versions():
    """CPU tiles have no limit: auto still runs bsr_pallas / edge_pallas
    at block_size 256, and they equal the reference's coo product."""
    coo, shape = _graph()
    W = convert.sparse_matrix(coo, shape, device="cpu", dtype=np.float64,
                              build_ell=False, build_sellcs=False,
                              build_bsr=True, block_size=256)
    ref = RefMatrix.from_coo(*coo, shape, dtype=jnp.float64)
    X = np.random.default_rng(1).standard_normal((shape[0], 4))
    got = mxm(W, convert.tensor(X, device="cpu"))
    want = ref_mxm(ref, jnp.asarray(X), desc=RefDesc(backend="coo"))
    np.testing.assert_allclose(convert.to_numpy(got), np.asarray(want),
                               rtol=1e-12, atol=1e-12)
    assert BE.select_backend(W, convert.tensor(X, device="cpu"), reals_ring,
                             Descriptor()).name == "bsr_pallas"


# --------------------------------------------------- fault 2: kmeans at k

@pytest.mark.parametrize("R,kc,d,itemsize,want", [
    # the main path: k = 4, 8 restarts, one narrow launch; kmeans++ at k = 4
    (8, 4, 4, 4, [("narrow", 0, 8)]),
    (8, 3, 4, 4, [("narrow", 0, 8)]),
    # stage 3 at k = 16 fp64 is the widest narrow row; k = 17 is tiled
    (8, 16, 16, 8, [("narrow", 0, 8)]),
    (8, 17, 17, 8, [("tiled", 0, 8)]),
    (8, 1, 17, 4, [("tiled", 0, 8)]),
    # stage 3 at k = 48 fp64 and k = 70 fp32: one tiled launch each
    (8, 48, 48, 8, [("tiled", 0, 8)]),
    (8, 70, 70, 4, [("tiled", 0, 8)]),
    # kmeans++ at k = 70: kc grows from 1 while d = 70
    (8, 1, 70, 4, [("tiled", 0, 8)]),
    # more than 128 centroids of a narrow width
    (8, 129, 4, 4, [("tiled", 0, 8)]),
    (1, 128, 16, 8, [("narrow", 0, 1)]),
    # many restarts of a narrow shape: the fewest groups that fit
    (64, 128, 16, 8, [("narrow", r, min(64, r + 13))
                      for r in range(0, 64, 13)]),
    (200, 128, 4, 4, [("narrow", 0, 90), ("narrow", 90, 180),
                      ("narrow", 180, 200)]),
    # ... and of a tiled one: still one launch
    (500, 48, 48, 8, [("tiled", 0, 500)]),
])
def test_kmeans_launch_plan(R, kc, d, itemsize, want):
    plan = KK.launch_plan(R, kc, d, itemsize)
    assert plan == want
    for variant, r0, r1 in plan:
        if variant == "narrow":
            assert KK.narrow_smem(r1 - r0, kc, d, itemsize) <= KK.SMEM_LIMIT
    # every set in exactly one launch, in order
    assert [r for _, r0, r1 in plan for r in range(r0, r1)] == list(range(R))


def test_kmeans_launch_plan_groups_are_maximal():
    for itemsize in (4, 8):
        for d in (1, 4, 5, 16):
            for kc in (1, 4, 64, 128):
                plan = KK.launch_plan(300, kc, d, itemsize)
                for _, r0, r1 in plan[:-1]:
                    assert KK.narrow_smem(r1 - r0 + 1, kc, d, itemsize) > \
                        KK.SMEM_LIMIT


@pytest.mark.parametrize("itemsize", [4, 8])
def test_kmeans_launch_plan_routes_at_the_boundaries(itemsize):
    """The narrow variant up to d = 16 and kc = 128, the tiled one past
    either."""
    for kc in (1, 2, 64, 128):
        assert KK.launch_plan(8, kc, 16, itemsize)[0][0] == "narrow"
        assert KK.launch_plan(8, kc, 17, itemsize) == [("tiled", 0, 8)]
    for d in (1, 4, 5, 16):
        assert KK.launch_plan(8, 128, d, itemsize)[0][0] == "narrow"
        assert KK.launch_plan(8, 129, d, itemsize) == [("tiled", 0, 8)]
    assert KK.narrow_width(4) == 4 and KK.narrow_width(5) == 16


def _stage3_input(n, k, dtype, seed):
    """Row-normalized points around k directions, as stage 3 gets them."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((k, k))
    X = centers[rng.integers(0, k, n)] + 0.3 * rng.standard_normal((n, k))
    X /= np.linalg.norm(X, axis=1, keepdims=True)
    C0 = X[rng.choice(n, size=k, replace=False)]
    return X.astype(dtype), C0.astype(dtype)


@pytest.mark.parametrize("k,dtype,tol,ctol", [(48, np.float64, 1e-10, 1e-8),
                                              (70, np.float32, 1e-4, 1e-4)])
def test_plain_assignment_at_large_k_matches_reference_lloyd(k, dtype, tol,
                                                             ctol):
    X, C0 = _stage3_input(1500, k, dtype, seed=k)
    labels, C, inertia = KM.lloyd(convert.tensor(X, device="cpu"),
                                  convert.tensor(C0, device="cpu"), iters=8)
    r_labels, r_C, r_inertia = REF_KM.lloyd(jnp.asarray(X), jnp.asarray(C0),
                                            iters=8)
    np.testing.assert_array_equal(convert.to_numpy(labels),
                                  np.asarray(r_labels))
    np.testing.assert_allclose(convert.to_numpy(C), np.asarray(r_C),
                               rtol=ctol, atol=ctol)
    np.testing.assert_allclose(float(inertia), float(r_inertia), rtol=tol)


@pytest.mark.parametrize("k,dtype", [(48, np.float64), (70, np.float32)])
def test_batched_restarts_at_large_k_match_one_by_one(k, dtype):
    """Eight restarts in one batch, as stage 3 runs them, equal eight
    separate reference runs."""
    X, _ = _stage3_input(600, k, dtype, seed=3)
    rng = np.random.default_rng(4)
    C0 = np.stack([X[rng.choice(600, size=k, replace=False)]
                   for _ in range(8)])
    labels, _, inertia = KM.lloyd(convert.tensor(X, device="cpu"),
                                  convert.tensor(C0, device="cpu"), iters=3)
    for r in range(8):
        r_labels, _, r_inertia = REF_KM.lloyd(jnp.asarray(X),
                                              jnp.asarray(C0[r]), iters=3)
        np.testing.assert_array_equal(convert.to_numpy(labels[r]),
                                      np.asarray(r_labels))
        np.testing.assert_allclose(float(inertia[r]), float(r_inertia),
                                   rtol=1e-4 if dtype == np.float32 else 1e-10)


# ---------------------------------------------- fault 3: fixed-order sums

def _walk(values, ptr, order):
    """The CUDA kernel's order, in numpy: segment s adds its entries
    order[ptr[s]:ptr[s+1]] one after the other from 0."""
    values = np.asarray(values)
    out = np.zeros((len(ptr) - 1,) + values.shape[1:], values.dtype)
    idx = np.arange(len(values)) if order is None else np.asarray(order)
    for s in range(len(ptr) - 1):
        acc = np.zeros(values.shape[1:], values.dtype)
        for e in idx[ptr[s]:ptr[s + 1]]:
            acc = (acc + values[e]).astype(values.dtype)
        out[s] = acc
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("sorted_ids", [True, False])
@pytest.mark.parametrize("m", [None, 1, 4])
def test_segment_order_sum_equals_index_add(dtype, sorted_ids, m):
    rng = np.random.default_rng(5)
    n_seg, nnz = 37, 400
    ids = rng.integers(0, n_seg - 2, nnz)          # the last two stay empty
    if sorted_ids:
        ids = np.sort(ids)
    shape = (nnz,) if m is None else (nnz, m)
    # magnitudes over 8 decades, so the order of the adds shows in the bits
    vals = rng.standard_normal(shape) * 10.0 ** rng.uniform(-4, 4, shape)
    V = torch.as_tensor(vals, dtype=dtype)
    I = torch.as_tensor(ids)
    if sorted_ids:
        ptr, order = KS.csr_pointers(I, n_seg), None
        # sorting sorted ids changes nothing
        p2, o2 = KS.segment_pointers(I, n_seg)
        assert torch.equal(p2, ptr) and torch.equal(o2, torch.arange(nnz))
    else:
        ptr, order = KS.segment_pointers(I, n_seg)
    assert ptr.dtype == torch.int64 and ptr.shape == (n_seg + 1,)
    if order is not None:
        # stable: within a segment, the entries keep their original order
        o = convert.to_numpy(order)
        assert np.all(np.diff(ids[o]) >= 0)
        same = ids[o][1:] == ids[o][:-1]
        assert np.all(o[1:][same] > o[:-1][same])
    walked = _walk(convert.to_numpy(V), convert.to_numpy(ptr),
                   None if order is None else convert.to_numpy(order))
    want = torch.zeros((n_seg,) + shape[1:], dtype=dtype).index_add_(0, I, V)
    # 0 ulps: the same adds in the same order
    np.testing.assert_array_equal(walked, convert.to_numpy(want))
    got = KS.segment_sum(V, I, n_seg, ptr if sorted_ids else None)
    np.testing.assert_array_equal(convert.to_numpy(got), walked)


def test_segment_sum_takes_integer_sums_and_rejects_bad_operands():
    I = torch.tensor([0, 0, 2, 1, 2])
    got = KS.segment_sum(torch.tensor([1, 2, 3, 4, 5]), I, 4)
    assert got.tolist() == [3, 4, 8, 0]
    with pytest.raises(ValueError):
        KS.segment_sum(torch.ones(4), I, 3)
    with pytest.raises(ValueError, match="device"):
        KS.segment_sum(torch.ones(5, device="meta"), I.to("meta"), 3)
    with pytest.raises(ValueError, match="ptr"):
        KS.segment_sum(torch.ones(5), I, 3, torch.zeros(3, dtype=torch.long))
    with pytest.raises(ValueError, match="ptr"):
        KS.segment_sum(torch.ones(5), I, 3, torch.zeros(4, dtype=torch.int32))


def test_coo_takes_a_three_argument_segment_reducer():
    """A ring whose segment reducer is registered with the three arguments
    of ``register_ring_fast_paths``' contract runs on ``coo``."""
    from repro_torch.grblas import semiring as SR

    calls = []

    def seg(values, ids, n):
        calls.append(n)
        return KS.segment_sum_plain(values, ids, n)

    SR.register_ring_fast_paths("test_sum3", segment=seg)
    try:
        ring = SR.Semiring(add=reals_ring.add, mul=reals_ring.mul, zero=0.0,
                           one=1.0, name="test_sum3")
        coo, shape = _graph(seed=4)
        W = convert.sparse_matrix(coo, shape, device="cpu", dtype=np.float64)
        X = convert.tensor(np.random.default_rng(1).standard_normal(
            (shape[0], 3)), device="cpu")
        got = mxm(W, X, ring, desc=Descriptor(backend="coo"))
        want = mxm(W, X, desc=Descriptor(backend="coo"))
    finally:
        SR._FAST_PATHS.pop("test_sum3")
    assert calls == [shape[0]]
    np.testing.assert_array_equal(convert.to_numpy(got),
                                  convert.to_numpy(want))


def test_row_ptr_built_by_from_coo_and_kept_by_with_vals():
    coo, shape = _graph(seed=4)
    W = convert.sparse_matrix(coo, shape, device="cpu", dtype=np.float64)
    assert W.row_ptr.dtype == torch.int64
    assert torch.equal(W.row_ptr, KS.csr_pointers(W.rows, W.n_rows))
    assert int(W.row_ptr[-1]) == W.nnz
    assert W.with_vals(W.vals * 2).row_ptr is W.row_ptr


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_row_sums_match_reference_degree(dtype):
    coo, shape = _graph(seed=2)
    W = convert.sparse_matrix(coo, shape, device="cpu", dtype=dtype)
    ref = RefMatrix.from_coo(*coo, shape, dtype=jnp.asarray(
        np.zeros(1, dtype)).dtype)
    got = convert.to_numpy(W.row_sums())
    want = np.asarray(ref.row_sums())
    atol = 2 * np.finfo(dtype).eps * float(np.abs(want).max()) \
        if dtype == np.float32 else 1e-12
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)
    # the fixed order: each row added in (row, col) order from 0
    rows, cols, vals = W.host_coo()
    order = np.lexsort((cols, rows))
    assert np.all(order == np.arange(len(order)))
    walked = _walk(vals, np.searchsorted(rows, np.arange(shape[0] + 1)), None)
    np.testing.assert_array_equal(got, walked)


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("multivalue", [False, True])
def test_coo_reals_sum_matches_reference(transpose, multivalue):
    coo, shape = _graph(seed=3)
    W = convert.sparse_matrix(coo, shape, device="cpu", dtype=np.float64)
    ref = RefMatrix.from_coo(*coo, shape, dtype=jnp.float64)
    rng = np.random.default_rng(6)
    X = rng.standard_normal((shape[0], 4))
    if multivalue:
        mv = rng.uniform(0.5, 2.0, (W.nnz, 4))
        W = W.with_vals(convert.tensor(mv, device="cpu"))
        ref = ref.with_vals(jnp.asarray(mv))
    got = mxm(W, convert.tensor(X, device="cpu"),
              desc=Descriptor(backend="coo", transpose=transpose))
    want = ref_mxm(ref, jnp.asarray(X),
                   desc=RefDesc(backend="coo", transpose=transpose))
    np.testing.assert_allclose(convert.to_numpy(got), np.asarray(want),
                               rtol=1e-12, atol=1e-12)
    # and in the kernel's order: the entries of each output grouped by
    # the row pointers, or by segment_pointers for the columns, summed one
    # after the other
    rows, cols, vals = W.host_coo()
    out_idx, src_idx = (cols, rows) if transpose else (rows, cols)
    v = vals if vals.ndim == 2 else vals[:, None]
    contrib = v * X[src_idx]
    ptr, order = (KS.segment_pointers(torch.as_tensor(out_idx), shape[0])
                  if transpose else (W.row_ptr, None))
    walked = _walk(contrib, convert.to_numpy(ptr),
                   None if order is None else convert.to_numpy(order))
    np.testing.assert_array_equal(convert.to_numpy(got), walked)
