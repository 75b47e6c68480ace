"""Port layouts equal the reference's, array for array: ELL and SELL-C-σ
(permutation, width runs, scatter maps), with_vals multivalues, and the
slot-major kernel copy holds the same matrix."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the reference-only CI has no torch

from repro import graphs as ref_graphs
from repro.grblas import SparseMatrix as RefMatrix
from repro_torch import convert

# Small CPU problems: intra-op threads only contend with the other test
# workers.
torch.set_num_threads(1)


def _skewed_sbm(seed=0):
    """Sparse SBM plus a few hub rows: ELL fill far above SELL-C-σ's."""
    W, _ = ref_graphs.sbm_graph_sparse([150, 150, 100], deg_in=6, deg_out=1,
                                       seed=seed, build_sellcs=False)
    rows, cols, vals = W.host_coo()
    rng = np.random.default_rng(seed)
    hubs = np.repeat(np.arange(3), 80)
    nbrs = rng.integers(3, W.n_rows, hubs.size)
    r = np.concatenate([rows, hubs, nbrs])
    c = np.concatenate([cols, nbrs, hubs])
    v = np.concatenate([vals, np.full(2 * hubs.size, 0.5)])
    key = r * W.n_rows + c
    _, idx = np.unique(key, return_index=True)
    return (r[idx], c[idx], v[idx]), (W.n_rows, W.n_rows)


def _delaunay():
    W, _ = ref_graphs.delaunay_graph(9, seed=3, build_sellcs=False)
    return W.host_coo(), (W.n_rows, W.n_cols)


GRAPHS = {"skewed_sbm": _skewed_sbm, "delaunay": _delaunay}


def _pair(graph, dtype, **layout):
    coo, shape = GRAPHS[graph]()
    ref = RefMatrix.from_coo(*coo, shape, dtype=dtype, **layout)
    port = convert.sparse_matrix(coo, shape, device="cpu", dtype=dtype,
                                 **layout)
    return ref, port


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), convert.to_numpy(b))


@pytest.mark.parametrize("graph", sorted(GRAPHS))
@pytest.mark.parametrize("C", [8, 32])
@pytest.mark.parametrize("sigma", [None, 64])
def test_sellcs_and_ell_arrays_equal_reference(graph, C, sigma):
    ref, port = _pair(graph, np.float64, build_ell=True, build_sellcs=True,
                      sell_c=C, sell_sigma=sigma)
    for name in ("rows", "cols", "vals", "ell_cols", "ell_vals", "sell_perm",
                 "sell_inv"):
        _eq(getattr(ref, name), getattr(port, name))
    assert (port.sell_c, port.sell_sigma, port.sell_n_pad, port.sell_row0) \
        == (ref.sell_c, ref.sell_sigma, ref.sell_n_pad, ref.sell_row0)
    for name in ("sell_cols", "sell_vals", "sell_scatter"):
        assert len(getattr(ref, name)) == len(getattr(port, name))
        for a, b in zip(getattr(ref, name), getattr(port, name)):
            _eq(a, b)
    assert port.ell_fill_ratio() == ref.ell_fill_ratio()
    assert port.sellcs_fill_ratio() == ref.sellcs_fill_ratio()


@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_auto_build_policy_matches_reference(graph):
    ref, port = _pair(graph, np.float32)
    assert (ref.ell_cols is None) == (port.ell_cols is None)
    assert (ref.sell_cols is None) == (port.sell_cols is None)
    if port.ell_cols is not None:
        _eq(ref.ell_vals, port.ell_vals)
    if port.sell_cols is not None:
        for a, b in zip(ref.sell_cols, port.sell_cols):
            _eq(a, b)


@pytest.mark.parametrize("graph", sorted(GRAPHS))
@pytest.mark.parametrize("k", [1, 3])
def test_with_vals_multivalues_equal_reference(graph, k):
    import jax.numpy as jnp

    ref, port = _pair(graph, np.float64, build_sellcs=True, sell_c=8)
    mv = np.random.default_rng(k).standard_normal((ref.nnz, k))
    mv = mv[:, 0] if k == 1 else mv
    ref_w = ref.with_vals(jnp.asarray(mv))
    port_w = port.with_vals(convert.tensor(mv, device="cpu"))
    assert port_w.ell_cols is None
    assert port_w._sell_vals is None      # gathered only when read
    for a, b in zip(ref_w.sell_vals, port_w.sell_vals):
        _eq(a, b)


@pytest.mark.parametrize("graph", sorted(GRAPHS))
@pytest.mark.parametrize("C,sigma", [(8, None), (32, 64), (5, 7)])
def test_kernel_layout_holds_the_same_matrix(graph, C, sigma):
    """Every slot of the slot-major copy is an entry of W (or a pad with
    value 0 on its own row) and every entry of W is one slot."""
    _, port = _pair(graph, np.float64, build_sellcs=True, sell_c=C,
                    sell_sigma=sigma)
    L = port.sell_kernel
    n = port.n_rows
    slice_ptr, slice_w = L.slice_ptr.long(), L.slice_w.long()
    dense = np.zeros((n, n))
    seen = np.zeros(port.nnz + 1, np.int64)
    for r in range(n):
        s, lane = divmod(r, C)
        slots = slice_ptr[s] + lane + C * torch.arange(int(slice_w[s]))
        orig = int(L.perm[r])
        for slot in slots.tolist():
            col, val = int(L.cols[slot]), float(L.vals[slot])
            seen[int(L.scatter[slot])] += 1
            if int(L.scatter[slot]) == port.nnz:
                assert (col, val) == (orig, 0.0)
            dense[orig, col] += val
    np.testing.assert_array_equal(dense, convert.to_numpy(port.to_dense()))
    assert (seen[:-1] == 1).all()
    assert L.slots == int((slice_w * C).sum())
