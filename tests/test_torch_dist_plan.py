"""The distributed SpMM's host-side plan (``repro_torch.grblas.dist``)
against the reference's ``repro.grblas.dist``, in one process.

Both packages build their partitions from the same host COO, and every
integer must match: the extended-local ELL column ids, the send plan,
the halo width and true halo volume, the mode (with the auto fallback),
the placement permutation, the self-referencing pad rows and the
per-shard SELL-C-σ runs.  The shard launch's plain versions
(``sellcs_shard_*``) are held against the reference's
``sellcs_shard_*_ref`` in both index spaces (halo: extended-local;
gather: the gathered vector, own rows from d*R), on fp64 to 1e-12.
Multi-rank execution is ``tests/test_torch_dist.py``.
"""
import numpy as np
import pytest
import jax.numpy as jnp

torch = pytest.importorskip("torch")  # the reference-only CI has no torch

from repro.graphs import delaunay_graph, sbm_graph
from repro.grblas import SparseMatrix as RefSparseMatrix
from repro.grblas import make_row_partition as ref_make_row_partition
from repro.kernels.sellcs_spmm import ref as ref_kernels

from repro_torch import convert
from repro_torch.grblas import (HALO_FALLBACK_FRAC, BackendUnavailableError,
                                Descriptor, available_backends, device_mesh,
                                init_distributed, make_row_partition, mxm)
from repro_torch.grblas.semiring import plap_edge_semiring
from repro_torch.kernels import sellcs_spmm as K
from repro_torch.obs import metrics, trace

N = 509          # prime: not a multiple of any shard count tested


def _coo(dtype=np.float32):
    """delaunay_graph(9) cut to its first N vertices (host COO)."""
    W, _ = delaunay_graph(9, seed=0)
    r, c, v = (np.asarray(a) for a in W.host_coo())
    keep = (r < N) & (c < N)
    return r[keep], c[keep], v[keep].astype(dtype)


@pytest.fixture(scope="module")
def graph():
    coo = _coo()
    ref = RefSparseMatrix.from_coo(*coo, (N, N), build_ell=True)
    port = convert.sparse_matrix(coo, (N, N), device="cpu", build_ell=True)
    return ref, port


def _assert_same_plan(a, b):
    """Every field of the reference's partition ``a`` equals the port's
    ``b``, integers exactly."""
    assert (b.mode, b.halo_width, b.halo_rows_true, b.n_shards, b.n_rows,
            b.n_cols, b.rows_per_shard) == (
        a.mode, a.halo_width, a.halo_rows_true, a.n_shards, a.n_rows,
        a.n_cols, a.rows_per_shard)
    np.testing.assert_array_equal(b.ell_cols, np.asarray(a.ell_cols))
    np.testing.assert_array_equal(b.ell_vals, np.asarray(a.ell_vals))
    assert (a.send_idx is None) == (b.send_idx is None)
    if a.send_idx is not None:
        np.testing.assert_array_equal(b.send_idx, np.asarray(a.send_idx))
    assert (a.perm is None) == (b.perm is None)
    if a.perm is not None:
        np.testing.assert_array_equal(b.perm, np.asarray(a.perm))
        np.testing.assert_array_equal(b.inv_perm, np.asarray(a.inv_perm))
    for k in (1, 8):
        assert b.wire_bytes(k) == a.wire_bytes(k)
    assert (a.sell is None) == (b.sell is None)
    if a.sell is not None:
        sa, sb = a.sell, b.sell
        assert (sb.sell_c, sb.n_pad_local) == (sa.sell_c, sa.n_pad_local)
        assert len(sb.run_cols) == len(sa.run_cols)
        for x, y in zip(sa.run_cols + sa.run_vals + sa.run_own,
                        sb.run_cols + sb.run_vals + sb.run_own):
            assert y.dtype == np.asarray(x).dtype
            np.testing.assert_array_equal(y, np.asarray(x))
        np.testing.assert_array_equal(sb.inv, np.asarray(sa.inv))


@pytest.mark.parametrize("mode", ["auto", "halo", "gather"])
@pytest.mark.parametrize("placed", [False, True])
@pytest.mark.parametrize("S", [2, 3, 4])
def test_plan_equals_reference(graph, S, placed, mode):
    ref, port = graph
    asg = (np.arange(N) * 7) % 4 if placed else None
    a = ref_make_row_partition(ref, S, asg, mode=mode, sellcs=True, sell_c=8)
    b = make_row_partition(port, S, asg, mode=mode, sellcs=True, sell_c=8)
    _assert_same_plan(a, b)
    # pad rows (n up to a multiple of S) reference themselves
    R = b.rows_per_shard
    pos = np.arange(N, S * R)
    if pos.size and b.mode == "gather":
        cols = b.ell_cols.reshape(S * R, -1)[pos]
        np.testing.assert_array_equal(cols, np.repeat(pos[:, None],
                                                      cols.shape[1], 1))


def test_plan_without_sellcs_equals_reference(graph):
    ref, port = graph
    a = ref_make_row_partition(ref, 4)
    b = make_row_partition(port, 4)
    assert b.sell is None
    _assert_same_plan(a, b)


def test_skewed_sbm_sellcs_plan_equals_reference_and_is_uniform():
    """A four-block planted partition (skewed degrees, many width
    runs), placed by its truth labels: equal plans, and every run has
    the same shape on every shard."""
    W, truth = sbm_graph([60, 60, 60, 60], 0.3, 0.02, seed=0)
    truth = np.asarray(truth)
    port = convert.sparse_matrix(W.host_coo(), (W.n_rows, W.n_cols),
                                 device="cpu", build_ell=True)
    a = ref_make_row_partition(W, 4, truth, sellcs=True, sell_c=8)
    b = make_row_partition(port, 4, truth, sellcs=True, sell_c=8)
    _assert_same_plan(a, b)
    sell = b.sell
    for cols, vals, own in zip(sell.run_cols, sell.run_vals, sell.run_own):
        assert cols.shape[0] == 4 and vals.shape == cols.shape
        assert own.shape == cols.shape[:2]
        assert cols.shape[1] % sell.sell_c == 0
    widths = [c.shape[2] for c in sell.run_cols]
    assert widths == sorted(widths, reverse=True) and len(widths) > 1


def test_scrambled_placement_falls_back_to_gather(graph):
    """test_dist_halo.py's fallback boundary: a scrambled placement's
    halo is denser than the gather; auto falls back, keeps the computed
    width, bumps the counter and stamps the instant; forcing halo builds
    the same width."""
    ref, port = graph
    S = 4
    asg = np.random.default_rng(1).permutation(N)
    reg, tracer = metrics.MetricsRegistry(), trace.Tracer()
    prev, metrics.DEFAULT = metrics.DEFAULT, reg
    try:
        with trace.use(tracer):
            b = make_row_partition(port, S, assignment=asg)
    finally:
        metrics.DEFAULT = prev
    a = ref_make_row_partition(ref, S, assignment=asg)
    _assert_same_plan(a, b)
    R = b.rows_per_shard
    assert b.mode == "gather" and b.send_idx is None
    assert b.halo_width > HALO_FALLBACK_FRAC * R
    assert reg.value("dist_gather_fallback_total") == 1
    ev = [e for e in tracer.events if e["name"] == "dist.gather_fallback"]
    assert len(ev) == 1 and ev[0]["attrs"]["halo_width"] == b.halo_width
    bf = make_row_partition(port, S, assignment=asg, mode="halo")
    _assert_same_plan(ref_make_row_partition(ref, S, assignment=asg,
                                             mode="halo"), bf)
    assert bf.mode == "halo" and bf.halo_width == b.halo_width
    natural = make_row_partition(port, S)
    assert natural.mode == "halo"
    assert natural.halo_width <= HALO_FALLBACK_FRAC * R
    assert bf.wire_bytes(1)["halo"] >= natural.wire_bytes(1)["halo"]
    wb = natural.wire_bytes(k=8)
    assert wb["halo"] == S * (S - 1) * natural.halo_width * 8 * 4
    assert wb["gather"] == S * (S - 1) * R * 8 * 4
    assert wb["halo_rows_true"] <= S * (S - 1) * natural.halo_width


def test_rectangular_operator_gates(graph):
    """Placement and a forced halo need a square operator (both raise as
    the reference does); an edge ring on a rectangular matrix never
    routes to a dist backend, and naming one raises."""
    ref, _ = graph
    r, c, v = (np.asarray(a) for a in ref.host_coo())
    rect = convert.sparse_matrix((r, c, v), (N, N + 32), device="cpu",
                                 build_ell=True)
    ref_rect = RefSparseMatrix.from_coo(r, c, v, (N, N + 32), build_ell=True)
    for fn, A in ((ref_make_row_partition, ref_rect),
                  (make_row_partition, rect)):
        with pytest.raises(ValueError, match="square"):
            fn(A, 4, assignment=np.zeros(N, int))
        with pytest.raises(ValueError, match="square|n_shards"):
            fn(A, 4, mode="halo")
    mesh = device_mesh(device="cpu")
    ring = plap_edge_semiring(1.5, eps=1e-8)
    names = available_backends(rect, torch.ones((N + 32, 2)), ring,
                               desc=Descriptor(mesh=mesh))
    assert "dist" not in names and "dist_sellcs" not in names
    with pytest.raises(BackendUnavailableError):
        mxm(rect, torch.ones((N + 32, 2)), ring,
            desc=Descriptor(backend="dist", mesh=mesh))


def test_one_process_mesh_and_launch_path(graph, capsys):
    """In one process ``init_distributed`` is a no-op and the mesh has
    one rank; a one-shard partition then runs both dist backends, equal
    to the single-device product; a pre-built partition without the
    SELL-C-σ slicing is refused by dist_sellcs."""
    _, port = graph
    assert init_distributed() is False
    mesh = device_mesh(device="cpu")
    assert "rank 0 of 1 on cpu" in capsys.readouterr().out
    assert (mesh.size, mesh.rank, mesh.backend, mesh.staged) == (1, 0, None,
                                                                 False)
    assert dict(mesh.shape) == {"data": 1}
    with pytest.raises(ValueError, match="n_shards"):
        device_mesh(n_shards=4, device="cpu")
    X = torch.as_tensor(np.random.default_rng(0).standard_normal(
        (N, 3)).astype(np.float32))
    want = mxm(port, X)
    d = Descriptor(backend="dist_sellcs", mesh=mesh)
    with pytest.raises(BackendUnavailableError):
        mxm(make_row_partition(port, 1), X, desc=d)
    Aps = make_row_partition(port, 1, sellcs=True)
    np.testing.assert_allclose(mxm(Aps, X, desc=d), want, rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_allclose(
        mxm(port, X, desc=Descriptor(backend="dist", mesh=mesh)), want,
        rtol=2e-5, atol=2e-5)
    assert available_backends(port, X, desc=Descriptor(mesh=mesh))[:2] == [
        "dist", "dist_sellcs"]
    assert "dist" not in available_backends(port, X)


def test_other_padded_rings_fold_each_run_in_plain_pytorch(graph):
    """dist_sellcs runs the kernels for the reals ring and the apply; any
    other ring with a padded reducer folds each width run in plain
    PyTorch (the reference's generic branch), here on a one-rank mesh:
    a copy of the reals ring under another name gives the reals
    product."""
    from repro_torch.grblas import shard_mxm
    from repro_torch.grblas.semiring import (Semiring, reals_ring,
                                             register_ring_fast_paths)

    _, port = graph
    ring = Semiring(add=reals_ring.add, mul=reals_ring.mul, zero=0.0,
                    one=1.0, name="reals_+x copy (plain fold)")
    register_ring_fast_paths(ring.name,
                             padded=lambda c: torch.sum(c, dim=1))
    Ap = make_row_partition(port, 1, sellcs=True, sell_c=8)
    X = torch.as_tensor(np.random.default_rng(1).standard_normal(
        (N, 5)).astype(np.float32))
    K.reset_launch_counts()
    got = shard_mxm(Ap, X, device_mesh(device="cpu"), ring=ring,
                    layout="sellcs")
    np.testing.assert_allclose(got, mxm(port, X), rtol=2e-5, atol=2e-5)


def _extended(Ap, x, d):
    """Rank d's extended-local vector under a halo plan, by simulating
    the exchange in numpy: its rows, then at R + s*H + h row
    send[s, d*H + h] of shard s."""
    S, R, H = Ap.n_shards, Ap.rows_per_shard, Ap.halo_width
    send = np.asarray(Ap.send_idx)
    return np.concatenate([x[d * R:(d + 1) * R]] + [
        x[s * R + send[s, d * H:(d + 1) * H]] for s in range(S)])


@pytest.mark.parametrize("mode", ["halo", "gather"])
def test_shard_twins_equal_reference_shard_refs(mode):
    """The shard launch's plain versions against the reference's
    ``sellcs_shard_spmm_ref`` / ``sellcs_shard_plap_apply_ref`` run by
    run, for every rank, fp64: halo plans read the extended-local
    vector, gather plans the gathered one with own rows at d*R.  sell_c
    = 8 leaves a partial last slice (S = 3: R = 170)."""
    S = 3
    coo = _coo(np.float64)
    ref = RefSparseMatrix.from_coo(*coo, (N, N), build_ell=True,
                                   dtype=jnp.float64)
    port = convert.sparse_matrix(coo, (N, N), device="cpu", build_ell=True)
    a = ref_make_row_partition(ref, S, mode=mode, sellcs=True, sell_c=8)
    b = make_row_partition(port, S, mode=mode, sellcs=True, sell_c=8)
    _assert_same_plan(a, b)
    R = b.rows_per_shard
    x = np.random.default_rng(3).standard_normal((S * R, 4))
    x[N:] = 0.0
    p, eps = 1.5, 1e-8
    sell = b.sell
    for d in range(S):
        x_src = _extended(b, x, d) if mode == "halo" else x
        row0 = 0 if mode == "halo" else d * R
        sh = K.shard_layout([c[d] for c in sell.run_cols],
                            [v[d] for v in sell.run_vals],
                            [o[d] for o in sell.run_own], sell.inv[d],
                            sell.sell_c, row0, "cpu")
        assert sh.n == R and sh.x_rows <= len(x_src)
        assert int(sh.kernel.perm.min()) >= row0
        assert int(sh.kernel.perm.max()) < row0 + R
        xt = torch.as_tensor(x_src)
        x_local = x_src[row0:row0 + R]
        inv = np.asarray(a.sell.inv[d])
        want = np.concatenate([np.asarray(ref_kernels.sellcs_shard_spmm_ref(
            jnp.asarray(c[d]), jnp.asarray(v[d]), jnp.asarray(x_src)))
            for c, v in zip(a.sell.run_cols, a.sell.run_vals)])[inv]
        np.testing.assert_allclose(K.sellcs_shard_spmm(sh, xt).numpy(),
                                   want, rtol=1e-12, atol=1e-12)
        want = np.concatenate([np.asarray(
            ref_kernels.sellcs_shard_plap_apply_ref(
                jnp.asarray(c[d]), jnp.asarray(v[d]), jnp.asarray(x_src),
                jnp.asarray(x_local[np.asarray(o[d])]), p, eps))
            for c, v, o in zip(a.sell.run_cols, a.sell.run_vals,
                               a.sell.run_own)])[inv]
        np.testing.assert_allclose(
            K.sellcs_shard_plap_apply(sh, xt, p, eps).numpy(), want,
            rtol=1e-12, atol=1e-12)


def test_shard_layout_is_the_runs_slot_major(graph):
    """The kernel copy holds each run's slices slot-major (slot j of lane
    l at slice_ptr + j*C + l), the R real rows only, and a CPU x_src
    never counts a launch; an x_src too short for the column ids is
    refused."""
    _, port = graph
    b = make_row_partition(port, 3, sellcs=True, sell_c=8)
    sell, d = b.sell, 1
    sh = K.shard_layout([c[d] for c in sell.run_cols],
                        [v[d] for v in sell.run_vals],
                        [o[d] for o in sell.run_own], sell.inv[d], 8, 0,
                        "cpu")
    L = sh.kernel
    R = b.rows_per_shard
    assert L.n == R and L.perm.shape[0] == R and R % 8 != 0
    own = np.concatenate([o[d] for o in sell.run_own])
    cols = np.concatenate([c[d].reshape(-1, 8, c.shape[2]).transpose(
        0, 2, 1).reshape(-1) for c in sell.run_cols])
    np.testing.assert_array_equal(L.perm.numpy(), own[:R])
    np.testing.assert_array_equal(L.cols.numpy(), cols)
    ptr, w = L.slice_ptr.numpy(), L.slice_w.numpy()
    np.testing.assert_array_equal(ptr[1:], np.cumsum(w * 8)[:-1])
    K.reset_launch_counts()
    x = torch.zeros((sh.x_rows, 2))
    K.sellcs_shard_spmm(sh, x)
    assert K.SHARD_LAUNCHES == {}
    with pytest.raises(ValueError, match="x_src"):
        K.sellcs_shard_spmm(sh, x[:-1])
    with pytest.raises(TypeError):
        K.sellcs_shard_spmm(sh, x.double())
