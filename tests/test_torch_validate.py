"""Graph validation, connected components, degenerate inputs, Matrix
Market I/O and partitioning in the port, against the reference
(``tests/test_degenerate_graphs.py``, its serve case included,
``tests/test_mmio.py``, ``tests/test_partition.py``'s balanced partition),
and the rings they need: the boolean, min-plus and max-times rings
through ``api.mxv`` / ``vxm`` and the generic folds.

Exact equality where the answer is discrete or copied: components,
``allocate_k``, the repaired COO triple and the Matrix Market fixtures'
COO triples equal the reference's; the boolean, min and max products are
exact; a generic fold of integers is exact."""
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the reference-only CI has no torch

import jax.numpy as jnp
from repro import graphs as ref_graphs
from repro.grblas import api as ref_api
from repro.grblas import ops as ref_ops
from repro.grblas import semiring as ref_semiring
from repro.grblas.api import Descriptor as RefDesc
from repro_torch import convert
from repro_torch.core.psc import PSCConfig, p_spectral_cluster
from repro_torch.graphs import (GraphValidationError, ValidateConfig,
                                allocate_k, connected_components, cut_edges,
                                delaunay_graph, gaussian_blobs_knn,
                                isolated_vertices, partition, quick_check,
                                read_matrix_market, ring_of_cliques,
                                validate_graph, write_matrix_market)
from repro_torch.grblas import Descriptor, SparseMatrix, api, ops, semiring
from repro_torch.multilevel import MultilevelConfig

torch.set_num_threads(1)

DATA = Path(__file__).resolve().parent / "data"


def _sym(pairs, n, w=1.0):
    r = [a for a, b in pairs] + [b for a, b in pairs]
    c = [b for a, b in pairs] + [a for a, b in pairs]
    return SparseMatrix.from_coo(np.array(r), np.array(c),
                                 np.full(len(r), w), (n, n), device="cpu")


def _clique(lo, hi):
    return [(i, j) for i in range(lo, hi) for j in range(i + 1, hi)]


def _two_cliques():
    """10-clique + 14-clique, no edges between them."""
    return _sym(_clique(0, 10) + _clique(10, 24), 24), (10, 14)


def _ref(W):
    """The reference's SparseMatrix of a port matrix's COO triple."""
    from repro.grblas.containers import SparseMatrix as RefSparseMatrix

    return RefSparseMatrix.from_coo(*W.host_coo(), (W.n_rows, W.n_cols))


def _assert_coo_equal(A, B):
    for a, b in zip(A.host_coo(), B.host_coo()):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _same_partition(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return len(set(zip(a.tolist(), b.tolist()))) == len(set(a.tolist())) \
        == len(set(b.tolist()))


# ------------------------------------------------------------------- rings

def _random_graph(n=60, seed=0):
    rng = np.random.default_rng(seed)
    r = rng.integers(0, n, 4 * n)
    c = rng.integers(0, n, 4 * n)
    v = rng.uniform(0.5, 2.0, r.size)
    v[::7] = 0.0                       # stored zeros: false under and
    return r, c, v, n


@pytest.mark.parametrize("ring", ["bool_|&", "min_+", "max_x"])
@pytest.mark.parametrize("transpose", [False, True])
def test_rings_mxv_vxm_match_reference(ring, transpose):
    r, c, v, n = _random_graph()
    W = SparseMatrix.from_coo(r, c, v, (n, n), dtype=torch.float64,
                              device="cpu")
    from repro.grblas.containers import SparseMatrix as RefSparseMatrix

    Wr = RefSparseMatrix.from_coo(r, c, v, (n, n), dtype=jnp.float64)
    rng = np.random.default_rng(1)
    x = (rng.random(n) < 0.3) if ring == "bool_|&" \
        else rng.standard_normal(n)
    port_ring = {"bool_|&": semiring.boolean_ring,
                 "min_+": semiring.min_plus_ring,
                 "max_x": semiring.max_times_ring}[ring]
    ref_ring = {"bool_|&": ref_semiring.boolean_ring,
                "min_+": ref_semiring.min_plus_ring,
                "max_x": ref_semiring.max_times_ring}[ring]
    xt = torch.as_tensor(x)
    if transpose:
        got = api.vxm(xt, W, port_ring, desc=Descriptor(backend="coo"))
        want = ref_api.vxm(jnp.asarray(x), Wr, ref_ring,
                           desc=RefDesc(backend="coo"))
    else:
        got = api.mxv(W, xt, port_ring, desc=Descriptor(backend="coo"))
        want = ref_api.mxv(Wr, jnp.asarray(x), ref_ring,
                           desc=RefDesc(backend="coo"))
    np.testing.assert_array_equal(convert.to_numpy(got), np.asarray(want))
    # a row of a multivector reduces the same as the vector alone
    if ring != "bool_|&":
        X = torch.stack([xt, 2 * xt], dim=1)
        Y = api.mxm(W, X, port_ring, desc=Descriptor(backend="coo",
                                                     transpose=transpose))
        np.testing.assert_array_equal(convert.to_numpy(Y[:, 0]),
                                      convert.to_numpy(got))


def _int_max_ring(pkg_semiring, maximum):
    """A max monoid no fast path is registered for: the generic folds."""
    return pkg_semiring.Semiring(add=maximum, mul=lambda a, b: a * b,
                                 zero=-(2 ** 30), one=1, name="int_max_test")


@pytest.mark.parametrize("axis", [None, 0, 1])
def test_generic_dense_fold_matches_reference(axis):
    a = np.random.default_rng(2).integers(-50, 50, (5, 7))
    got = ops.reduce(torch.as_tensor(a), _int_max_ring(semiring,
                                                       torch.maximum),
                     axis=axis)
    want = ref_ops.reduce(jnp.asarray(a), _int_max_ring(ref_semiring,
                                                        jnp.maximum),
                          axis=axis)
    np.testing.assert_array_equal(convert.to_numpy(got), np.asarray(want))
    # registered rings keep their dense fast paths
    np.testing.assert_array_equal(
        convert.to_numpy(ops.reduce(torch.as_tensor(a > 0),
                                    semiring.boolean_ring, axis=axis)),
        np.asarray(ref_ops.reduce(jnp.asarray(a > 0),
                                  ref_semiring.boolean_ring, axis=axis)))


@pytest.mark.parametrize("axis", [None, 0])
def test_generic_dense_fold_is_vectorized(axis):
    """A monoid with no fast path folds 10^5 entries in log2(n) steps of
    ``ring.add`` and agrees with the reals ring's dense fast path
    (integer-valued float64: every partial sum is exact, so equal)."""
    n = 10 ** 5
    a = torch.as_tensor(np.random.default_rng(4).integers(
        -1000, 1000, (n, 3) if axis == 0 else n).astype(np.float64))
    calls = []

    def add(x, y):
        calls.append(1)
        return x + y

    ring = semiring.Semiring(add=add, mul=lambda x, y: x * y, zero=0.0,
                             one=1.0, name="plus_test")
    got = ops.reduce(a, ring, axis=axis)
    want = semiring.fast_paths(semiring.reals_ring).dense(a, axis)
    assert torch.equal(got, want)
    assert len(calls) == int(np.ceil(np.log2(n)))


def test_generic_segment_fold_matches_reference():
    rng = np.random.default_rng(3)
    vals = rng.integers(-100, 100, (40, 3))
    ids = rng.integers(0, 9, 40)
    got = _int_max_ring(semiring, torch.maximum).segment_reduce(
        torch.as_tensor(vals), torch.as_tensor(ids), 10)
    want = _int_max_ring(ref_semiring, jnp.maximum).segment_reduce(
        jnp.asarray(vals), jnp.asarray(ids), 10)
    np.testing.assert_array_equal(convert.to_numpy(got), np.asarray(want))
    # an order-sensitive monoid sees every segment in entry order
    first = semiring.Semiring(add=lambda a, b: torch.where(a == 0, b, a),
                              mul=lambda a, b: a * b, zero=0, one=1,
                              name="first_test")
    out = first.segment_reduce(torch.as_tensor(vals[:, 0] + 1000),
                               torch.as_tensor(ids), 10)
    for s in range(10):
        hit = np.where(ids == s)[0]
        assert int(out[s]) == (vals[hit[0], 0] + 1000 if len(hit) else 0)


# ---------------------------------------------------------------- tiny / k

def test_empty_graph_raises_actionable():
    W = SparseMatrix.from_coo(np.array([], np.int64), np.array([], np.int64),
                              np.array([], np.float64), (0, 0), device="cpu")
    with pytest.raises(ValueError, match="empty graph"):
        p_spectral_cluster(W, PSCConfig(k=1))


def test_k_equals_one_and_n_validated():
    W, _ = _two_cliques()
    res = p_spectral_cluster(W, PSCConfig(k=1, validate=True))
    assert (res.labels == 0).all() and res.rcut == 0.0
    n = 4
    loops = SparseMatrix.from_coo(np.arange(n), np.arange(n), np.ones(n),
                                  (n, n), device="cpu")
    res = p_spectral_cluster(loops, PSCConfig(k=n, validate=True))
    np.testing.assert_array_equal(res.labels, np.arange(n))


def test_trivial_k_short_circuits_multilevel():
    """k = 1 under a V-cycle: every label 0, no hierarchy, no p path —
    as the reference's ``test_degenerate_graphs.py`` asks of it."""
    from repro.core.psc import PSCConfig as RefPSCConfig
    from repro.core.psc import p_spectral_cluster as ref_cluster
    from repro.multilevel.vcycle import MultilevelConfig as RefMLConfig

    W, _ = ring_of_cliques(4, 6, device="cpu")
    res = p_spectral_cluster(W, PSCConfig(
        k=1, multilevel=MultilevelConfig(coarse_size=8)))
    assert (res.labels == 0).all()
    assert res.levels is None and res.p_path == []
    Wr, _ = ref_graphs.ring_of_cliques(4, 6)
    ref = ref_cluster(Wr, RefPSCConfig(k=1,
                                       multilevel=RefMLConfig(coarse_size=8)))
    np.testing.assert_array_equal(np.asarray(res.labels),
                                  np.asarray(ref.labels))
    assert (ref.levels, ref.p_path) == (res.levels, res.p_path)


def test_serve_tiny_and_degenerate_k():
    """Tiny serve requests: k == n goes to the solo lane, k = 1 labels
    everything 0, a 9-vertex star splits in two; k = 5 on n = 2 raises
    at submit and nothing fails.  The reference's engine takes the same
    requests and must give the same ok flags, lanes and partitions."""
    from repro.core.psc import PSCConfig as RefPSCConfig
    from repro.serve.psc_engine import ClusterServeEngine as RefEngine
    from repro_torch.serve import ClusterServeEngine

    W2 = _sym([(0, 1)], 2)
    Wstar = _sym([(0, i) for i in range(1, 9)], 9)
    runs = []
    for eng, conv in (
            (ClusterServeEngine(PSCConfig(k=2, newton_iters=6, tcg_iters=4)),
             lambda W: W),
            (RefEngine(RefPSCConfig(k=2, newton_iters=6, tcg_iters=4)),
             _ref)):
        rid_edge = eng.submit(conv(W2))              # k == n -> solo lane
        rid_one = eng.submit(conv(Wstar), k=1)
        rid_star = eng.submit(conv(Wstar))
        done = eng.flush()
        with pytest.raises(ValueError, match="k="):
            eng.submit(conv(W2), k=5)
        assert eng.stats.n_failed == 0
        runs.append([done[r] for r in (rid_edge, rid_one, rid_star)])
    (edge, one, star), ref = runs
    assert edge.ok
    assert sorted(edge.labels.tolist()) == [0, 1]
    assert edge.stats.lane == "solo"
    assert one.ok and (one.labels == 0).all()
    assert star.ok
    assert len(set(star.labels.tolist())) == 2
    for got, want in zip(runs[0], ref):
        assert (got.ok, got.stats.lane) == (want.ok, want.stats.lane)
        assert _same_partition(np.asarray(got.labels),
                               np.asarray(want.labels))


# ------------------------------------------------------------- disconnected

def test_disconnected_components_match_reference():
    W, sizes = _two_cliques()
    comps = connected_components(W)
    assert comps.n_components == 2
    assert sorted(comps.sizes.tolist()) == sorted(sizes)
    assert isolated_vertices(W).size == 0
    ref = ref_graphs.connected_components(_ref(W))
    np.testing.assert_array_equal(comps.labels, ref.labels)
    np.testing.assert_array_equal(comps.sizes, ref.sizes)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_components_with_isolated_vertices_match_reference(seed):
    """A sparse random pattern (many components, isolated vertices, one
    edge stored one way only): labels, count and sizes equal the
    reference's exactly."""
    rng = np.random.default_rng(seed)
    n = 80
    r = rng.integers(0, n, 50)
    c = rng.integers(0, n, 50)
    W = SparseMatrix.from_coo(np.r_[r, c[:-1]], np.r_[c, r[:-1]],
                              np.ones(99), (n, n), device="cpu")
    comps = connected_components(W)
    ref = ref_graphs.connected_components(_ref(W))
    assert comps.n_components == ref.n_components > 1
    np.testing.assert_array_equal(comps.labels, ref.labels)
    np.testing.assert_array_equal(comps.sizes, ref.sizes)
    np.testing.assert_array_equal(isolated_vertices(W),
                                  ref_graphs.isolated_vertices(_ref(W)))


def test_disconnected_cliques_cluster_per_component():
    W, _ = _two_cliques()
    res = p_spectral_cluster(W, PSCConfig(k=2, validate=True))
    assert res.rcut == 0.0
    assert len(res.components) == 2
    labels = np.asarray(res.labels)
    assert len(set(labels[:10].tolist())) == 1
    assert len(set(labels[10:].tolist())) == 1
    assert labels[0] != labels[10]
    assert res.U.device == W.device and res.U.dtype == W.vals.dtype


def test_disconnected_cliques_k4_allocates_proportionally():
    W, _ = _two_cliques()
    res = p_spectral_cluster(W, PSCConfig(
        k=4, validate=True, newton_iters=6, tcg_iters=4))
    assert len(set(res.labels.tolist())) == 4
    assert np.isfinite(res.rcut)
    assert [c["k"] for c in res.components] == [2, 2]
    labels = np.asarray(res.labels)
    assert not (set(labels[:10].tolist()) & set(labels[10:].tolist()))


def test_k_below_component_count_is_actionable():
    W = _sym(_clique(0, 4) + _clique(4, 8) + _clique(8, 12), 12)
    with pytest.raises(ValueError, match="raise k"):
        p_spectral_cluster(W, PSCConfig(k=2, validate=True))


def test_self_loops_only_graph():
    n = 4
    W = SparseMatrix.from_coo(np.arange(n), np.arange(n), np.ones(n),
                              (n, n), device="cpu")
    assert isolated_vertices(W).size == n
    assert connected_components(W).n_components == n
    with pytest.raises(ValueError, match="isolated"):
        p_spectral_cluster(W, PSCConfig(k=2, validate=True))


@pytest.mark.parametrize("sizes,k", [([10, 14], 4), ([30, 3], 4), ([5, 1], 4),
                                     ([2, 2], 4), ([7, 1, 1, 20], 9),
                                     ([100, 3, 40], 17)])
def test_allocate_k_matches_reference(sizes, k):
    got = allocate_k(np.array(sizes), k)
    np.testing.assert_array_equal(got, ref_graphs.allocate_k(
        np.array(sizes), k))
    assert got.sum() == k and (got >= 1).all()


def test_allocate_k_raises_like_reference():
    with pytest.raises(ValueError, match="raise k"):
        allocate_k(np.array([3, 3, 3]), 2)
    with pytest.raises(ValueError):
        allocate_k(np.array([2, 2]), 5)


# ---------------------------------------------------------- duplicate edges

def test_duplicate_coo_entries_flat_and_multilevel():
    W1, _ = ring_of_cliques(4, 6, device="cpu")
    r, c, v = W1.host_coo()
    Wdup = SparseMatrix.from_coo(np.r_[r, r], np.r_[c, c], np.r_[v, v],
                                 (W1.n_rows, W1.n_rows), device="cpu")
    assert Wdup.nnz == 2 * W1.nnz
    cfg = PSCConfig(k=4, newton_iters=6, tcg_iters=4)
    assert _same_partition(p_spectral_cluster(W1, cfg).labels,
                           p_spectral_cluster(Wdup, cfg).labels)
    ml = p_spectral_cluster(Wdup, PSCConfig(
        k=4, newton_iters=6, tcg_iters=4,
        multilevel=MultilevelConfig(coarse_size=12)))
    assert np.isfinite(ml.rcut) and len(set(ml.labels.tolist())) == 4


# ------------------------------------------------------------- validate unit

def test_validate_rejects_nonfinite_with_hint():
    W, _ = _two_cliques()
    r, c, v = W.host_coo()
    v = np.array(v)
    v[5] = np.nan
    bad = SparseMatrix.from_coo(r, c, v, (24, 24), device="cpu")
    assert quick_check(bad) is not None
    with pytest.raises(GraphValidationError, match="repair=True") as ei:
        validate_graph(bad)
    assert any("non-finite" in i for i in ei.value.issues)
    with pytest.raises(GraphValidationError):
        p_spectral_cluster(bad, PSCConfig(k=2, validate=True))
    assert quick_check(W) is None


def test_validate_repairs_like_reference():
    """NaN, Inf and negative weights and one edge stored one way only:
    the repaired COO triple equals the reference's, the graph keeps its
    layouts, and the issues listed are the reference's."""
    W, _ = _two_cliques()
    r, c, v = W.host_coo()
    v = np.array(v)
    v[5], v[7], v[11] = np.inf, -3.0, np.nan
    keep = np.ones(len(v), bool)
    keep[40] = False
    coo = (r[keep], c[keep], v[keep])
    bad = SparseMatrix.from_coo(*coo, (24, 24), device="cpu",
                                build_sellcs=True, sell_c=8)
    from repro.grblas.containers import SparseMatrix as RefSparseMatrix

    ref_bad = RefSparseMatrix.from_coo(*coo, (24, 24))
    fixed = validate_graph(bad, ValidateConfig(repair=True))
    ref_fixed = ref_graphs.validate_graph(
        ref_bad, ref_graphs.ValidateConfig(repair=True))
    _assert_coo_equal(fixed, ref_fixed)
    assert fixed.sell_cols is not None and fixed.sell_c == 8
    fv = convert.to_numpy(fixed.vals)
    assert np.isfinite(fv).all() and (fv > 0).all()
    with pytest.raises(GraphValidationError) as ei:
        validate_graph(bad)
    with pytest.raises(ref_graphs.GraphValidationError) as ref_ei:
        ref_graphs.validate_graph(ref_bad)
    assert ei.value.issues == ref_ei.value.issues


def test_validate_repairs_asymmetry():
    W = SparseMatrix.from_coo(np.array([0, 1, 2]), np.array([1, 2, 0]),
                              np.array([1.0, 2.0, 3.0]), (3, 3), device="cpu")
    with pytest.raises(GraphValidationError, match="asym"):
        validate_graph(W)
    fixed = validate_graph(W, ValidateConfig(repair=True))
    assert fixed.nnz == 6
    rr, cc, vv = fixed.host_coo()
    d = {(int(a), int(b)): float(x) for a, b, x in zip(rr, cc, vv)}
    assert d[(0, 1)] == d[(1, 0)] == 1.0
    healthy, _ = ring_of_cliques(3, 4, device="cpu")
    assert validate_graph(healthy) is healthy
    with pytest.raises(TypeError):
        PSCConfig(validate="strict")


# --------------------------------------------------------------- mmio

@pytest.mark.parametrize("name", ["ring3x4.mtx.gz", "cycle6.mtx"])
def test_committed_fixtures_equal_reference(name):
    R = read_matrix_market(DATA / name, device="cpu")
    ref = ref_graphs.read_matrix_market(DATA / name)
    assert (R.n_rows, R.n_cols, R.nnz) == (ref.n_rows, ref.n_cols, ref.nnz)
    _assert_coo_equal(R, ref)
    assert R.vals.dtype == torch.float32


def test_pattern_symmetric_fixture():
    P = read_matrix_market(DATA / "cycle6.mtx", device="cpu")
    d = convert.to_numpy(P.to_dense())
    assert P.nnz == 14
    np.testing.assert_array_equal(d, d.T)
    assert set(np.unique(d).tolist()) == {0.0, 1.0}


def test_chunked_parse_equals_slurp():
    base = read_matrix_market(DATA / "ring3x4.mtx.gz", device="cpu")
    for chunk in (1, 2, 5, 1000):
        R = read_matrix_market(DATA / "ring3x4.mtx.gz", chunk=chunk,
                               device="cpu")
        _assert_coo_equal(R, base)


def test_round_trip_weighted_and_pattern(tmp_path):
    W, _ = gaussian_blobs_knn(12, 3, knn=4, seed=0, device="cpu",
                              dtype=torch.float64)
    for name in ("w.mtx", "w.mtx.gz"):
        p = tmp_path / name
        write_matrix_market(p, W)
        R = read_matrix_market(p, chunk=17, device="cpu",
                               dtype=torch.float64)
        _assert_coo_equal(R, W)
    P, _ = ring_of_cliques(3, 5, device="cpu")
    p = tmp_path / "p.mtx"
    write_matrix_market(p, P, pattern=True, comment="pattern round trip")
    R = read_matrix_market(p, chunk=3, device="cpu")
    np.testing.assert_array_equal(
        convert.to_numpy(R.to_dense()),
        (convert.to_numpy(P.to_dense()) != 0).astype(np.float32))
    # the reference reads the port's file to the same triple
    _assert_coo_equal(R, ref_graphs.read_matrix_market(p))


def test_bad_files_raise(tmp_path):
    p = tmp_path / "t.mtx"
    p.write_text("%%MatrixMarket matrix coordinate real general\n"
                 "4 4 3\n1 2 1.0\n2 3 2.0\n")
    with pytest.raises(ValueError, match="truncated"):
        read_matrix_market(p, chunk=2, device="cpu")
    q = tmp_path / "x.mtx"
    q.write_text("4 4 0\n")
    with pytest.raises(ValueError, match="MatrixMarket"):
        read_matrix_market(q, device="cpu")


def test_layout_kwargs_passthrough():
    R = read_matrix_market(DATA / "ring3x4.mtx.gz", build_sellcs=True,
                           sell_c=4, device="cpu")
    assert R.sell_cols is not None and R.sell_c == 4


# ---------------------------------------------------------------- partition

def test_partition_balanced_and_better_than_contiguous():
    W, _ = delaunay_graph(9, seed=0, locality_order=False, device="cpu")
    n_parts = 4
    labels, info = partition(W, n_parts, seed=0)
    sizes = np.asarray(info["sizes"])
    assert sizes.sum() == W.n_rows
    assert sizes.max() - sizes.min() <= W.n_rows // n_parts // 2 + 1
    contiguous = np.repeat(np.arange(n_parts), -(-W.n_rows // n_parts))
    contiguous = contiguous[: W.n_rows]
    cut_p = cut_edges(W, labels)
    cut_c = cut_edges(W, contiguous)
    assert cut_p < 0.8 * cut_c, (cut_p, cut_c)
    assert np.isfinite(info["rcut"])
    assert cut_c == ref_graphs.cut_edges(_ref(W), contiguous)
