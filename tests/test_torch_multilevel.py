"""The port's multilevel subsystem against the reference, on the CPU:
heavy-edge matching, prolongators, Galerkin coarsening and whole
hierarchies (the BSR layout of every level included), and the V-cycle
end to end on the planted partition of tests/test_multilevel.py.

Tolerances:
  * aggregates, prolongators, coarse COO index arrays and layout arrays:
    exact (the construction is deterministic host numpy in both
    packages);
  * coarse values, volumes and node counts in float64: within 1e-12;
  * the V-cycle: accuracy >= 0.95 on the planted partition, RCut at most
    1.05 x the reference V-cycle's on the same graph, and U^T U within
    1e-4 of I (jax.random and torch.Generator streams differ, so the
    runs are held by quality, not label for label).
"""
import functools

import numpy as np
import pytest
import scipy.sparse as sp

torch = pytest.importorskip("torch")  # the reference-only CI has no torch

import jax.numpy as jnp
from repro.core import PSCConfig as RefConfig
from repro.core import p_spectral_cluster as ref_cluster
from repro.graphs import delaunay_graph, ring_of_cliques, sbm_graph
from repro.grblas import SparseMatrix as RefMatrix
from repro.multilevel import MultilevelConfig as RefML
from repro.multilevel import build_hierarchy as ref_build
from repro.multilevel import coarsen_graph as ref_coarsen
from repro.multilevel import heavy_edge_matching as ref_hem
from repro.multilevel import prolongator_from_aggregates as ref_prolongator
from repro_torch import convert
from repro_torch.core import metrics
from repro_torch.core.psc import PSCConfig, p_spectral_cluster
from repro_torch.multilevel import (MultilevelConfig, build_hierarchy,
                                    coarsen_graph, heavy_edge_matching,
                                    prolongator_from_aggregates)

# Small CPU problems: intra-op threads only contend with the other test
# workers.
torch.set_num_threads(1)

TOL = dict(rtol=1e-12, atol=1e-12)


def _rand_sym(n, density, seed, weighted=True):
    A = sp.random(n, n, density=density,
                  random_state=np.random.RandomState(seed))
    A = A + A.T
    A.setdiag(0)
    A.eliminate_zeros()
    if not weighted:
        A.data[:] = 1.0
    return RefMatrix.from_scipy(A, dtype=jnp.float64)


GRAPHS = {
    "delaunay": lambda: delaunay_graph(10, dtype=jnp.float64)[0],
    "sbm": lambda: sbm_graph([60] * 3, p_in=0.3, p_out=0.02, seed=2,
                             dtype=jnp.float64)[0],
    "random_weighted": lambda: _rand_sym(300, 0.02, seed=3),
    "random_unit": lambda: _rand_sym(300, 0.02, seed=4, weighted=False),
    "cliques": lambda: ring_of_cliques(6, 8, dtype=jnp.float64)[0],
}


def _port(ref, **layout):
    return convert.sparse_matrix(ref.host_coo(), (ref.n_rows, ref.n_cols),
                                 device="cpu", **layout)


def _assert_coo_equal(port, ref, values_exact=False):
    assert (port.n_rows, port.n_cols, port.nnz) == \
        (ref.n_rows, ref.n_cols, ref.nnz)
    (pr, pc, pv), (rr, rc, rv) = port.host_coo(), ref.host_coo()
    np.testing.assert_array_equal(pr, rr)
    np.testing.assert_array_equal(pc, rc)
    if values_exact:
        np.testing.assert_array_equal(pv, rv)
    else:
        np.testing.assert_allclose(pv, rv, **TOL)


@pytest.mark.parametrize("max_agg", [2, 4])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_heavy_edge_matching_equals_reference(name, max_agg):
    ref = GRAPHS[name]()
    agg = heavy_edge_matching(_port(ref), max_agg=max_agg)
    want = ref_hem(ref, max_agg=max_agg)
    assert agg.dtype == want.dtype
    np.testing.assert_array_equal(agg, want)


def test_prolongator_equals_reference():
    ref = GRAPHS["sbm"]()
    agg = ref_hem(ref)
    n_c = int(agg.max()) + 1
    P = prolongator_from_aggregates(agg, n_c, dtype=torch.float64,
                                    device="cpu")
    want = ref_prolongator(agg, n_c, dtype=jnp.float64)
    _assert_coo_equal(P, want, values_exact=True)
    np.testing.assert_array_equal(P.ell_cols.numpy(), np.asarray(want.ell_cols))


@pytest.mark.parametrize("cap", [None, 3])
@pytest.mark.parametrize("name", ["delaunay", "random_weighted"])
def test_coarsen_graph_equals_reference(name, cap):
    ref = GRAPHS[name]()
    P, Wc, info = coarsen_graph(_port(ref), sparsify_cap=cap)
    rP, rWc, rinfo = ref_coarsen(ref, sparsify_cap=cap)
    np.testing.assert_array_equal(info.agg, rinfo.agg)
    assert (info.n_fine, info.n_coarse) == (rinfo.n_fine, rinfo.n_coarse)
    _assert_coo_equal(P, rP, values_exact=True)
    _assert_coo_equal(Wc, rWc)
    # Galerkin keeps weighted degrees: W_c 1 = P^T (W 1)
    np.testing.assert_allclose(
        Wc.row_sums().numpy(),
        np.bincount(info.agg, weights=_port(ref).row_sums().numpy()),
        rtol=1e-12)


@pytest.mark.parametrize("layout", [None, {"build_bsr": True,
                                           "block_size": 32}])
@pytest.mark.parametrize("sparsify", ["auto", None])
def test_build_hierarchy_equals_reference(sparsify, layout):
    ref = GRAPHS["delaunay"]()
    hier = build_hierarchy(_port(ref), coarse_size=64, sparsify=sparsify,
                           layout_kwargs=layout)
    want = ref_build(ref, coarse_size=64, sparsify=sparsify,
                     layout_kwargs=layout)
    assert hier.n_levels == want.n_levels >= 3
    for lv, rlv in zip(hier.levels, want.levels):
        _assert_coo_equal(lv.W, rlv.W)
        np.testing.assert_allclose(lv.vol.numpy(), np.asarray(rlv.vol), **TOL)
        np.testing.assert_allclose(lv.counts.numpy(), np.asarray(rlv.counts),
                                   **TOL)
        assert (lv.W.ell_cols is None) == (rlv.W.ell_cols is None)
        assert (lv.W.bsr_blocks is None) == (rlv.W.bsr_blocks is None)
        if rlv.W.bsr_blocks is not None:
            np.testing.assert_array_equal(lv.W.bsr_indptr, rlv.W.bsr_indptr)
            for name in ("bsr_indices", "bsr_row_ids"):
                np.testing.assert_array_equal(
                    getattr(lv.W, name).numpy(), np.asarray(getattr(rlv.W,
                                                                    name)))
            np.testing.assert_allclose(lv.W.bsr_blocks.numpy(),
                                       np.asarray(rlv.W.bsr_blocks), **TOL)
    for info, rinfo in zip(hier.infos, want.infos):
        np.testing.assert_array_equal(info.agg, rinfo.agg)
    for P, rP in zip(hier.prolongators, want.prolongators):
        _assert_coo_equal(P, rP, values_exact=True)
    np.testing.assert_array_equal(hier.aggregate_of_finest(hier.n_levels - 1),
                                  want.aggregate_of_finest(want.n_levels - 1))


def test_multilevel_config_solvers_and_true():
    from repro_torch.multilevel.vcycle import coerce

    assert coerce(True) == MultilevelConfig()
    assert coerce(MultilevelConfig(coarse_size=7)).coarse_size == 7
    assert coerce(MultilevelConfig(refine_solver="newton")).refine_solver \
        == "newton"
    for field in ("coarse_solver", "refine_solver"):
        ml = MultilevelConfig(**{field: "scf"})
        assert PSCConfig(multilevel=ml).multilevel == ml
        with pytest.raises(ValueError, match="registered"):
            PSCConfig(multilevel=MultilevelConfig(**{field: "nope"}))


def test_multilevel_true_small_graph_runs_flat():
    W, truth = ring_of_cliques(4, 12)
    res = p_spectral_cluster(_port(W), PSCConfig(
        k=4, p_target=1.5, newton_iters=8, tcg_iters=6, kmeans_restarts=4,
        seed=0, multilevel=True))      # n < coarse_size: the flat path
    assert metrics.clustering_accuracy(res.labels, truth, 4) == 1.0
    assert res.levels is None and "init" in res.stage_seconds


# ------------------------------------------------------------- V-cycle e2e

KW = dict(k=4, p_target=1.4, newton_iters=10, tcg_iters=8, kmeans_restarts=4,
          seed=0)


@functools.lru_cache(maxsize=None)
def _reference_vcycle():
    W, truth = sbm_graph([80] * 4, p_in=0.25, p_out=0.01, seed=3)
    res = ref_cluster(W, RefConfig(multilevel=RefML(coarse_size=48), **KW))
    return W, truth, float(res.rcut), res


@pytest.mark.parametrize("backend,mode", [("edge_pallas", "matrix_free"),
                                          ("edge_pallas", "graphblas"),
                                          ("auto", "graphblas")])
def test_vcycle_matches_reference_quality(backend, mode):
    W, truth, ref_rcut, ref_res = _reference_vcycle()
    layout = (dict(build_bsr=True, block_size=32, build_ell=False,
                   build_sellcs=False) if backend == "edge_pallas" else {})
    res = p_spectral_cluster(_port(W, **layout), PSCConfig(
        backend=backend, hvp_mode=mode,
        multilevel=MultilevelConfig(coarse_size=48), **KW))
    assert metrics.clustering_accuracy(res.labels, truth, 4) >= 0.95
    assert res.rcut <= ref_rcut * 1.05 + 1e-9, (res.rcut, ref_rcut)
    G = convert.to_numpy(res.U.T @ res.U)
    np.testing.assert_allclose(G, np.eye(4), atol=1e-4)
    assert res.U.shape == (W.n_rows, 4) and len(res.labels) == W.n_rows
    # the same hierarchy and the same refined levels as the reference
    assert [r["level"] for r in res.levels] == \
        [r["level"] for r in ref_res.levels]
    assert [(h["n"], h["nnz"]) for h in res.hierarchy] == \
        [(r["n"], r["nnz"]) for r in _reference_hierarchy_shape()]
    assert len(res.p_path) == len(res.fvals) == len(res.hvp_counts)
    assert res.init_labels is not None and np.isfinite(res.init_rcut)
    assert set(res.stage_seconds) == {"hierarchy", "coarse_solve", "walk_up",
                                      "kmeans"}
    if backend == "edge_pallas":     # every level carries its BSR tiles
        assert all(h["bsr_tiles"] for h in res.hierarchy)


@functools.lru_cache(maxsize=None)
def _reference_hierarchy_shape():
    W = _reference_vcycle()[0]
    hier = ref_build(W, coarse_size=48)
    return [{"n": lv.W.n_rows, "nnz": lv.W.nnz} for lv in hier.levels]
