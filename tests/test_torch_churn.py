"""The port's warm cache and churn path (``repro_torch.serve.warm_cache``,
``serve.churn``, ``multilevel.patch_hierarchy`` / ``refine_cluster`` and
``PSCConfig.init_U``) on the CPU.  Mirrors ``tests/test_warm_cache.py``
and the hierarchy-patch cases of ``tests/test_psc_serve.py``.

Held exactly to the reference: ``apply_edge_delta`` (the edited host COO,
``touched`` and ``pattern_changed``) and ``patch_hierarchy`` (per-level
aggregates, prolongators, coarse COO index arrays and records; coarse
values, volumes and counts in float64 within 1e-12), both host numpy on
both sides.  The warm entry: its p path equals the reference's, and on
an unchanged graph it returns the cold solve's labels.  Churn results
are held as the reference holds them: RCut within 1.02 x a scratch solve
of the edited graph."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the reference-only CI has no torch

import jax.numpy as jnp
from repro.core import PSCConfig as RefConfig
from repro.core import p_spectral_cluster as ref_cluster
from repro.graphs import delaunay_graph as ref_delaunay
from repro.graphs import sbm_graph as ref_sbm_graph
from repro.multilevel import build_hierarchy as ref_build
from repro.multilevel import patch_hierarchy as ref_patch
from repro.serve import EdgeDelta as RefEdgeDelta
from repro.serve import apply_edge_delta as ref_apply
from repro_torch import convert
from repro_torch.core.psc import PSCConfig, p_spectral_cluster
from repro_torch.graphs import delaunay_graph, ring_of_cliques, sbm_graph
from repro_torch.grblas import SparseMatrix
from repro_torch.multilevel import (MultilevelConfig, build_hierarchy,
                                    patch_hierarchy, refine_cluster)
from repro_torch.serve import (CacheEntry, ClusterServeEngine, EdgeDelta,
                               WarmCache, apply_edge_delta,
                               incremental_recluster)

torch.set_num_threads(1)

TOL = dict(rtol=1e-12, atol=1e-12)


def _entry(fp, tag=0.0, tensor=False):
    n, k = fp.n, 3
    U = np.full((n, k), tag)
    return CacheEntry(U=torch.as_tensor(U) if tensor else U,
                      labels=np.zeros(n, np.int64), p_final=1.2, rcut=1.0,
                      fingerprint=fp)


def _graph(scale=1.0, n=12):
    i = np.arange(n - 1)
    return SparseMatrix.from_coo(np.r_[i, i + 1], np.r_[i + 1, i],
                                 np.full(2 * (n - 1), scale), (n, n),
                                 device="cpu")


def _port(ref, **layout):
    return convert.sparse_matrix(ref.host_coo(), (ref.n_rows, ref.n_cols),
                                 device="cpu", **layout)


def _dense(W):
    return W.to_dense().numpy()


# ------------------------------------------------------------- fingerprints

def test_fingerprint_identity_and_quantization():
    W = _graph()
    fp = W.fingerprint()
    assert (fp.n, fp.nnz) == (12, 22)
    assert fp == W.fingerprint()
    fp2 = _graph(scale=2.0).fingerprint()
    assert fp2.pattern_key == fp.pattern_key
    assert fp2.key != fp.key and fp2.weights != fp.weights
    # jitter below the quantum keeps the fingerprint
    Wj = W.with_vals(W.vals.double() + 1e-10)
    assert Wj.fingerprint(weight_quant=1e-6).key == \
        W.fingerprint(weight_quant=1e-6).key
    i = np.arange(10)
    Wp = SparseMatrix.from_coo(np.r_[i, i + 2], np.r_[i + 2, i],
                               np.ones(20), (12, 12), device="cpu")
    assert Wp.fingerprint().pattern_key != fp.pattern_key


def test_fingerprint_ignores_layouts_and_input_order():
    W = _graph()
    r, c, v = (a.copy() for a in W.host_coo())
    perm = np.random.default_rng(0).permutation(len(r))
    Ws = SparseMatrix.from_coo(r[perm], c[perm], v[perm], (12, 12),
                               device="cpu", build_sellcs=True, sell_c=4)
    assert Ws.fingerprint() == W.fingerprint()


# --------------------------------------------------------------- cache core

def test_cache_hit_miss_evict_lru():
    cache = WarmCache(capacity=2)
    fa, fb, fc = (_graph(s, n).fingerprint()
                  for s, n in [(1.0, 12), (1.0, 16), (1.0, 20)])
    assert cache.lookup(fa) == (None, None)
    assert cache.misses == 1
    cache.store(_entry(fa, 1.0))
    cache.store(_entry(fb, 2.0))
    ea, tier = cache.lookup(fa)                        # refresh fa
    assert tier == "exact" and ea.U[0, 0] == 1.0
    assert cache.hits_exact == 1
    cache.store(_entry(fc, 3.0))                       # evicts fb (LRU)
    assert cache.evictions == 1 and len(cache) == 2
    assert fa in cache and fc in cache and fb not in cache
    assert cache.lookup(fb) == (None, None)
    assert cache.stats() == {"size": 2, "capacity": 2, "hits_exact": 1,
                             "hits_pattern": 0, "misses": 2,
                             "evictions": 1, "rejects": 0}


def test_cache_pattern_tier_and_stale_index():
    cache = WarmCache(capacity=1)
    cache.store(_entry(_graph(1.0).fingerprint(), 7.0))
    entry, tier = cache.lookup(_graph(3.0).fingerprint())
    assert tier == "pattern" and entry.U[0, 0] == 7.0
    assert cache.hits_pattern == 1
    cache.store(_entry(_graph(1.0, n=16).fingerprint()))
    assert cache.lookup(_graph(3.0).fingerprint()) == (None, None)


def test_cache_peek_does_no_accounting():
    cache = WarmCache(capacity=4)
    fp = _graph().fingerprint()
    assert cache.peek(fp) is None
    cache.store(_entry(fp))
    assert cache.peek(fp) is not None
    assert cache.misses == 0 and cache.hits_exact == 0


def test_cache_capacity_validated():
    with pytest.raises(ValueError):
        WarmCache(capacity=0)


@pytest.mark.parametrize("tensor", [False, True])
def test_store_rejects_poisoned_entry(tensor):
    """A NaN or Inf embedding, array or tensor, never enters the cache;
    the earlier healthy entry survives."""
    cache = WarmCache(capacity=4)
    fp = _graph().fingerprint(1e-6)
    good = _entry(fp, tag=1.0, tensor=tensor)
    cache.store(good)
    cache.store(_entry(fp, tag=np.nan, tensor=tensor))
    cache.store(_entry(fp, tag=np.inf, tensor=tensor))
    cache.store(CacheEntry(U=None, labels=np.zeros(12, np.int64),
                           p_final=1.2, rcut=1.0, fingerprint=fp))
    assert cache.stats()["rejects"] == 3
    assert fp in cache and cache.peek(fp) is good
    cache.store(_entry(fp, tag=2.0, tensor=tensor))
    assert float(cache.peek(fp).U[0, 0]) == 2.0


# ---------------------------------------------------------------- EdgeDelta

def test_edge_delta_validation():
    with pytest.raises(ValueError, match="self-loops"):
        EdgeDelta(np.array([1]), np.array([1]), np.array([1.0]))
    with pytest.raises(ValueError, match="equal length"):
        EdgeDelta(np.array([1]), np.array([2, 3]), np.array([1.0]))
    d = EdgeDelta([0, 5], [3, 2], [1.0, 0.0])
    np.testing.assert_array_equal(d.touched, [0, 2, 3, 5])


def test_apply_edge_delta_out_of_range():
    with pytest.raises(ValueError, match="out of range"):
        apply_edge_delta(_graph(), EdgeDelta([0], [99], [1.0]))


def test_apply_edge_delta_weights_only_fast_path():
    W = _graph()
    before = _dense(W).copy()
    d = apply_edge_delta(W, EdgeDelta([0, 5], [1, 6], [4.0, 0.0]))
    assert not d.pattern_changed
    W2 = d.W
    assert W2.nnz == W.nnz
    assert W2.rows is W.rows and W2.cols is W.cols     # layout shared
    dense2 = _dense(W2)
    assert dense2[0, 1] == 4.0 and dense2[1, 0] == 4.0
    assert dense2[5, 6] == 0.0 and dense2[6, 5] == 0.0
    m = np.ones_like(before, bool)
    m[[0, 1, 5, 6], [1, 0, 6, 5]] = False
    np.testing.assert_array_equal(dense2[m], before[m])
    np.testing.assert_array_equal(_dense(W), before)   # W itself unchanged
    assert W2.fingerprint().pattern_key == W.fingerprint().pattern_key


def test_apply_edge_delta_reuses_the_sellcs_layout():
    """A weight-only delta keeps SELL-C-σ (its kernel copy regathered
    from the new values), so a sellcs solve runs on the edited graph."""
    W, _ = ring_of_cliques(4, 10, device="cpu", build_sellcs=True, sell_c=8)
    r, c, _ = W.host_coo()
    d = apply_edge_delta(W, EdgeDelta(r[:3], c[:3], [0.5, 0.25, 2.0]))
    assert not d.pattern_changed
    L = d.W.sell_kernel
    assert L is not None and L.cols is W.sell_kernel.cols
    assert d.W.sell_scatter is W.sell_scatter
    torch.testing.assert_close(L.vals, torch.cat(
        [d.W.vals, d.W.vals.new_zeros(1)])[L.scatter], rtol=0, atol=0)
    res = p_spectral_cluster(d.W, PSCConfig(k=4, backend="sellcs",
                                            newton_iters=5, tcg_iters=3))
    assert np.isfinite(res.rcut)


def test_apply_edge_delta_pattern_paths():
    W = _graph()
    d = apply_edge_delta(W, EdgeDelta([0], [7], [2.5]))
    assert d.pattern_changed and d.W.nnz == W.nnz + 2
    assert _dense(d.W)[7, 0] == 2.5
    d0 = apply_edge_delta(W, EdgeDelta([0], [7], [0.0]))
    assert d0.W.nnz == W.nnz
    assert d0.W.fingerprint().pattern_key == W.fingerprint().pattern_key
    dr = apply_edge_delta(W, EdgeDelta([3], [4], [0.0]), drop_removed=True)
    assert dr.pattern_changed and dr.W.nnz == W.nnz - 2
    assert dr.W.fingerprint().pattern_key != W.fingerprint().pattern_key


def test_apply_edge_delta_keeps_layouts_on_rebuild():
    W, _ = ring_of_cliques(4, 10, device="cpu", build_sellcs=True, sell_c=8)
    d = apply_edge_delta(W, EdgeDelta([0], [25], [0.7]))
    assert d.pattern_changed
    assert d.W.sell_kernel is not None and d.W.sell_c == 8


DELTAS = {
    "weights": (RefEdgeDelta, ([0, 5, 2], [1, 6, 3], [4.0, 0.0, 0.5]), {}),
    "insert": (RefEdgeDelta, ([0, 2, 9], [7, 11, 3], [2.5, 1.0, 3.0]), {}),
    "remove_missing": (RefEdgeDelta, ([0], [7], [0.0]), {}),
    "drop": (RefEdgeDelta, ([3, 0], [4, 9], [0.0, 1.5]),
             {"drop_removed": True}),
    "repeat": (RefEdgeDelta, ([1, 2, 1], [2, 1, 2], [5.0, 6.0, 7.0]), {}),
}


@pytest.mark.parametrize("name", sorted(DELTAS))
def test_apply_edge_delta_equals_reference(name):
    from repro.grblas.containers import SparseMatrix as RefMatrix

    ref_cls, (r, c, v), kw = DELTAS[name]
    rng = np.random.default_rng(7)
    i = np.arange(11)
    ref = RefMatrix.from_coo(np.r_[i, i + 1], np.r_[i + 1, i],
                             rng.uniform(0.5, 2.0, 22), (12, 12))
    W = _port(ref)
    got = apply_edge_delta(W, EdgeDelta(r, c, v), **kw)
    want = ref_apply(ref, ref_cls(r, c, v), **kw)
    assert got.pattern_changed == want.pattern_changed
    np.testing.assert_array_equal(got.touched, want.touched)
    for g, w in zip(got.W.host_coo(), want.W.host_coo()):
        np.testing.assert_array_equal(g, np.asarray(w))
    assert got.W.fingerprint() == tuple(want.W.fingerprint())


# ------------------------------------------------- hierarchy patching

def _ref_delaunay64():
    return ref_delaunay(9, seed=3, dtype=jnp.float64)[0]


def _edit(n, count, seed):
    rng = np.random.default_rng(seed)
    i = rng.integers(0, n, count)
    j = (i + 1 + rng.integers(0, n - 1, count)) % n
    return i, j, np.full(count, 2.0)


@pytest.mark.parametrize("sparsify", ["auto", None])
@pytest.mark.parametrize("kind", ["pattern", "weights"])
def test_patch_hierarchy_equals_reference(kind, sparsify):
    ref = _ref_delaunay64()
    W = _port(ref)
    hier = build_hierarchy(W, coarse_size=64, max_levels=4,
                           sparsify=sparsify)
    rhier = ref_build(ref, coarse_size=64, max_levels=4, sparsify=sparsify)
    if kind == "pattern":
        i, j, v = _edit(W.n_rows, 3, seed=0)
        d = apply_edge_delta(W, EdgeDelta(i, j, v))
        rd = ref_apply(ref, RefEdgeDelta(i, j, v))
        seed, rseed = d.touched, rd.touched
    else:
        d = apply_edge_delta(W, EdgeDelta(*_existing(W, 4)))
        rd = ref_apply(ref, RefEdgeDelta(*_existing(W, 4)))
        seed = rseed = np.empty(0, np.int64)
    assert d.pattern_changed == rd.pattern_changed == (kind == "pattern")
    patched, records = patch_hierarchy(hier, d.W, seed, sparsify=sparsify)
    rpatched, rrecords = ref_patch(rhier, rd.W, rseed, sparsify=sparsify)
    assert records == rrecords
    assert patched.n_levels == rpatched.n_levels == hier.n_levels
    for info, rinfo in zip(patched.infos, rpatched.infos):
        np.testing.assert_array_equal(info.agg, rinfo.agg)
        assert (info.n_fine, info.n_coarse) == (rinfo.n_fine, rinfo.n_coarse)
    for P, rP in zip(patched.prolongators, rpatched.prolongators):
        for g, w in zip(P.host_coo(), rP.host_coo()):
            np.testing.assert_array_equal(g, np.asarray(w))
    for lv, rlv in zip(patched.levels, rpatched.levels):
        (pr, pc, pv), (rr, rc, rv) = lv.W.host_coo(), rlv.W.host_coo()
        np.testing.assert_array_equal(pr, rr)
        np.testing.assert_array_equal(pc, rc)
        np.testing.assert_allclose(pv, rv, **TOL)
        np.testing.assert_allclose(lv.vol.numpy(), np.asarray(rlv.vol), **TOL)
        np.testing.assert_allclose(lv.counts.numpy(), np.asarray(rlv.counts),
                                   **TOL)


def _existing(W, count):
    """``count`` stored undirected pairs of W, reweighted to 1.7."""
    r, c, _ = W.host_coo()
    und = np.flatnonzero(r < c)[:count]
    return r[und].astype(np.int64), c[und].astype(np.int64), \
        np.full(count, 1.7)


def test_patch_hierarchy_invariants():
    """Patching after a local edit keeps the multilevel invariants
    (partition of unity, finest volume and count conservation) and
    reuses the aggregates away from the edit."""
    W, _ = delaunay_graph(9, seed=3, device="cpu")
    hier = build_hierarchy(W, coarse_size=64, max_levels=4)
    assert hier.n_levels >= 3
    d = apply_edge_delta(W, EdgeDelta(*_edit(W.n_rows, 3, seed=0)))
    assert d.pattern_changed
    patched, records = patch_hierarchy(hier, d.W, d.touched)
    assert patched.n_levels == hier.n_levels
    assert len(records) == hier.n_levels - 1
    total_vol = float(patched.levels[0].vol.sum())
    for lvl in range(patched.n_levels - 1):
        P = patched.prolongators[lvl]
        fine, coarse = patched.levels[lvl], patched.levels[lvl + 1]
        assert P.n_rows == fine.W.n_rows and P.n_cols == coarse.W.n_rows
        rows = P.rows.numpy()
        np.testing.assert_array_equal(np.sort(rows), np.arange(P.n_rows))
        assert bool((P.vals == 1.0).all())
        assert float(coarse.vol.sum()) == pytest.approx(total_vol, rel=1e-6)
        assert int(coarse.counts.sum()) == W.n_rows
        assert records[lvl]["n_dirty"] <= fine.W.n_rows
    assert records[0]["n_kept_aggregates"] >= 0.8 * records[0]["n_coarse"]
    assert records[0]["n_dirty"] < 0.2 * W.n_rows


def test_patch_hierarchy_empty_seed_reuses_everything():
    W, _ = delaunay_graph(9, seed=3, device="cpu")
    hier = build_hierarchy(W, coarse_size=64, max_levels=4)
    W2 = W.with_vals(W.vals * 1.7)
    patched, records = patch_hierarchy(hier, W2, np.empty(0, np.int64))
    for lvl, rec in enumerate(records):
        assert rec["n_rematched"] == 0
        assert rec["n_kept_aggregates"] == rec["n_coarse"]
        assert torch.equal(patched.prolongators[lvl].rows,
                           hier.prolongators[lvl].rows)
        assert torch.equal(patched.prolongators[lvl].cols,
                           hier.prolongators[lvl].cols)
    assert float(patched.coarsest.W.vals.sum()) == pytest.approx(
        1.7 * float(hier.coarsest.W.vals.sum()), rel=1e-5)
    with pytest.raises(ValueError, match="vertex count"):
        patch_hierarchy(hier, _graph(), np.empty(0, np.int64))


# ---------------------------------------------------------- warm entry

def test_warm_start_config_on_flat_pipeline():
    """``PSCConfig.init_U`` reproduces the cold solve's labels on an
    unchanged graph and runs only the schedule tail."""
    W, _ = ring_of_cliques(4, 10, device="cpu")
    cfg = PSCConfig(k=4, newton_iters=20, tcg_iters=12, kmeans_restarts=4)
    cold = p_spectral_cluster(W, cfg)
    warm = p_spectral_cluster(W, dataclasses.replace(cfg, init_U=cold.U))
    np.testing.assert_array_equal(warm.labels, cold.labels)
    assert warm.rcut == pytest.approx(cold.rcut, rel=1e-6)
    assert len(warm.p_path) == cfg.warm_p_steps == 1
    assert warm.p_path == cold.p_path[-1:]
    assert warm.init_labels is None and np.isnan(warm.init_rcut)
    assert warm.reports is not None and len(warm.reports) == 1
    assert "init" not in warm.stage_seconds
    # an array works as well as a tensor, and two tail steps run two levels
    warm2 = p_spectral_cluster(W, dataclasses.replace(
        cfg, init_U=cold.U.numpy(), warm_p_steps=2))
    assert warm2.p_path == cold.p_path[-2:]
    with pytest.raises(ValueError, match="init_U shape"):
        p_spectral_cluster(W, dataclasses.replace(cfg,
                                                  init_U=np.ones((40, 3))))


def test_warm_start_p_path_equals_reference():
    ref, _ = ref_sbm_graph([20, 20, 20], 0.5, 0.05, seed=3,
                           dtype=jnp.float64)
    W = _port(ref)
    U0 = np.linalg.qr(np.random.default_rng(0).standard_normal(
        (W.n_rows, 3)))[0]
    kw = dict(k=3, p_target=1.3, newton_iters=6, tcg_iters=4,
              kmeans_restarts=2, warm_p_steps=2)
    res = p_spectral_cluster(W, PSCConfig(init_U=U0, **kw))
    want = ref_cluster(ref, RefConfig(init_U=jnp.asarray(U0),
                                      reorder="none", **kw))
    assert res.p_path == want.p_path
    assert res.hvp_counts == list(want.hvp_counts)
    np.testing.assert_allclose(res.fvals, want.fvals, rtol=1e-8)


def test_warm_start_under_reorder_returns_callers_order():
    """Under ``reorder`` the warm embedding is permuted in and the result
    permuted back: labels equal the unreordered warm solve's."""
    W, _ = ring_of_cliques(4, 10, device="cpu")
    cfg = PSCConfig(k=4, newton_iters=10, tcg_iters=6, kmeans_restarts=4)
    cold = p_spectral_cluster(W, cfg)
    plain = p_spectral_cluster(W, dataclasses.replace(cfg, init_U=cold.U))
    rcm = p_spectral_cluster(W, dataclasses.replace(cfg, init_U=cold.U,
                                                    reorder="rcm"))
    assert rcm.rcut == pytest.approx(plain.rcut, rel=1e-5)
    from repro_torch.core import metrics

    assert metrics.clustering_accuracy(rcm.labels, plain.labels, 4) == 1.0


# ------------------------------------------------------- churn correctness

def _flip_edges(W, frac, seed):
    """Down-weight ``frac`` of the undirected edges to zero."""
    rng = np.random.default_rng(seed)
    r, c, _ = W.host_coo()
    und = np.flatnonzero(r < c)
    pick = rng.choice(und, max(1, int(frac * len(und))), replace=False)
    return EdgeDelta(r[pick], c[pick], np.zeros(len(pick)))


def test_incremental_recluster_flat_matches_scratch():
    """1% SBM edge churn: the warm re-entry lands within 2% RCut of a
    cold solve of the edited graph and reuses the pattern."""
    W, _ = sbm_graph([40, 40, 40, 40], 0.25, 0.02, seed=2, device="cpu")
    cfg = PSCConfig(k=4, newton_iters=20, tcg_iters=12, kmeans_restarts=4)
    base = p_spectral_cluster(W, cfg)
    d = apply_edge_delta(W, _flip_edges(W, 0.01, seed=3))
    assert not d.pattern_changed
    res, hier, records = incremental_recluster(
        d.W, d.touched, d.pattern_changed, base.U, cfg)
    assert hier is None and records == []
    scratch = p_spectral_cluster(d.W, cfg)
    assert res.rcut <= scratch.rcut * 1.02 + 1e-12
    assert len(res.p_path) <= cfg.warm_p_steps
    assert res.p_path[-1] == pytest.approx(scratch.p_path[-1])


@pytest.fixture(scope="module")
def ml_base():
    W, truth = sbm_graph([300] * 4, 0.06, 0.004, seed=1, device="cpu")
    ml = MultilevelConfig(coarse_size=120)
    cfg = PSCConfig(k=4, multilevel=ml)
    return W, ml, cfg, p_spectral_cluster(W, cfg)


def test_incremental_recluster_multilevel_patches_hierarchy(ml_base):
    """Pattern churn on the multilevel lane: the cached hierarchy is
    patched (a record a coarsened level) and the refined result stays
    within 2% RCut of a scratch multilevel solve."""
    W, ml, cfg, base = ml_base
    hier = build_hierarchy(W, coarse_size=ml.coarse_size)
    rng = np.random.default_rng(5)
    i = rng.integers(0, 600, 6)
    j = rng.integers(600, 1200, 6)
    d = apply_edge_delta(W, EdgeDelta(i, j, np.full(6, 0.5)))
    assert d.pattern_changed
    res, hier2, records = incremental_recluster(
        d.W, d.touched, d.pattern_changed, base.U, cfg, ml=ml,
        hierarchy=hier)
    assert hier2 is not None and len(records) == hier.n_levels - 1
    scratch = p_spectral_cluster(d.W, cfg)
    assert res.rcut <= scratch.rcut * 1.02 + 1e-12
    assert res.init_labels is None and np.isnan(res.init_rcut)
    assert set(res.stage_seconds) == {"restrict", "coarse_solve",
                                      "walk_up", "kmeans"}
    assert len(res.p_path) >= ml.refine_p_steps


def test_refine_cluster_checks_its_inputs(ml_base):
    W, ml, cfg, base = ml_base
    hier = build_hierarchy(W, coarse_size=ml.coarse_size)
    flat_cfg = dataclasses.replace(cfg, multilevel=None)
    with pytest.raises(ValueError, match="U0 shape"):
        refine_cluster(W, flat_cfg, ml, hier, np.ones((W.n_rows, 3)))
    small = build_hierarchy(_graph(n=12), coarse_size=4)
    with pytest.raises(ValueError, match="hierarchy does not match"):
        refine_cluster(W, flat_cfg, ml, small, base.U)


def test_engine_multilevel_churn_patches_the_cached_hierarchy(ml_base):
    """The solo lane with ``ml`` keeps the hierarchy of a cold V-cycle,
    and a pattern ``update`` patches it (mode churn)."""
    W, ml, cfg, _ = ml_base
    eng = ClusterServeEngine(dataclasses.replace(cfg, multilevel=None),
                             ml=ml, max_bucket_n=64)
    cold = eng.serve([W])[0]
    assert cold.stats.lane == "solo" and cold.ok
    entry = eng.cache.peek(W.fingerprint())
    assert entry is not None and entry.hierarchy is not None
    rng = np.random.default_rng(9)
    delta = EdgeDelta(rng.integers(0, 600, 4), rng.integers(600, 1200, 4),
                      np.full(4, 0.5))
    rid = eng.update(W, delta)
    res = eng.flush()[rid]
    assert res.ok and res.stats.mode == "churn"
    assert res.stats.cache_tier == "exact" and res.stats.lane == "solo"
    assert eng.cache.peek(apply_edge_delta(W, delta).W.fingerprint()) \
        .hierarchy is not None
