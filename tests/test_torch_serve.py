"""The port's clustering serve engine (``repro_torch.serve``) on the CPU,
against the reference where both compute the same thing.  Mirrors
``tests/test_psc_serve.py``, the serve parts of ``tests/test_obs.py``
and the serve isolation of ``tests/test_chaos.py``.

Held exactly to the reference: ``next_pow2`` / ``bucket_for``, the
fingerprint key, ``padded_coo``, ``assemble_batch`` and
``pad_embeddings`` (host numpy on both sides), and the build counts of a
mixed request stream (20 requests over 2 buckets: 2 builds, 3 batches,
16 ``trace_new``; a warm wave adds 1).  ``lobpcg_fixed``: its subspace
within a largest principal sine of 1e-8 of the reference's, float64.
The batched RTR: each element's iterations and HVPs equal the flat
``rtr_minimize``'s on that graph, U within 1e-9 and F_p within 1e-9
relative, float64 (the batch sums its edge terms with the pads
interleaved, so the last bits differ).  Served
labels equal the port's flat ``p_spectral_cluster`` labels on the bare
graph (both drivers, flat on ``coo`` and on ``sellcs``), and the served
RCut is at most 1.05 x the reference engine's on the same graph
(``torch.Generator`` and ``jax.random`` streams differ, so the two
engines are held by quality, not label for label)."""
import dataclasses
import functools
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the reference-only CI has no torch

import jax.numpy as jnp
from repro.core import PSCConfig as RefConfig
from repro.core import lobpcg as ref_lobpcg
from repro.graphs import delaunay_graph as ref_delaunay
from repro.graphs import ring_of_cliques as ref_ring_of_cliques
from repro.graphs import sbm_graph as ref_sbm_graph
from repro.serve import ClusterServeEngine as RefEngine
from repro.serve import bucketing as ref_bucketing
from repro_torch import convert
from repro_torch.core import lobpcg, plap
from repro_torch.core.grassmann import rtr_minimize, rtr_minimize_batched
from repro_torch.core.psc import PSCConfig, p_spectral_cluster
from repro_torch.core.solvers import registry
from repro_torch.grblas import Descriptor, SparseMatrix
from repro_torch.graphs import ring_of_cliques, sbm_graph
from repro_torch.kernels.nvcc import KernelError
from repro_torch.obs import (DEFAULT, RetraceDetector, RetraceError,
                             assert_no_retrace)
from repro_torch.serve import (BucketSpec, ClusterServeEngine, EdgeDelta,
                               apply_edge_delta, assemble_batch, bucket_for,
                               next_pow2)
from repro_torch.serve import psc_engine
from repro_torch.serve.bucketing import pad_embeddings
from repro_torch.testing import serve_batch_fault, serve_churn_fault

torch.set_num_threads(1)

_COO = Descriptor(backend="coo")


def _cfg(**kw):
    kw.setdefault("k", 4)
    kw.setdefault("newton_iters", 20)
    kw.setdefault("tcg_iters", 12)
    kw.setdefault("kmeans_restarts", 4)
    return PSCConfig(**kw)


def _ring(n_cliques=4, size=10, **kw):
    return ring_of_cliques(n_cliques, size, device="cpu", **kw)[0]


def _reweighted(W, scale):
    """Same pattern, other quantized weights (a fresh fingerprint)."""
    return W.with_vals(W.vals * scale)


def _port(ref, **layout):
    return convert.sparse_matrix(ref.host_coo(), (ref.n_rows, ref.n_cols),
                                 device="cpu", **layout)


def _sin_theta(A, B):
    """Largest principal sine between the column spaces of A and B."""
    Qa = np.linalg.qr(A)[0]
    Qb = np.linalg.qr(B)[0]
    return float(np.linalg.norm(Qb - Qa @ (Qa.T @ Qb), 2))


# ------------------------------------------------------------ bucketing

def test_next_pow2():
    assert next_pow2(1) == 1
    assert next_pow2(2) == 2
    assert next_pow2(3) == 4
    assert next_pow2(1025) == 2048
    assert next_pow2(3, floor=64) == 64
    assert next_pow2(0) == 1
    for x in (0, 1, 7, 64, 65, 1000, 4097):
        assert next_pow2(x, 16) == ref_bucketing.next_pow2(x, 16)


def test_bucket_for_lattice_and_floors():
    W = _ring()                             # n=40, nnz=368
    spec = bucket_for(W, 4, "cold")
    assert spec == BucketSpec(n=64, nnz=512, k=4, mode="cold")
    assert spec.key == ("serve", "cold", 64, 512, 4)
    assert spec.key == ref_bucketing.bucket_for(
        ref_ring_of_cliques(4, 10)[0], 4, "cold").key
    tiny = SparseMatrix.from_coo([0, 1], [1, 0], [1.0, 1.0], (2, 2),
                                 device="cpu")
    spec = bucket_for(tiny, 2, "warm")
    assert (spec.n, spec.nnz) == (64, 128)
    rect = SparseMatrix.from_coo([0], [1], [1.0], (2, 3), device="cpu")
    with pytest.raises(ValueError, match="square"):
        bucket_for(rect, 2, "cold")


REF_GRAPHS = {
    "cliques": lambda: ref_ring_of_cliques(4, 10)[0],
    "sbm64": lambda: ref_sbm_graph([20, 25, 30], 0.4, 0.05, seed=1,
                                   dtype=jnp.float64)[0],
    "delaunay": lambda: ref_delaunay(8, seed=2)[0],
}


@pytest.mark.parametrize("quant", [1e-6, 1e-3])
@pytest.mark.parametrize("name", sorted(REF_GRAPHS))
def test_fingerprint_equals_reference(name, quant):
    ref = REF_GRAPHS[name]()
    W = _port(ref)
    fp, want = W.fingerprint(quant), ref.fingerprint(quant)
    assert fp == tuple(want)
    assert fp.key == want.key and fp.pattern_key == want.pattern_key
    # a reweighted copy: same pattern digest on both sides, a new key
    W2 = _reweighted(W, 1.5)
    ref2 = ref.with_vals(jnp.asarray(ref.vals) * 1.5)
    assert W2.fingerprint(quant) == tuple(ref2.fingerprint(quant))
    assert W2.fingerprint(quant).pattern_key == fp.pattern_key
    assert W2.fingerprint(quant).key != fp.key


def test_fingerprint_of_non_finite_weights_equals_reference():
    ref = REF_GRAPHS["cliques"]()
    r, c, v = ref.host_coo()
    v = np.array(v)
    v[0], v[5], v[9] = np.nan, np.inf, -np.inf
    from repro.grblas.containers import SparseMatrix as RefMatrix

    bad = RefMatrix.from_coo(r, c, v, (ref.n_rows, ref.n_rows))
    assert _port(bad).fingerprint() == tuple(bad.fingerprint())


@pytest.mark.parametrize("name", sorted(REF_GRAPHS))
def test_padded_coo_equals_reference(name):
    ref = REF_GRAPHS[name]()
    W = _port(ref)
    n_b, nnz_b = next_pow2(W.n_rows, 64), next_pow2(W.nnz, 128)
    got, want = W.padded_coo(n_b, nnz_b), ref.padded_coo(n_b, nnz_b)
    for g, w in zip(got, want):
        assert g.dtype == np.asarray(w).dtype
        np.testing.assert_array_equal(g, np.asarray(w))
    r, c, v = got
    assert (r[W.nnz:] == 0).all() and (c[W.nnz:] == 0).all()
    assert (v[W.nnz:] == 0.0).all()
    with pytest.raises(ValueError):
        W.padded_coo(W.n_rows - 1, nnz_b)          # n does not fit
    with pytest.raises(ValueError):
        W.padded_coo(n_b, W.nnz - 1)               # nnz does not fit


def test_assemble_batch_equals_reference():
    refs = [ref_ring_of_cliques(4, 10)[0], ref_ring_of_cliques(4, 6)[0],
            ref_sbm_graph([15, 15], 0.3, 0.05, seed=4)[0]]
    spec = BucketSpec(n=64, nnz=512, k=4, mode="cold")
    got = assemble_batch([_port(r) for r in refs], spec)
    want = ref_bucketing.assemble_batch(refs, ref_bucketing.BucketSpec(
        *spec))
    for name in ("rows", "cols", "vals", "mask"):
        g, w = getattr(got, name), np.asarray(getattr(want, name))
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    assert got.n_real == want.n_real == (40, 24, 30)


def test_pad_embeddings_equals_reference_and_validates():
    spec = BucketSpec(n=64, nnz=128, k=4, mode="warm")
    rng = np.random.default_rng(0)
    Us = [rng.standard_normal((40, 4)), rng.standard_normal((64, 4))]
    want = ref_bucketing.pad_embeddings(Us, ref_bucketing.BucketSpec(*spec))
    got = pad_embeddings(Us, spec)
    np.testing.assert_array_equal(got, np.asarray(want))
    # a tensor embedding pads the same as its array
    np.testing.assert_array_equal(
        pad_embeddings([torch.as_tensor(u) for u in Us], spec), got)
    assert (got[0, 40:] == 0.0).all()
    with pytest.raises(ValueError):
        pad_embeddings([np.ones((40, 3))], spec)       # wrong k
    with pytest.raises(ValueError):
        pad_embeddings([np.ones((100, 4))], spec)      # does not fit n


# ------------------------------------------------------------ lobpcg_fixed

def test_lobpcg_fixed_matches_reference():
    ref = REF_GRAPHS["sbm64"]()
    W = _port(ref)
    n, k, m = W.n_rows, 3, 6
    X0 = np.random.default_rng(5).standard_normal((n, m))
    deg = W.row_sums()
    ev, X = lobpcg.lobpcg_fixed(lobpcg.laplacian_matvec(W),
                                convert.tensor(X0, device="cpu"), k,
                                iters=30, precond_diag=deg)
    rev, rX = ref_lobpcg.lobpcg_fixed(ref_lobpcg.laplacian_matvec(ref),
                                      jnp.asarray(X0), k, iters=30,
                                      precond_diag=ref.row_sums())
    assert X.shape == (n, k) and ev.shape == (k,)
    np.testing.assert_allclose(convert.to_numpy(ev), np.asarray(rev),
                               rtol=1e-8, atol=1e-10)
    assert _sin_theta(convert.to_numpy(X), np.asarray(rX)) <= 1e-8


def test_lobpcg_fixed_keeps_zero_rows_exactly_zero():
    """Pad rows: an isolated vertex's zero start row stays exactly zero
    through every step (the soundness of bucket padding)."""
    W = _ring()
    r, c, v = W.padded_coo(64, 512)
    Wp = SparseMatrix.from_coo(r, c, v, (64, 64), dtype=torch.float64,
                               device="cpu")
    X0 = torch.as_tensor(np.random.default_rng(1).standard_normal((64, 6)))
    X0[40:] = 0.0
    _, X = lobpcg.lobpcg_fixed(lobpcg.laplacian_matvec(Wp), X0, 4, iters=10)
    assert bool((X[40:] == 0.0).all())
    assert bool(torch.isfinite(X).all())


# ---------------------------------------------------- batched RTR vs flat

def _block_graph(graphs, n_b, nnz_b, dtype=torch.float64):
    """The bucket solve's block-diagonal graph of ``graphs``, in float64."""
    spec = BucketSpec(n=n_b, nnz=nnz_b, k=4, mode="cold")
    solve = psc_engine._BucketSolve(spec, _cfg(), ("test-rtr",))
    padded = [W.padded_coo(n_b, nnz_b) for W in graphs]
    rows, cols, vals = (torch.as_tensor(np.stack([p[i] for p in padded]))
                        for i in range(3))
    mask = torch.zeros((len(graphs), n_b), dtype=dtype)
    for b, W in enumerate(graphs):
        mask[b, :W.n_rows] = 1.0
    return solve.graph(rows, cols, vals.to(dtype), mask)


@pytest.mark.parametrize("mode", ["graphblas", "matrix_free"])
def test_rtr_minimize_batched_matches_flat_per_element(mode):
    """Each element of a batch follows the flat solver's trajectory on
    its own graph: same iterations and HVPs, U within 1e-9 (float64,
    n_b = n so no pad row changes the denominators)."""
    graphs = [sbm_graph([10, 10, 12], 0.6, 0.08, seed=s, device="cpu",
                        dtype=torch.float64)[0] for s in range(3)]
    n, p, eps = 32, 1.5, 1e-8
    nnz_b = next_pow2(max(W.nnz for W in graphs))
    G = _block_graph(graphs, n, nnz_b)
    rng = np.random.default_rng(2)
    U0 = torch.stack([torch.linalg.qr(torch.as_tensor(
        rng.standard_normal((n, 3))))[0] for _ in graphs])
    bhvp = {"graphblas": plap.batched_hess_eta_graphblas,
            "matrix_free": plap.batched_hess_eta_matrix_free}[mode]
    fhvp = {"graphblas": plap.hess_eta_graphblas,
            "matrix_free": plap.hess_eta_matrix_free}[mode]
    res = rtr_minimize_batched(
        lambda V: plap.batched_value(G.W, V, p, eps, desc=_COO),
        lambda V: plap.batched_euc_grad(G.W, V, p, eps, desc=_COO),
        lambda V, e: bhvp(G.W, V, e, p, eps, desc=_COO),
        U0, max_iters=12, tcg_iters=8, grad_tol=1e-9)
    for b, W in enumerate(graphs):
        flat = rtr_minimize(
            lambda V: plap.value(W, V, p, eps, desc=_COO),
            lambda V: plap.euc_grad(W, V, p, eps, desc=_COO),
            lambda V, e: fhvp(W, V, e, p, eps, desc=_COO),
            U0[b], max_iters=12, tcg_iters=8, grad_tol=1e-9)
        assert int(res.iters[b]) == flat.iters
        assert int(res.n_hvp[b]) == flat.n_hvp
        np.testing.assert_allclose(convert.to_numpy(res.U[b]),
                                   convert.to_numpy(flat.U), atol=1e-9)
        assert float(res.fval[b]) == pytest.approx(float(flat.fval),
                                                   rel=1e-9)


def test_rtr_minimize_batched_freezes_finished_elements():
    """An element that starts below grad_tol (a converged flat solve)
    runs no iteration and keeps its U bit for bit, while the other
    element of the batch iterates."""
    from repro_torch.core.grassmann import proj_batched

    W = _ring(dtype=torch.float64)
    G = _block_graph([W, W], 40, 512)
    p, eps = 1.4, 1e-8
    U_rand = torch.linalg.qr(torch.as_tensor(
        np.random.default_rng(3).standard_normal((40, 4))))[0]
    conv = rtr_minimize(
        lambda V: plap.value(W, V, p, eps, desc=_COO),
        lambda V: plap.euc_grad(W, V, p, eps, desc=_COO),
        lambda V, e: plap.hess_eta_matrix_free(W, V, e, p, eps, desc=_COO),
        U_rand, max_iters=40, tcg_iters=20, grad_tol=1e-10)
    U = torch.stack([U_rand, conv.U])
    gn = torch.linalg.vector_norm(
        proj_batched(U, plap.batched_euc_grad(G.W, U, p, eps, desc=_COO)),
        dim=(1, 2))
    tol = float(torch.sqrt(gn[0] * gn[1]))
    assert float(gn[1]) < tol < float(gn[0])
    res = rtr_minimize_batched(
        lambda V: plap.batched_value(G.W, V, p, eps, desc=_COO),
        lambda V: plap.batched_euc_grad(G.W, V, p, eps, desc=_COO),
        lambda V, e: plap.batched_hess_eta_matrix_free(G.W, V, e, p, eps,
                                                       desc=_COO),
        U, max_iters=3, tcg_iters=4, grad_tol=tol)
    assert int(res.iters[0]) >= 1 and int(res.n_hvp[0]) >= 2
    assert int(res.iters[1]) == 0 and int(res.n_hvp[1]) == 0
    assert torch.equal(res.U[1], U[1])


# ----------------------------------------------- bucket lane against flat

@functools.lru_cache(maxsize=None)
def _reference_rcut(solver):
    W, _ = ref_ring_of_cliques(4, 10)
    eng = RefEngine(RefConfig(k=4, reorder="none", newton_iters=20,
                              tcg_iters=12, kmeans_restarts=4,
                              solver=solver))
    return float(eng.serve([W])[0].rcut)


@pytest.mark.parametrize("solver", ["newton", "scf"])
@pytest.mark.parametrize("flat_backend", ["coo", "sellcs"])
def test_bucketed_solve_matches_flat(solver, flat_backend):
    """A padded, batched bucket solve returns the labels and RCut of the
    flat pipeline on the bare graph, for both bucketable drivers and
    against flat solves on coo and on SELL-C-σ (the Algorithm-1
    multivalue path under the default graphblas HVP)."""
    W = _ring(build_sellcs=flat_backend == "sellcs")
    cfg = _cfg(solver=solver, backend=flat_backend)
    flat = p_spectral_cluster(W, cfg)
    eng = ClusterServeEngine(dataclasses.replace(cfg, backend="auto"))
    res = eng.serve([W])[0]
    np.testing.assert_array_equal(res.labels, flat.labels)
    assert res.rcut == pytest.approx(flat.rcut, rel=1e-6)
    assert res.stats.lane == "bucket" and res.stats.mode == "cold"
    assert res.stats.bucket == ("serve", "cold", 64, 512, 4)
    assert res.rcut <= _reference_rcut(solver) * 1.05 + 1e-9


def test_built_solve_pad_rows_exact_zero_and_deterministic():
    """A direct call of a bucket's built solve: pad rows of U exactly
    zero, and two calls on the same batch equal bit for bit."""
    cfg = _cfg(newton_iters=6, tcg_iters=4)
    graphs = [_ring(), _ring(4, 6), _ring(3, 9)]
    spec = BucketSpec(n=64, nnz=512, k=4, mode="cold")
    solve, key = psc_engine._bucket_solver(spec, cfg)
    batch = assemble_batch(graphs, spec)
    args = [torch.as_tensor(a) for a in (batch.rows, batch.cols, batch.vals,
                                          batch.mask)]
    U1, f1 = solve(*args)
    U2, f2 = solve(*args)
    assert U1.shape == (3, 64, 4) and f1.shape == (3, 5)
    for b, n in enumerate(batch.n_real):
        assert bool((U1[b, n:] == 0.0).all())
    assert torch.equal(U1, U2) and torch.equal(f1, f2)
    assert bool(torch.isfinite(U1).all())


def test_block_diagonal_graph_layout():
    """The batch matrix: element blocks in place, rows grouped, pads just
    after row 0's real entries, CSR pointers of the sorted rows."""
    graphs = [_ring(), _ring(4, 6)]
    spec = BucketSpec(n=64, nnz=512, k=4, mode="cold")
    solve, _ = psc_engine._bucket_solver(spec, _cfg())
    batch = assemble_batch(graphs, spec)
    G = solve.graph(*(torch.as_tensor(a) for a in (
        batch.rows, batch.cols, batch.vals, batch.mask)))
    rows, cols = G.W.rows.long(), G.W.cols.long()
    assert G.W.n_rows == 128 and G.W.nnz == 1024
    assert bool((rows[1:] >= rows[:-1]).all())
    for b, W in enumerate(graphs):
        blk = slice(b * 512, (b + 1) * 512)
        assert bool(((rows[blk] // 64) == b).all())
        assert bool(((cols[blk] // 64) == b).all())
        assert float(G.W.vals[blk].sum()) == pytest.approx(
            float(W.vals.sum()))
        n0 = int((W.rows == 0).sum())        # row 0's real entries
        pads = 512 - W.nnz
        seg = G.W.vals[blk][n0:n0 + pads]
        assert bool((seg == 0.0).all()) and bool(
            (rows[blk][:n0 + pads] == b * 64).all())
    torch.testing.assert_close(
        G.W.row_ptr, torch.searchsorted(rows, torch.arange(129)))


def test_solo_lane_matches_flat_exactly():
    """A bucket cap below the graph forces the solo lane, which is the
    flat pipeline: the same result bit for bit."""
    W = _ring()
    cfg = _cfg()
    flat = p_spectral_cluster(W, cfg)
    eng = ClusterServeEngine(cfg, max_bucket_n=16)
    res = eng.serve([W])[0]
    assert res.stats.lane == "solo"
    np.testing.assert_array_equal(res.labels, flat.labels)
    assert res.rcut == flat.rcut
    assert torch.equal(res.U, flat.U)
    assert eng.stats.n_solo == 1


def test_unbucketable_solver_routes_solo():
    W = _ring()
    cfg = _cfg(solver="inverse_power", p_target=1.2, ipm_iters=40)
    eng = ClusterServeEngine(cfg)
    res = eng.serve([W])[0]
    assert res.stats.lane == "solo"
    assert len(np.unique(res.labels)) == 4


def test_trivial_k_routes_solo():
    W = _ring()
    eng = ClusterServeEngine(_cfg())
    r1, rn = eng.serve([W], k=1)[0], eng.serve([W], k=W.n_rows)[0]
    assert r1.stats.lane == rn.stats.lane == "solo"
    assert (r1.labels == 0).all()
    np.testing.assert_array_equal(rn.labels, np.arange(W.n_rows))


# --------------------------------------------------------- build accounting

def test_one_build_per_bucket_mixed_stream():
    """20 mixed cold requests over two buckets make exactly two builds
    (one per bucket), three batches and 16 ``trace_new`` flags — the
    reference's counts; a warm wave on fresh weights adds one build."""
    Wa = _ring()                            # bucket (64, 512)
    Wb = _ring(4, 6)                        # bucket (64, 128)
    # a solver signature no other test uses: the memo is global
    cfg = _cfg(solver="scf", scf_sweeps=7, grad_tol=1.07e-5)
    eng = ClusterServeEngine(cfg, max_batch=8)
    rids = [eng.submit(_reweighted(Wa, 1.0 + 0.01 * i)) for i in range(12)]
    rids += [eng.submit(_reweighted(Wb, 1.0 + 0.01 * i)) for i in range(8)]

    def serve_builds():
        return sum(1 for t in registry.SOLVER_TRACES
                   if t and t[0] == "serve" and 1.07e-5 in t)

    before = serve_builds()
    det = RetraceDetector()
    done = eng.flush()
    assert len(done) == 20
    assert serve_builds() - before == 2
    assert eng.stats.traces == 2
    assert eng.stats.n_batches == 3         # ceil(12/8) + ceil(8/8)
    assert sum(done[r].stats.trace_new for r in rids) == 8 + 8
    assert sorted(det.serve_buckets().values()) == [1, 1]
    more = [eng.submit(_reweighted(Wa, 2.0 + 0.01 * i)) for i in range(8)]
    done = eng.flush()
    assert serve_builds() - before == 3
    assert eng.stats.traces == 3
    assert all(done[r].stats.mode == "warm" for r in more)
    assert all(done[r].stats.cache_tier == "pattern" for r in more)
    det.assert_at_most(1)


def test_partial_batch_reuses_the_build():
    """A deadline launch of a partial batch runs on the full batch's
    build (the batch axis is padded to max_batch)."""
    W = _ring()
    cfg = _cfg(newton_iters=5, tcg_iters=3, grad_tol=1.13e-5)
    eng = ClusterServeEngine(cfg, max_batch=4, max_wait_s=0.0)
    eng.serve([_reweighted(W, 1.0 + 0.01 * i) for i in range(4)])
    other = _ring(4, 9)            # another pattern in bucket (64, 512)
    with assert_no_retrace():
        res = eng.serve([other])[0]
    assert res.stats.mode == "cold"
    assert res.stats.bucket == ("serve", "cold", 64, 512, 4)
    assert res.stats.batch_size == 1 and not res.stats.trace_new


# ----------------------------------------------------------- warm-start path

def test_warm_exact_hit_reproduces_labels():
    W = _ring()
    eng = ClusterServeEngine(_cfg())
    cold = eng.serve([W])[0]
    assert cold.stats.mode == "cold" and cold.stats.cache_tier is None
    warm = eng.serve([W])[0]
    assert warm.stats.mode == "warm"
    assert warm.stats.cache_tier == "exact"
    assert warm.stats.bucket[1] == "warm"   # its own build signature
    np.testing.assert_array_equal(warm.labels, cold.labels)
    assert warm.rcut == pytest.approx(cold.rcut, rel=1e-6)
    assert eng.cache.hits_exact == 1


def test_warm_pattern_tier_on_reweighted_graph():
    W = _ring()
    eng = ClusterServeEngine(_cfg())
    cold = eng.serve([W])[0]
    res = eng.serve([_reweighted(W, 1.5)])[0]
    assert res.stats.mode == "warm"
    assert res.stats.cache_tier == "pattern"
    # uniform scaling keeps the optimal partition
    np.testing.assert_array_equal(res.labels, cold.labels)
    assert eng.cache.hits_pattern == 1


# ----------------------------------------------------- queueing, admission

def test_poll_respects_deadline_and_batch_trigger():
    W = _ring()
    eng = ClusterServeEngine(_cfg(), max_batch=4, max_wait_s=3600.0)
    rid = eng.submit(W)
    assert eng.poll() == {}                 # not due: the queue stays open
    more = [eng.submit(_reweighted(W, 1.0 + 0.01 * i)) for i in range(3)]
    done = eng.poll()                       # a full bucket launches
    assert set(done) == {rid, *more}
    assert done[rid].stats.batch_size == 4
    late = eng.submit(_reweighted(W, 9.0))
    assert late not in eng.poll()
    done = eng.poll(now=time.monotonic() + 3601.0)
    assert late in done and done[late].stats.batch_size == 1


def test_flush_drains_and_take_pops():
    W = _ring()
    eng = ClusterServeEngine(_cfg(), max_batch=8, max_wait_s=3600.0)
    rids = [eng.submit(_reweighted(W, 1.0 + 0.01 * i)) for i in range(3)]
    done = eng.flush()
    assert set(done) == set(rids)
    first = eng.take(rids[0])
    assert first.req_id == rids[0]
    with pytest.raises(KeyError):
        eng.take(rids[0])
    assert eng.stats.n_requests == 3 and eng.stats.n_results == 3


def test_serve_returns_submission_order():
    Wa, Wb = _ring(), _ring(4, 6)
    eng = ClusterServeEngine(_cfg())
    out = eng.serve([Wa, Wb, _reweighted(Wa, 1.1)])
    assert [r.stats.n for r in out] == [40, 24, 40]
    assert [r.req_id for r in out] == sorted(r.req_id for r in out)


def test_engine_rejects_reordering_config():
    with pytest.raises(ValueError, match="reorder"):
        ClusterServeEngine(_cfg(reorder="rcm"))


def test_engine_update_churn_close_to_scratch():
    """update() on a served graph takes the churn path and lands within
    2% RCut of a scratch solve of the edited graph."""
    W, _ = sbm_graph([40, 40, 40, 40], 0.25, 0.02, seed=0, device="cpu")
    cfg = _cfg()
    eng = ClusterServeEngine(cfg)
    eng.serve([W])                                    # prime the cache
    rng = np.random.default_rng(1)
    r, c, _ = W.host_coo()
    ei = np.flatnonzero(r < c)
    pick = rng.choice(ei, max(1, int(0.01 * len(ei))), replace=False)
    delta = EdgeDelta(r[pick], c[pick], np.zeros(len(pick)))
    rid = eng.update(W, delta)
    res = eng.flush()[rid]
    assert res.stats.mode == "churn"
    assert eng.stats.n_churn == 1
    scratch = p_spectral_cluster(apply_edge_delta(W, delta).W, cfg)
    assert res.rcut <= scratch.rcut * 1.02 + 1e-12


# ------------------------------------------------- stat views and retrace

def test_engine_stats_and_cache_share_one_registry():
    cfg = _cfg(newton_iters=6, tcg_iters=4)
    eng = ClusterServeEngine(cfg, max_batch=4)
    W = _ring()
    eng.serve([W])
    eng.serve([W])                           # exact-tier warm hit
    assert eng.cache.metrics is eng.metrics
    assert eng.stats.registry is eng.metrics
    assert eng.stats.n_requests == 2
    assert eng.metrics.value("serve_requests_total") == 2
    assert eng.cache.hits_exact == 1
    assert eng.metrics.value("warm_cache_hits_total", tier="exact") == 1
    assert eng.cache.stats()["misses"] == 1
    eng.stats.n_churn += 1                   # a view write lands on the counter
    assert eng.metrics.value("serve_churn_total") == 1
    eng.stats.record_failure("exception")
    assert eng.stats.n_failed == 1
    assert eng.stats.failures == {"exception": 1}
    d = eng.stats.as_dict()
    assert d["n_failed"] == 1 and d["failures"] == {"exception": 1}
    assert list(d)[:3] == ["n_requests", "n_results", "n_batches"]
    snap = eng.metrics.snapshot()
    assert snap["serve_queue_depth"] == 0.0
    assert snap["serve_batch_occupancy_count"] == 2.0
    text = eng.exposition()
    assert "serve_requests_total 2" in text
    assert 'warm_cache_hits_total{tier="exact"} 1' in text


def test_retrace_detector_catches_a_bucket_buster():
    cfg = _cfg(newton_iters=5, tcg_iters=3)
    eng = ClusterServeEngine(cfg, max_batch=4)
    Wa = _ring()                             # bucket (64, 512)
    det = RetraceDetector()
    compiles0 = DEFAULT.value("compiles_total", site="serve")
    eng.serve([Wa])                          # the cold build
    eng.serve([Wa])                          # the warm build (exact hit)
    per_key = det.serve_buckets()
    assert len(per_key) == 2 and all(v == 1 for v in per_key.values())
    det.assert_at_most(1)
    with assert_no_retrace():                # steady state: no build
        eng.serve([Wa])
    Wb = _ring(4, 6)                         # bucket (64, 128): a new build
    with pytest.raises(RetraceError, match="retrace detected"):
        with assert_no_retrace():
            eng.serve([Wb])
    assert DEFAULT.value("compiles_total", site="serve") >= compiles0 + 3
    assert det.by_site().get("serve", 0) >= 3


def test_build_stamps_a_compile_instant_and_calls_listeners():
    from repro_torch.obs import TraceConfig, Tracer, use

    seen = []
    registry.TRACE_LISTENERS.append(seen.append)
    tr = Tracer(TraceConfig())
    try:
        with use(tr):
            eng = ClusterServeEngine(_cfg(newton_iters=4, tcg_iters=2,
                                          grad_tol=1.19e-5))
            eng.serve([_ring()])
    finally:
        registry.TRACE_LISTENERS.remove(seen.append)
    assert len(seen) == 1 and seen[0][0] == "serve"
    compiles = [e for e in tr.events if e["name"] == "compile"]
    assert [e["attrs"]["site"] for e in compiles] == ["serve"]
    names = {s.name for s in tr.spans}
    assert "serve.bucket_solve" in names


# ---------------------------------------------------------- serve isolation

@pytest.fixture(scope="module")
def serve_graphs():
    return [sbm_graph([20] * 4, 0.9, 0.05, seed=s, device="cpu")[0]
            for s in range(4)]


@pytest.fixture(scope="module")
def serve_cfg():
    return PSCConfig(k=4, newton_iters=6, tcg_iters=4, p_target=1.5,
                     p_factor=0.85)


@pytest.fixture(scope="module")
def clean_serve(serve_cfg, serve_graphs):
    eng = ClusterServeEngine(serve_cfg, max_batch=4, max_wait_s=0.0)
    return eng.serve(serve_graphs)


def _with_nan(W, at=0, value=np.nan):
    r, c, v = W.host_coo()
    v = np.array(v)
    v[at] = value
    return SparseMatrix.from_coo(r, c, v, (W.n_rows, W.n_rows), device="cpu")


def test_poisoned_request_isolated_in_batch(serve_cfg, serve_graphs,
                                            clean_serve):
    """One NaN-weighted request in a full batch gets a structured error;
    every other request returns a clean engine's labels."""
    gs = list(serve_graphs)
    gs[1] = _with_nan(gs[1])
    eng = ClusterServeEngine(serve_cfg, max_batch=4, max_wait_s=0.0)
    res = eng.serve(gs)
    assert not res[1].ok
    assert res[1].labels is None
    assert res[1].stats.failure_kind == "nonfinite_result"
    assert "non-finite" in res[1].error
    for i in (0, 2, 3):
        assert res[i].ok
        np.testing.assert_array_equal(res[i].labels, clean_serve[i].labels)
    assert eng.stats.n_failed == 1
    assert eng.stats.n_quarantined == 1
    assert eng.stats.failures == {"nonfinite_result": 1}


def test_thrown_batch_bisects_to_culprit(serve_cfg, serve_graphs,
                                         clean_serve):
    """A batch solve that throws bisects: the survivors re-run and
    succeed, exactly the faulted request fails."""
    eng = ClusterServeEngine(serve_cfg, max_batch=4, max_wait_s=0.0)
    rids = [eng.submit(W) for W in serve_graphs]
    with serve_batch_fault([rids[2]]) as log:
        done = eng.flush()
    assert log.count("serve_batch_fault") >= 2      # full batch and halves
    assert not done[rids[2]].ok
    assert done[rids[2]].stats.failure_kind == "exception"
    for i in (0, 1, 3):
        assert done[rids[i]].ok
        np.testing.assert_array_equal(done[rids[i]].labels,
                                      clean_serve[i].labels)
    assert eng.stats.n_quarantine_splits >= 1
    assert eng.stats.n_quarantined == 1


def test_admission_validation_rejects_invalid(serve_cfg, serve_graphs):
    bad = _with_nan(serve_graphs[0], at=3, value=np.inf)
    eng = ClusterServeEngine(serve_cfg, validate_inputs=True)
    rid_bad = eng.submit(bad)
    rid_ok = eng.submit(serve_graphs[0])
    done = eng.flush()
    assert not done[rid_bad].ok
    assert done[rid_bad].stats.failure_kind == "invalid_input"
    assert done[rid_bad].stats.lane == "admission"
    assert done[rid_ok].ok
    with pytest.raises(ValueError, match="k="):
        eng.submit(serve_graphs[0], k=0)


def test_deadline_degrade_levels(serve_cfg, serve_graphs):
    """Past tail_frac x deadline a cold request degrades to the
    schedule-tail-only solve (level 1); past the deadline to p=2-init
    labels (level 2)."""
    now = time.monotonic()
    eng = ClusterServeEngine(serve_cfg, max_batch=8, max_wait_s=100.0,
                             deadline_s=10.0, tail_frac=0.5)
    rid1 = eng.submit(serve_graphs[0])
    done = eng.poll(now=now + 7.0)
    assert done[rid1].ok
    assert done[rid1].stats.degrade == 1
    assert done[rid1].stats.p_final == pytest.approx(1.5)
    assert np.isfinite(done[rid1].rcut)
    eng2 = ClusterServeEngine(serve_cfg, max_batch=8, max_wait_s=100.0,
                              deadline_s=10.0)
    rid2 = eng2.submit(serve_graphs[1])
    done2 = eng2.poll(now=time.monotonic() + 20.0)
    assert done2[rid2].ok
    assert done2[rid2].stats.degrade == 2
    assert done2[rid2].stats.p_final == 2.0
    assert np.isfinite(done2[rid2].rcut)
    assert eng2.stats.n_degraded == 1


def test_churn_retry_with_backoff(serve_cfg, serve_graphs):
    """Transient churn faults retry with a deterministic backoff and
    still take the incremental path; exhaustion falls back to a cold
    solve of the edited graph."""
    W = serve_graphs[0]
    eng = ClusterServeEngine(serve_cfg, max_bucket_n=16, churn_retries=2,
                             retry_backoff_s=0.25)
    sleeps = []
    eng._sleep = sleeps.append
    eng.submit(W)
    eng.flush()
    delta = EdgeDelta(rows=np.array([0]), cols=np.array([1]),
                      vals=np.array([2.0]))
    with serve_churn_fault(fail_attempts=2) as log:
        rid = eng.update(W, delta)
        res = eng.flush()[rid]
    assert log.count("serve_churn_fault") == 2
    assert res.ok and res.stats.retries == 2
    assert sleeps == [0.25, 0.5]
    assert eng.stats.n_retried == 2
    with serve_churn_fault(fail_attempts=10):
        rid = eng.update(W, delta)
        res = eng.flush()[rid]
    assert res.ok                                    # the cold fallback
    assert res.stats.retries == eng.churn_retries + 1
    assert np.isfinite(res.rcut)


def test_failed_request_never_poisons_cache(serve_cfg, serve_graphs):
    bad = _with_nan(serve_graphs[0])
    eng = ClusterServeEngine(serve_cfg, max_batch=1, max_wait_s=0.0)
    rid = eng.submit(bad)
    assert not eng.flush()[rid].ok
    assert bad.fingerprint(eng.weight_quant) not in eng.cache


# -------------------------------------------- kernel faults reach the caller

def test_kernel_error_in_a_batch_reaches_flush(serve_cfg, serve_graphs):
    """A kernel that fails to build or launch is not quarantined: it
    leaves ``flush`` as the kernel layer's exception, and no request is
    recorded as failed."""
    eng = ClusterServeEngine(serve_cfg, max_batch=4, max_wait_s=0.0)
    rids = [eng.submit(W) for W in serve_graphs]
    with serve_batch_fault([rids[1]], exc=KernelError("segment_sum: CUDA "
                                                      "error 700")):
        with pytest.raises(KernelError, match="CUDA error"):
            eng.flush()
    assert eng.stats.n_failed == 0 and eng.stats.n_quarantined == 0


def test_kernel_error_in_churn_is_not_retried(serve_cfg, serve_graphs):
    W = serve_graphs[0]
    eng = ClusterServeEngine(serve_cfg, max_bucket_n=16)
    eng._sleep = lambda s: None
    eng.serve([W])
    delta = EdgeDelta(rows=np.array([0]), cols=np.array([1]),
                      vals=np.array([2.0]))
    with serve_churn_fault(fail_attempts=1,
                           exc=KernelError("nvcc failed")) as log:
        rid = eng.update(W, delta)
        with pytest.raises(KernelError):
            eng.flush()
    assert log.count("serve_churn_fault") == 1
    assert eng.stats.n_retried == 0 and rid not in eng._results


def test_kernel_error_on_the_solo_lane_reaches_flush(serve_cfg, serve_graphs,
                                                     monkeypatch):
    def broken(W, cfg):
        raise KernelError("sellcs_spmm: CUDA error 719")

    monkeypatch.setattr(psc_engine._psc, "p_spectral_cluster", broken)
    eng = ClusterServeEngine(serve_cfg, max_bucket_n=16)
    eng.submit(serve_graphs[0])
    with pytest.raises(KernelError, match="719"):
        eng.flush()
    assert eng.stats.n_failed == 0


def test_kernel_error_is_a_runtime_error_of_the_kernel_layer():
    from repro_torch.kernels import nvcc

    assert issubclass(KernelError, RuntimeError)

    class Lib:
        @staticmethod
        def error_string(code):
            return b"an illegal memory access was encountered"

    with pytest.raises(KernelError, match="illegal memory access"):
        nvcc.check(Lib, 700, "segment_sum")
