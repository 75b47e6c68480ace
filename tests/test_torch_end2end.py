"""End-to-end flat pipeline of the port on the graphs of
tests/test_psc_end2end.py, on the CPU: planted clusters recovered, and
RCut within 5% of the reference pipeline's on the same graph, for both
HVP modes and for the coo and sellcs backends.  (jax.random and
torch.Generator streams differ, so the runs are held by quality, not
label for label.)"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the reference-only CI has no torch

from repro.core import PSCConfig as RefConfig
from repro.core import p_spectral_cluster as ref_cluster
from repro.graphs import gaussian_blobs_knn, ring_of_cliques, sbm_graph
from repro_torch import convert
from repro_torch.core import metrics
from repro_torch.core.psc import PSCConfig, p_spectral_cluster, spectral_cluster
from repro_torch.multilevel import MultilevelConfig

# Small CPU problems: intra-op threads only contend with the other test
# workers.
torch.set_num_threads(1)

CASES = {
    "ring_of_cliques": (lambda: ring_of_cliques(4, 10),
                        dict(k=4, p_target=1.4, newton_iters=15, tcg_iters=10,
                             kmeans_restarts=4, seed=0), 1.0),
    "blobs": (lambda: gaussian_blobs_knn(25, 4, seed=2),
              dict(k=4, p_target=1.3, newton_iters=15, tcg_iters=10, seed=1),
              0.95),
    "sbm": (lambda: sbm_graph([30, 30, 30, 30], p_in=0.5, p_out=0.03, seed=5),
            dict(k=4, p_target=1.2, newton_iters=20, tcg_iters=15, seed=0),
            None),
}


@functools.lru_cache(maxsize=None)
def _reference(name):
    make, kw, _ = CASES[name]
    W, truth = make()
    res = ref_cluster(W, RefConfig(**kw))
    return W, truth, float(res.rcut)


@pytest.mark.parametrize("backend", ["coo", "sellcs"])
@pytest.mark.parametrize("mode", ["graphblas", "matrix_free"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_port_pipeline_matches_reference_quality(name, mode, backend):
    W, truth, ref_rcut = _reference(name)
    _, kw, min_acc = CASES[name]
    port = convert.sparse_matrix(W.host_coo(), (W.n_rows, W.n_cols),
                                 device="cpu", build_sellcs=True, sell_c=8)
    res = p_spectral_cluster(port, PSCConfig(hvp_mode=mode, backend=backend,
                                             **kw))
    acc = metrics.clustering_accuracy(res.labels, truth, kw["k"])
    if min_acc is not None:
        assert acc >= min_acc, f"accuracy {acc}"
    assert np.isfinite(res.rcut)
    assert res.rcut <= ref_rcut * 1.05 + 1e-9, \
        f"port rcut {res.rcut} vs reference {ref_rcut}"
    assert res.rcut <= res.init_rcut * 1.01 + 1e-9
    assert len(res.p_path) >= 2 and all(h > 0 for h in res.hvp_counts)
    G = convert.to_numpy(res.U.T @ res.U)
    np.testing.assert_allclose(G, np.eye(kw["k"]), atol=1e-5)
    assert set(res.stage_seconds) == {"init", "continuation", "kmeans"}


def test_spectral_cluster_baseline():
    W, truth = ring_of_cliques(4, 10)
    port = convert.sparse_matrix(W.host_coo(), (W.n_rows, W.n_cols),
                                 device="cpu")
    labels, rcut = spectral_cluster(port, 4)
    assert metrics.clustering_accuracy(labels, truth, 4) == 1.0
    assert np.isfinite(rcut)


def test_init_U_config_field_warm_starts():
    """``PSCConfig.init_U`` is accepted and runs the warm entry: the
    schedule tail from the given embedding, no p=2 start."""
    W, truth = ring_of_cliques(4, 10)
    port = convert.sparse_matrix(W.host_coo(), (W.n_rows, W.n_cols),
                                 device="cpu")
    U0 = np.linalg.qr(np.eye(40, 4) + 0.01)[0]
    cfg = PSCConfig(k=4, newton_iters=10, tcg_iters=6, init_U=U0)
    assert cfg.warm_p_steps == 1
    res = p_spectral_cluster(port, cfg)
    assert res.init_labels is None and np.isnan(res.init_rcut)
    assert len(res.p_path) == 1 and res.p_path[-1] == cfg.p_target
    assert res.U.shape == (40, 4) and np.isfinite(res.rcut)


@pytest.mark.parametrize("field,value", [
    pytest.param("multilevel", MultilevelConfig(coarse_solver="scf"),
                 id="multilevel-coarse_solver_scf"),
    ("guard", True), ("validate", True), ("trace", True),
    pytest.param("multilevel", MultilevelConfig(refine_solver="inverse_power"),
                 id="multilevel-refine_solver_inverse_power"),
    ("solver", "scf")])
def test_config_fields_of_the_eighth_slice_construct(field, value):
    """The fields the eighth slice ported construct and keep their
    values (they raised NotImplementedError before)."""
    cfg = PSCConfig(**{field: value})
    assert getattr(cfg, field) == value


def test_trivial_k_and_bad_inputs():
    W, _ = ring_of_cliques(2, 3)
    port = convert.sparse_matrix(W.host_coo(), (6, 6), device="cpu")
    one = p_spectral_cluster(port, PSCConfig(k=1))
    assert (one.labels == 0).all() and one.rcut == 0.0
    every = p_spectral_cluster(port, PSCConfig(k=6))
    np.testing.assert_array_equal(every.labels, np.arange(6))
    with pytest.raises(ValueError):
        p_spectral_cluster(port, PSCConfig(k=7))
    with pytest.raises(ValueError):
        PSCConfig(p_target=0.9)
