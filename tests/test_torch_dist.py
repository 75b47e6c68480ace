"""The distributed SpMM on gloo CPU ranks against the reference.

One ``torch.multiprocessing.spawn`` per world size (2, 3 and 4 ranks,
``tests/torch_dist_ranks.py``) runs every check's product on every rank
and returns the results; the tests then compare them here with the
reference's single-device ``mxm(W, X, ring)``, which is what the
reference's own contract says its dist result equals (its multi-device
tests fail on this JAX: ROADMAP.md §3).  The graph is
``delaunay_graph(9)`` cut to n = 509 vertices, a prime, so no shard
count divides it.

Tolerances are the reference's (``tests/test_dist_spmv.py``): fp32
rtol = atol = 2e-5 for reals, rtol 2e-4 / atol 2e-5 for the p-Laplacian
edge ring; fp64 to 1e-12.  Every rank must return the same Y, bit for
bit.  LOBPCG over ``dist_sellcs`` is held to the bound of the port's
LOBPCG parity test (``test_torch_solvers.py``: eigenvalues rtol 1e-8,
largest principal sine 1e-6, fp64).
"""
import numpy as np
import pytest
import jax.numpy as jnp

torch = pytest.importorskip("torch")  # the reference-only CI has no torch

from repro.core import lobpcg as ref_lobpcg
from repro.graphs import delaunay_graph, sbm_graph, sbm_graph_sparse
from repro.grblas import Descriptor as RefDesc
from repro.grblas import SparseMatrix as RefSparseMatrix
from repro.grblas import mxm as ref_mxm
from repro.grblas.semiring import plap_edge_semiring as ref_plap

from repro_torch import convert
from repro_torch.grblas import make_row_partition
from repro_torch.graphs import delaunay_graph as port_delaunay
from repro_torch.graphs import partition_for_mesh

from torch_dist_ranks import halo_rows, spawn_ranks

N = 509
KS = (1, 8, 32)
P_EDGE = (1.5, 1e-8)
TOL = {"reals": dict(rtol=2e-5, atol=2e-5),
       "edge": dict(rtol=2e-4, atol=2e-5),
       "fp64": dict(rtol=1e-12, atol=1e-12)}
WORLDS = (2, 3, 4)


def _cut(W, n, dtype):
    r, c, v = (np.asarray(a) for a in W.host_coo())
    keep = (r < n) & (c < n)
    return r[keep], c[keep], v[keep].astype(dtype)


def _ref(coo, shape, dtype=jnp.float32):
    return RefSparseMatrix.from_coo(*coo, shape, build_ell=True, dtype=dtype)


def _port(coo, shape):
    return convert.sparse_matrix(coo, shape, device="cpu", build_ell=True)


@pytest.fixture(scope="module")
def inputs():
    """Host graphs, inputs and the reference's single-device products."""
    rng = np.random.default_rng(0)
    Wd, _ = delaunay_graph(9, seed=0)
    coo = _cut(Wd, N, np.float32)
    coo64 = _cut(Wd, N, np.float64)
    r, c, v = coo
    c2 = np.where(np.arange(len(c)) % 2 == 0, c, c + N)   # cols >= n too
    rect = (r, c2, v)
    Ws, truth = sbm_graph([128] * 4, 0.06, 0.002, seed=0)
    sbm = tuple(np.asarray(a) for a in Ws.host_coo())
    Wl, _ = sbm_graph_sparse([300] * 4, deg_in=12, deg_out=0.6, seed=2,
                             dtype=jnp.float64)
    lob = tuple(np.asarray(a) for a in Wl.host_coo())
    X = {k: rng.standard_normal((N,) if k == 1 else (N, k)).astype(
        np.float32) for k in KS}
    X3 = rng.standard_normal((N, 3)).astype(np.float32)
    X64 = rng.standard_normal((N, 8))
    Xr = rng.standard_normal((2 * N, 3)).astype(np.float32)
    Xs = rng.standard_normal((512, 8)).astype(np.float32)
    X0 = np.random.default_rng(5).standard_normal((1200, 8))

    ref, ref64 = _ref(coo, (N, N)), _ref(coo64, (N, N), jnp.float64)
    edge = ref_plap(*P_EDGE)
    want = {}
    for k in KS:
        want[f"reals k={k}"] = np.asarray(ref_mxm(ref, jnp.asarray(X[k])))
        want[f"edge k={k}"] = np.asarray(ref_mxm(ref, jnp.asarray(X[k]),
                                                 edge))
    want["reals X3"] = np.asarray(ref_mxm(ref, jnp.asarray(X3)))
    want["edge X3"] = np.asarray(ref_mxm(ref, jnp.asarray(X3), edge))
    want["reals fp64"] = np.asarray(ref_mxm(ref64, jnp.asarray(X64)))
    want["edge fp64"] = np.asarray(ref_mxm(ref64, jnp.asarray(X64), edge))
    want["rect"] = np.asarray(ref_mxm(_ref(rect, (N, 2 * N)),
                                      jnp.asarray(Xr)))
    want["sbm"] = np.asarray(ref_mxm(Ws, jnp.asarray(Xs)))
    ev, U = ref_lobpcg.smallest_eigvecs(Wl, 4, tol=1e-9,
                                        X0=jnp.asarray(X0),
                                        desc=RefDesc(backend="coo"))
    want["lobpcg"] = (np.asarray(ev), np.asarray(U))
    return dict(coo=coo, coo64=coo64, rect=rect, sbm=sbm,
                truth=np.asarray(truth), lob=lob, X=X, X3=X3, X64=X64,
                Xr=Xr, Xs=Xs, X0=X0, want=want)


@pytest.fixture(scope="module")
def pfm():
    """partition_for_mesh on a randomly ordered Delaunay graph (the
    placement path of tests/test_partition.py), and an input for a
    product through the partition it builds."""
    W, _ = port_delaunay(9, seed=0, locality_order=False, device="cpu")
    Ap, labels, info = partition_for_mesh(W, 4, seed=0, sellcs=True,
                                          sell_c=8)
    X = np.random.default_rng(9).standard_normal((W.n_rows, 4)).astype(
        np.float32)
    return dict(W=W, Ap=Ap, labels=labels, info=info, X=X)


def _spec(S, inp, pfm):
    """Partitions and jobs of one world of S ranks."""
    W = _port(inp["coo"], (N, N))
    W64 = _port(inp["coo64"], (N, N))
    labels = (np.arange(N) * 7) % 4
    parts = {
        "halo": make_row_partition(W, S, sellcs=True, sell_c=8),
        "placed_gather": make_row_partition(W, S, labels, mode="gather",
                                            sellcs=True, sell_c=8),
        "placed_halo": make_row_partition(W, S, labels, mode="halo",
                                          sellcs=True, sell_c=8),
        "halo64": make_row_partition(W64, S, sellcs=True, sell_c=8),
    }
    jobs = [("mesh", "mesh", {}), ("initialized", "initialized", {})]
    for be in ("dist", "dist_sellcs"):
        for k in KS:
            X = inp["X"][k]
            jobs.append((f"{be} reals k={k}", "product",
                         dict(A="halo", X=X, backend=be)))
            jobs.append((f"{be} edge k={k}", "product",
                         dict(A="halo", X=X, ring=P_EDGE, backend=be)))
        for part in ("placed_gather", "placed_halo"):
            for ring in ("reals", "edge"):
                jobs.append((f"{be} {ring} {part}", "product", dict(
                    A=part, X=inp["X3"], backend=be,
                    ring=P_EDGE if ring == "edge" else None)))
        for ring in ("reals", "edge"):
            jobs.append((f"{be} {ring} fp64", "product", dict(
                A="halo64", X=inp["X64"], backend=be,
                ring=P_EDGE if ring == "edge" else None)))
        jobs.append((f"{be} memo", "memo", dict(A="W", X=inp["X3"],
                                                backend=be)))
        jobs.append((f"{be} traced", "traced", dict(A="halo", X=inp["X"][8],
                                                    backend=be)))
        jobs.append((f"{be} halo fault", "halo", dict(
            A="halo", X=inp["X"][8], shard=S - 1, backend=be)))
    jobs += [
        ("backends reals", "backends", dict(A="W", X=inp["X3"])),
        ("backends edge", "backends", dict(A="W", X=inp["X3"], ring=P_EDGE)),
        ("backends rect edge", "backends", dict(A="rect", X=inp["Xr"],
                                                ring=P_EDGE)),
        ("rect", "product", dict(A="rect", X=inp["Xr"], backend="auto")),
        ("lobpcg", "lobpcg", dict(A="lob", k=4, X0=inp["X0"], tol=1e-9)),
    ]
    if S == 4:
        # the reference's chaos case: a 4-block SBM placed by its truth
        Ws = _port(inp["sbm"], (512, 512))
        parts["sbm"] = make_row_partition(Ws, 4, inp["truth"], sellcs=True)
        parts["pfm"] = pfm["Ap"]
        jobs += [("sbm", "product", dict(A="sbm", X=inp["Xs"])),
                 ("sbm halo fault", "halo", dict(A="sbm", X=inp["Xs"],
                                                 shard=0)),
                 ("pfm", "product", dict(A="pfm", X=pfm["X"],
                                         backend="dist_sellcs"))]
    graphs = {"W": (inp["coo"], (N, N), dict(build_ell=True)),
              "rect": (inp["rect"], (N, 2 * N), dict(build_ell=True)),
              "lob": (inp["lob"], (1200, 1200), dict(build_ell=True))}
    return dict(graphs=graphs, parts=parts, jobs=jobs)


@pytest.fixture(scope="module")
def worlds(inputs, pfm, tmp_path_factory):
    """{S: (S, spec, per-rank results)}: one spawn of S ranks each."""
    out = {}
    for S in WORLDS:
        spec = _spec(S, inputs, pfm)
        out[S] = (S, spec, spawn_ranks(S, spec,
                                       tmp_path_factory.mktemp(f"world{S}")))
    return out


def _same_on_every_rank(ranks, name):
    Y = ranks[0][name]
    for r in ranks[1:]:
        np.testing.assert_array_equal(r[name], Y)
    return Y


@pytest.mark.parametrize("S", WORLDS)
def test_mesh_on_every_rank(worlds, S):
    _, _, ranks = worlds[S]
    for r, res in enumerate(ranks):
        assert res["mesh"] == dict(size=S, rank=r, backend="gloo",
                                   device="cpu", shape={"data": S},
                                   staged=False)


def test_is_distributed_initialized_false_in_a_plain_process():
    from repro_torch.grblas import dist

    assert not torch.distributed.is_initialized()
    assert dist.is_distributed_initialized() is False


@pytest.mark.parametrize("S", WORLDS)
def test_is_distributed_initialized_on_every_rank(worlds, S):
    _, _, ranks = worlds[S]
    assert [res["initialized"] for res in ranks] == [True] * S


@pytest.mark.parametrize("backend", ["dist", "dist_sellcs"])
@pytest.mark.parametrize("ring", ["reals", "edge"])
@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("S", WORLDS)
def test_halo_products_equal_reference(worlds, inputs, S, backend, ring,
                                        k):
    _, _, ranks = worlds[S]
    got = _same_on_every_rank(ranks, f"{backend} {ring} k={k}")
    want = inputs["want"][f"{ring} k={k}"]
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL[ring])


@pytest.mark.parametrize("backend", ["dist", "dist_sellcs"])
@pytest.mark.parametrize("part", ["placed_gather", "placed_halo"])
@pytest.mark.parametrize("S", WORLDS)
def test_placement_is_transparent(worlds, inputs, S, backend, part):
    """X in and Y out in the original row space under a placement, on
    the gather and the halo plan, both rings."""
    _, spec, ranks = worlds[S]
    Ap = spec["parts"][part]
    assert Ap.perm is not None and Ap.mode == part.split("_")[1]
    for ring in ("reals", "edge"):
        got = _same_on_every_rank(ranks, f"{backend} {ring} {part}")
        np.testing.assert_allclose(got, inputs["want"][f"{ring} X3"],
                                   **TOL[ring])


@pytest.mark.parametrize("backend", ["dist", "dist_sellcs"])
@pytest.mark.parametrize("S", WORLDS)
def test_fp64_products_to_1e12(worlds, inputs, S, backend):
    _, _, ranks = worlds[S]
    for ring in ("reals", "edge"):
        got = _same_on_every_rank(ranks, f"{backend} {ring} fp64")
        assert got.dtype == np.float64
        np.testing.assert_allclose(got, inputs["want"][f"{ring} fp64"],
                                   **TOL["fp64"])


@pytest.mark.parametrize("S", WORLDS)
def test_rectangular_reals_ride_the_gather_fallback(worlds, inputs, S):
    _, _, ranks = worlds[S]
    got = _same_on_every_rank(ranks, "rect")
    assert got.shape == (N, 3)
    np.testing.assert_allclose(got, inputs["want"]["rect"], **TOL["reals"])


@pytest.mark.parametrize("S", WORLDS)
def test_auto_picks_dist_only_with_a_mesh(worlds, S):
    _, _, ranks = worlds[S]
    for res in ranks:
        for ring in ("reals", "edge"):
            names = res[f"backends {ring}"]
            assert names["mesh"][0] == "dist"
            assert "dist_sellcs" in names["mesh"]
            assert "dist" not in names["none"]
            assert "dist_sellcs" not in names["none"]
        rect = res["backends rect edge"]
        assert "dist" not in rect["mesh"] and "dist_sellcs" not in rect["mesh"]


@pytest.mark.parametrize("backend", ["dist", "dist_sellcs"])
@pytest.mark.parametrize("S", WORLDS)
def test_memo_evicts_the_stale_partition(worlds, inputs, S, backend):
    """A plain SparseMatrix partitions once per (shards, ell_vals
    buffer, layout); swapping in doubled values re-partitions and evicts
    the superseded entry."""
    _, _, ranks = worlds[S]
    want = inputs["want"]["reals X3"]
    for res in ranks:
        m = res[f"{backend} memo"]
        np.testing.assert_allclose(m["got"], want, **TOL["reals"])
        np.testing.assert_allclose(m["got2"], 2.0 * want, **TOL["reals"])
        assert m["stale_before"] and not m["stale_after"]
        assert m["fresh_after"] and m["n_after"] == m["n_before"]


@pytest.mark.parametrize("backend", ["dist", "dist_sellcs"])
@pytest.mark.parametrize("S", WORLDS)
def test_traced_product_span_and_counters(worlds, inputs, S, backend):
    _, spec, ranks = worlds[S]
    Ap = spec["parts"]["halo"]
    wire = Ap.wire_bytes(8)["halo"]
    for res in ranks:
        t = res[f"{backend} traced"]
        np.testing.assert_allclose(t["Y"], inputs["want"]["reals k=8"],
                                   **TOL["reals"])
        spans = [s for s in t["spans"] if s["name"] == "dist.shard_mxm"]
        assert len(spans) == 1
        sp = spans[0]
        assert {k: sp[k] for k in ("mode", "n", "n_shards", "k",
                                   "halo_width", "wire_bytes", "layout")} == \
            dict(mode="halo", n=N, n_shards=S, k=8,
                 halo_width=Ap.halo_width, wire_bytes=wire,
                 layout="sellcs" if backend == "dist_sellcs" else "ell")
        assert any(s["name"] == "grblas.mxm" and s["backend"] == backend
                   for s in t["spans"])
        assert t["wire_total"] == wire and t["calls"] == 1


@pytest.mark.parametrize("backend", ["dist", "dist_sellcs"])
@pytest.mark.parametrize("S", WORLDS)
def test_halo_corruption_lands_where_the_halo_does(worlds, inputs, S,
                                                  backend):
    """halo_corruption on every rank: NaN exactly in the rows that read
    a halo slot of the named shard; "drop" changes exactly those rows;
    the product is clean once the hook is gone."""
    _, spec, ranks = worlds[S]
    Ap = spec["parts"]["halo"]
    want = inputs["want"]["reals k=8"]
    hit = np.zeros(N, bool)
    hit[halo_rows(Ap, S - 1)] = True
    assert 0 < hit.sum() < N
    for res in ranks:
        h = res[f"{backend} halo fault"]
        assert h["fired"] >= 1 and h["fired_drop"] >= 1
        np.testing.assert_array_equal(np.isnan(h["nan"]).any(1), hit)
        np.testing.assert_allclose(h["nan"][~hit], want[~hit],
                                   **TOL["reals"])
        assert np.isfinite(h["drop"]).all()
        np.testing.assert_allclose(h["drop"][~hit], want[~hit],
                                   **TOL["reals"])
        assert (np.abs(h["drop"][hit] - want[hit]) > 1e-4).any(1).all()
        np.testing.assert_allclose(h["clean"], want, **TOL["reals"])


@pytest.mark.parametrize("S", WORLDS)
def test_lobpcg_over_dist_sellcs_matches_reference(worlds, inputs, S):
    _, _, ranks = worlds[S]
    rev, rU = inputs["want"]["lobpcg"]
    for res in ranks:
        ev, U = res["lobpcg"]["evals"], res["lobpcg"]["U"]
        np.testing.assert_allclose(ev, rev, rtol=1e-8, atol=1e-9)
        Qa, Qb = np.linalg.qr(U)[0], np.linalg.qr(rU)[0]
        assert np.linalg.norm(Qb - Qa @ (Qa.T @ Qb), 2) <= 1e-6


def test_sbm_truth_placement_and_chaos_case(worlds, inputs):
    """The reference's chaos and halo case on 4 ranks: a 4-block SBM
    placed by its truth is a halo plan cheaper than the gather, equal to
    the single-device product; a NaN halo from shard 0 is observable, a
    dropped one finite but wrong."""
    _, spec, ranks = worlds[4]
    Ap = spec["parts"]["sbm"]
    assert Ap.mode == "halo"
    wb = Ap.wire_bytes(8)
    assert wb["halo"] < wb["gather"]
    want = inputs["want"]["sbm"]
    np.testing.assert_allclose(_same_on_every_rank(ranks, "sbm"), want,
                               **TOL["reals"])
    h = ranks[0]["sbm halo fault"]
    assert np.isnan(h["nan"]).any()
    assert np.isfinite(h["drop"]).all()
    assert not np.allclose(h["drop"], want, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(h["clean"], want, **TOL["reals"])


def test_partition_for_mesh_builds_a_placed_halo_partition(pfm):
    """tests/test_partition.py's placement check: the PSC assignment
    gives a halo plan cheaper than the gather, and rows of one cluster
    overwhelmingly share a shard."""
    W, Ap, labels, info = pfm["W"], pfm["Ap"], pfm["labels"], pfm["info"]
    assert Ap.n_shards == 4 and Ap.perm is not None and Ap.sell is not None
    assert info["halo"]["mode"] == "halo"
    assert info["halo"]["halo"] < info["halo"]["gather"]
    shard_of = np.asarray(Ap.inv_perm) // Ap.rows_per_shard
    agree = sum(np.bincount(shard_of[labels == c]).max()
                for c in range(labels.max() + 1))
    assert agree >= 0.9 * W.n_rows
    assert np.isfinite(info["rcut"])


def test_partition_for_mesh_product_on_four_ranks(worlds, pfm):
    _, _, ranks = worlds[4]
    W = pfm["W"]
    want = torch.sparse_coo_tensor(
        torch.stack([W.rows.long(), W.cols.long()]), W.vals.double(),
        (W.n_rows, W.n_cols)) @ torch.as_tensor(pfm["X"]).double()
    np.testing.assert_allclose(_same_on_every_rank(ranks, "pfm"),
                               want.numpy(), **TOL["reals"])
