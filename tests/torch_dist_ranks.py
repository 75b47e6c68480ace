"""Rank side of the distributed-SpMM tests (``tests/test_torch_dist.py``).

``spawn_ranks(world, spec, tmp)`` starts ``world`` CPU ranks with
``torch.multiprocessing.spawn`` over gloo, rendezvous through a
``file://`` store in ``tmp``.  Each rank builds the port's matrices from
the host COO triples in ``spec["graphs"]``, runs every job of
``spec["jobs"]`` against its mesh and pickles its results to
``tmp/rank<r>.pkl``; ``spawn_ranks`` returns them, one dict a rank.  A
rank that raises fails the spawn with its traceback.  Imports neither
JAX nor the reference package.
"""
from __future__ import annotations

import pickle
from pathlib import Path

import numpy as np
import torch


def spawn_ranks(world: int, spec: dict, tmp) -> list:
    import torch.multiprocessing as mp

    tmp = Path(tmp)
    with open(tmp / "spec.pkl", "wb") as f:
        pickle.dump(spec, f)
    mp.spawn(_rank_main, args=(world, str(tmp)), nprocs=world, join=True)
    out = []
    for r in range(world):
        with open(tmp / f"rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


def _rank_main(rank: int, world: int, tmp: str) -> None:
    torch.set_num_threads(1)
    from repro_torch.grblas import dist

    dist.init_distributed(f"file://{tmp}/store", world, rank, device="cpu")
    try:
        mesh = dist.device_mesh(device="cpu")
        with open(Path(tmp) / "spec.pkl", "rb") as f:
            spec = pickle.load(f)
        ctx = _Context(spec, mesh)
        out = {name: JOBS[fn](ctx, **kw) for name, fn, kw in spec["jobs"]}
        with open(Path(tmp) / f"rank{rank}.pkl", "wb") as f:
            pickle.dump(out, f)
    finally:
        torch.distributed.destroy_process_group()


class _Context:
    """The spec, the mesh and the rank's matrices (built once each)."""

    def __init__(self, spec, mesh):
        self.spec, self.mesh, self._mats = spec, mesh, {}

    def matrix(self, key):
        """A port SparseMatrix of ``spec["graphs"][key]``, or the
        pre-built partition ``spec["parts"][key]``."""
        if key in self.spec.get("parts", {}):
            return self.spec["parts"][key]
        if key not in self._mats:
            from repro_torch import convert

            coo, shape, layout = self.spec["graphs"][key]
            self._mats[key] = convert.sparse_matrix(coo, shape, device="cpu",
                                                    **layout)
        return self._mats[key]

    def desc(self, backend="auto"):
        from repro_torch.grblas import Descriptor

        return Descriptor(backend=backend, mesh=self.mesh)


def _ring(spec):
    from repro_torch.grblas.semiring import plap_edge_semiring, reals_ring

    return reals_ring if spec is None else plap_edge_semiring(*spec)


def _np(t):
    return t.detach().cpu().numpy()


def job_product(ctx, A, X, ring=None, backend="dist"):
    """mxm over the mesh; the global Y."""
    from repro_torch.grblas import mxm

    return _np(mxm(ctx.matrix(A), torch.as_tensor(X), _ring(ring),
                   desc=ctx.desc(backend)))


def job_memo(ctx, A, X, backend="dist"):
    """The partition memo: a product through a plain SparseMatrix, then
    the same after its value buffers are swapped for doubled ones."""
    from repro_torch.grblas import mxm

    W = ctx.matrix(A)
    Xt = torch.as_tensor(X)
    got = _np(mxm(W, Xt, desc=ctx.desc(backend)))
    keys = list(W._dist_partitions)
    stale = (ctx.mesh.size, id(W.ell_vals), backend == "dist_sellcs")
    vals, ell_vals = W.vals, W.ell_vals
    W.vals, W.ell_vals = vals * 2.0, ell_vals * 2.0
    got2 = _np(mxm(W, Xt, desc=ctx.desc(backend)))
    fresh = (ctx.mesh.size, id(W.ell_vals), backend == "dist_sellcs")
    out = dict(got=got, got2=got2, stale_before=stale in keys,
               n_before=len(keys), stale_after=stale in W._dist_partitions,
               fresh_after=fresh in W._dist_partitions,
               n_after=len(W._dist_partitions))
    W.vals, W.ell_vals = vals, ell_vals
    return out


def job_backends(ctx, A, X, ring=None):
    """``available_backends`` with and without the mesh."""
    from repro_torch.grblas import Descriptor, available_backends

    W, Xt, r = ctx.matrix(A), torch.as_tensor(X), _ring(ring)
    return dict(mesh=available_backends(W, Xt, r, desc=ctx.desc()),
                none=available_backends(W, Xt, r, desc=Descriptor()))


def job_traced(ctx, A, X, backend="dist"):
    """One traced product: the dist.shard_mxm span and the counters."""
    from repro_torch.grblas import mxm
    from repro_torch.obs import metrics, trace

    reg = metrics.MetricsRegistry()
    prev = metrics.DEFAULT
    metrics.DEFAULT = reg
    try:
        tracer = trace.Tracer()
        with trace.use(tracer):
            Y = mxm(ctx.matrix(A), torch.as_tensor(X), desc=ctx.desc(backend))
        spans = [dict(name=s.name, **s.attrs) for s in tracer.spans]
        mode = ctx.matrix(A).mode
        return dict(
            Y=_np(Y), spans=spans,
            wire_total=reg.value("dist_wire_bytes_total", mode=mode),
            calls=reg.value("dist_shard_mxm_total", mode=mode))
    finally:
        metrics.DEFAULT = prev


def job_halo(ctx, A, X, shard, backend="dist"):
    """The product with the halo from ``shard`` poisoned (nan) and
    dropped, then clean again once the hook is gone."""
    from repro_torch.grblas import mxm
    from repro_torch.testing import halo_corruption

    Ap, Xt, d = ctx.matrix(A), torch.as_tensor(X), ctx.desc(backend)
    with halo_corruption("nan", shard=shard) as log:
        nan = _np(mxm(Ap, Xt, desc=d))
    with halo_corruption("drop", shard=shard) as log2:
        drop = _np(mxm(Ap, Xt, desc=d))
    return dict(nan=nan, drop=drop, clean=_np(mxm(Ap, Xt, desc=d)),
                fired=log.count("halo_corruption"),
                fired_drop=log2.count("halo_corruption"))


def job_lobpcg(ctx, A, k, X0, tol, backend="dist_sellcs"):
    """Stage 1's eigensolve with its SpMMs over the mesh."""
    from repro_torch.core import lobpcg

    ev, U = lobpcg.smallest_eigvecs(ctx.matrix(A), k, tol=tol,
                                    X0=torch.as_tensor(X0),
                                    desc=ctx.desc(backend))
    return dict(evals=_np(ev), U=_np(U))


def job_mesh(ctx):
    m = ctx.mesh
    return dict(size=m.size, rank=m.rank, backend=m.backend,
                device=str(m.device), shape=dict(m.shape), staged=m.staged)


def job_initialized(ctx):
    from repro_torch.grblas import dist

    return dist.is_distributed_initialized()


JOBS = {"product": job_product, "memo": job_memo, "backends": job_backends,
        "traced": job_traced, "halo": job_halo, "lobpcg": job_lobpcg,
        "mesh": job_mesh, "initialized": job_initialized}


def halo_rows(Ap, shard: int) -> np.ndarray:
    """Original row ids whose product reads a halo slot filled by
    ``shard`` (the rows a corrupted halo from that shard reaches)."""
    S, R, H = Ap.n_shards, Ap.rows_per_shard, Ap.halo_width
    hit = []
    for d in range(S):
        if d == shard:
            continue
        c = Ap.ell_cols[d]
        reads = ((c >= R + shard * H) & (c < R + (shard + 1) * H)).any(1)
        pos = d * R + np.flatnonzero(reads)
        pos = pos[pos < Ap.n_rows]
        hit.append(pos if Ap.perm is None else Ap.perm[pos])
    return np.sort(np.concatenate(hit)) if hit else np.empty(0, np.int64)
