"""Rank side of the distributed-SpMM tests (``tests/test_torch_dist.py``).

``spawn_ranks(world, spec, tmp)`` starts ``world`` CPU ranks with
``torch.multiprocessing.spawn`` over gloo, rendezvous through a
``file://`` store in ``tmp``.  Each rank builds the port's matrices from
the host COO triples in ``spec["graphs"]``, runs every job of
``spec["jobs"]`` against its mesh and pickles its results to
``tmp/rank<r>.pkl``; ``spawn_ranks`` returns them, one dict a rank.  A
rank that raises fails the spawn with its traceback.  Imports neither
JAX nor the reference package.

The sharding tests (``tests/test_torch_mesh.py``) run the ``mesh_*``
jobs: each builds a ``(world // model, model)`` host mesh
(``launch.mesh.make_host_mesh``; every rank makes the meshes in one
order, as ``new_group`` requires) and returns whole numpy arrays,
gathered from the ranks' blocks.  The ``mesh_family`` and
``mesh_steps`` jobs (``tests/test_torch_mesh_families.py``) take a
(data, model) mesh over the first data * model ranks; a rank outside it
returns None.
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
        self._host_meshes = {}

    def host_mesh(self, model):
        """The (world // model, model) mesh, made once."""
        if model not in self._host_meshes:
            from repro_torch.launch.mesh import make_host_mesh

            self._host_meshes[model] = make_host_mesh(model, device="cpu")
        return self._host_meshes[model]

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


def _lm_cfg(arch, override):
    import dataclasses

    from repro_torch.configs import get_reduced_config

    cfg = get_reduced_config(arch)
    moe = override.pop("moe", None)
    if moe:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                               **moe))
    return dataclasses.replace(cfg, **override)


def _whole(mesh, t, spec):
    from repro_torch.dist.sharding import NamedSharding

    return _np(NamedSharding(mesh, spec).gather(t))


def job_mesh_moe(ctx, arch, override, params, x, model):
    """``moe_block`` under the mesh on the whole x: (y, aux), whole."""
    from repro_torch.dist.sharding import NamedSharding, resolve_spec
    from repro_torch.models import moe as MOE

    cfg = _lm_cfg(arch, dict(override))
    mesh = ctx.host_mesh(model)
    ab = MOE.moe_ab(cfg)

    def local(tree, abt):
        if isinstance(tree, dict):
            return {k: local(v, abt[k]) for k, v in tree.items()}
        return NamedSharding(mesh, resolve_spec(
            abt.shape, abt.logical, mesh)).shard(torch.from_numpy(tree))

    with torch.no_grad():
        y, aux = MOE.moe_block(cfg, local(params, ab), torch.from_numpy(x),
                               mesh)
    return dict(y=_np(y), aux=float(aux))


def job_mesh_lm(ctx, arch, override, state, tokens, steps, max_len, model):
    """The reduced model under the mesh on the full ``state``: the
    hidden states, the prefill logits, a decode step's logits for each
    token column of ``steps`` and the loss, all whole; and the greedy
    picks across the vocabulary blocks against the whole logits'."""
    from repro_torch import convert
    from repro_torch.models import layers as L
    from repro_torch.models import model as M

    cfg = _lm_cfg(arch, dict(override))
    mesh = ctx.host_mesh(model)
    P = M.init_params(cfg, device="cpu", mesh=mesh)
    P.load_state_dict(convert.shard_state_dict(
        {k: torch.from_numpy(v) for k, v in state.items()}, cfg, mesh))
    tok = torch.from_numpy(tokens)
    B, S = tok.shape
    place = L.Placement.between_blocks(mesh, B, S, cfg.d_model)
    vocab = M._table_sharding(cfg, mesh).spec[0]
    b_ent = L.entry_of(place.batch)
    out = {}
    with torch.no_grad():
        x, aux = M.forward_train(cfg, P, tok, mesh)
        out["hidden"] = _whole(mesh, x, place.spec())
        out["aux"] = float(aux)
        logits, cache, pos = M.prefill(cfg, P, tok, max_len, mesh)
        dplace = L.Placement.between_blocks(mesh, B, 1, cfg.d_model)
        lspec = (L.entry_of(dplace.batch), None, vocab)
        out["prefill"] = _whole(mesh, logits, lspec)
        pick = L.vocab_argmax(logits, M._table_sharding(cfg, mesh))
        out["pick_equal"] = bool(np.array_equal(
            _whole(mesh, pick, (L.entry_of(dplace.batch),)),
            out["prefill"].argmax(-1)))
        out["decode"] = []
        for i in range(steps.shape[1]):
            d, cache = M.decode_step(
                cfg, P, cache, torch.from_numpy(steps[:, i:i + 1]),
                torch.full((B, 1), pos + i, dtype=torch.int32), mesh)
            out["decode"].append(_whole(mesh, d, lspec))
        lab = np.roll(tokens, -1, 1)
        lab[:, -1] = -100
        loss, (nll, _) = M.loss_fn(cfg, P, tok, torch.from_numpy(lab), mesh)
        out["loss"], out["nll"] = float(loss), float(nll)
    from repro_torch.serve import GenerationConfig, ServeEngine

    out["engine"] = ServeEngine(cfg, P, max_len=max_len, mesh=mesh).generate(
        tokens, GenerationConfig(max_new_tokens=steps.shape[1]))
    out["cache_block"] = tuple(cache.layers[0].shape)
    out["place"] = (place.batch, place.seq, b_ent)
    return out


def job_mesh_int8(ctx, arch, state, tc, batches):
    """The int8 compressed train step on a (world, 1) mesh under
    DP_RULES, each rank its block of every global batch: per step the
    loss, the grad norm and the residuals, then the parameters."""
    from repro_torch import convert
    from repro_torch.dist.sharding import DP_RULES, use_rules
    from repro_torch.models import model as M
    from repro_torch.train import (TrainConfig, init_compression_state,
                                   make_optimizer, make_train_step)

    cfg = _lm_cfg(arch, {})
    mesh = ctx.host_mesh(1)
    out = dict(loss=[], grad_norm=[], err=[])
    with use_rules(DP_RULES):
        P = M.init_params(cfg, device="cpu", mesh=mesh)
        P.load_state_dict(convert.shard_state_dict(
            {k: torch.from_numpy(v) for k, v in state.items()}, cfg, mesh))
        tc = TrainConfig(**tc)
        opt = make_optimizer(tc)
        st = opt.init(P)
        err = init_compression_state(P)
        step = make_train_step(cfg, tc, opt=opt, mesh=mesh)
        for b in batches:
            P, st, err, m = step(P, st, err, {k: torch.from_numpy(v)
                                              for k, v in b.items()})
            out["loss"].append(float(m["loss"]))
            out["grad_norm"].append(float(m["grad_norm"]))
            out["err"].append({k: _np(v) for k, v in err.items()})
    out["params"] = {k: _np(v) for k, v in P.state_dict().items()}
    return out


def job_mesh_ckpt(ctx, arch, directory):
    """Parameters drawn on (1, world) with seed 5, saved there, restored
    onto (world // 2, 2) and onto no mesh: both whole."""
    from repro_torch.models import model as M
    from repro_torch.train import CheckpointManager

    cfg = _lm_cfg(arch, {})
    wide, square = ctx.host_mesh(ctx.mesh.size), ctx.host_mesh(2)
    mgr = CheckpointManager(directory)
    P = M.init_params(cfg, seed=5, device="cpu", mesh=wide)
    mgr.save(1, P, extra={"step": 1}, shardings=M.param_specs(cfg, wide))
    Q = M.init_params(cfg, seed=0, device="cpu", mesh=square)
    Q, extra = mgr.restore(1, Q, shardings=M.param_specs(cfg, square))
    from repro_torch import convert

    onto_square = {k: _np(v) for k, v in convert.gather_state_dict(
        Q.state_dict(), cfg, square).items()}
    R, _ = mgr.restore(1, M.init_params(cfg, seed=0, device="cpu"))
    return dict(onto_square=onto_square, extra=extra,
                onto_none={k: _np(v) for k, v in R.state_dict().items()},
                block_shapes={k: tuple(v.shape)
                              for k, v in Q.state_dict().items()})


def job_mesh_dry(ctx, arch, model, batch, seq, max_len):
    """The rank's real prefill and one decode step of the reduced model
    under the mesh, each with its collectives (calls, payload and wire
    bytes by kind) and op counts recorded; and its parameter bytes.  The
    dry run's ranks must count the same (``test_torch_dryrun.py``)."""
    from repro_torch.launch.dryrun import count_step
    from repro_torch.models import model as M

    cfg = _lm_cfg(arch, {})
    mesh = ctx.host_mesh(model)
    P = M.init_params(cfg, seed=0, device="cpu", mesh=mesh)
    tok = torch.zeros((batch, seq), dtype=torch.int32)
    out = {"params_bytes": sum(p.numel() * p.element_size()
                               for p in P.parameters())}
    with torch.no_grad():
        (_, cache, pos), out["prefill"] = count_step(
            lambda: M.prefill(cfg, P, tok, max_len, mesh), "cpu")
        nxt = torch.zeros((batch, 1), dtype=torch.int32)
        positions = torch.full((batch, 1), pos, dtype=torch.int32)
        _, out["decode"] = count_step(
            lambda: M.decode_step(cfg, P, cache, nxt, positions, mesh),
            "cpu")
    return out


def _family_mesh(ctx, data, model):
    """The (data, model) mesh over the first data * model ranks (None on
    the others), made once; every rank makes every mesh, in one order."""
    key = ("family", data, model)
    if key not in ctx._host_meshes:
        from repro_torch.launch.mesh import make_host_mesh

        ctx._host_meshes[key] = make_host_mesh(
            model, device="cpu", ranks=range(data * model))
    return ctx._host_meshes[key]


def job_mesh_family(ctx, arch, override, state, batch, steps, max_len,
                    mesh, aux_weight):
    """One family's reduced model under a (data, model) mesh on the full
    ``state``: the gathered prefill logits, decode logits a column of
    ``steps``, the cache gathered leaf by leaf (with each block's shape
    and the shape its ``cache_logical`` spec gives), the state dict
    gathered back, and the train step's step-0 loss and its reduced,
    unclipped gradients (gathered)."""
    from unittest import mock

    from repro_torch import convert
    from repro_torch.dist.sharding import NamedSharding, resolve_spec
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    from repro_torch.train import TrainConfig, make_optimizer, make_train_step
    from repro_torch.train import loop as LOOP

    mesh = _family_mesh(ctx, *mesh)
    if mesh is None:
        return None
    cfg = _lm_cfg(arch, dict(override))
    full = {k: torch.from_numpy(v) for k, v in state.items()}
    P = M.init_params(cfg, device="cpu", mesh=mesh)
    P.load_state_dict(convert.shard_state_dict(full, cfg, mesh))
    b = {k: torch.from_numpy(v) for k, v in batch.items()}
    front = {k: b[k] for k in ("enc_frames", "extra_embeds") if k in b}
    tok = b["tokens"]
    B = tok.shape[0]
    dplace = L.Placement.between_blocks(mesh, B, 1, cfg.d_model)
    lspec = (L.entry_of(dplace.batch), None,
             M._table_sharding(cfg, mesh).spec[0])
    out = {"state": {k: _np(v) for k, v in convert.gather_state_dict(
        P.state_dict(), cfg, mesh).items()}}
    with torch.no_grad():
        logits, cache, pos = M.prefill(cfg, P, tok, max_len, mesh, **front)
        out["prefill"] = _whole(mesh, logits, lspec)
        out["decode"] = []
        for i in range(steps.shape[1]):
            d, cache = M.decode_step(
                cfg, P, cache, torch.from_numpy(steps[:, i:i + 1]),
                torch.full((B, 1), pos + i, dtype=torch.int32), mesh)
            out["decode"].append(_whole(mesh, d, lspec))
    out["pos"] = pos
    out["cache"], out["cache_blocks"] = {}, {}
    logical = M.cache_logical(cfg)
    glob = M.cache_abstract(cfg, B, max_len)

    def walk(tree, gl, lg, name):
        if tree is None:
            return
        if isinstance(tree, dict):
            for k in tree:
                walk(tree[k], gl[k], lg[k], f"{name}.{k}")
            return
        if isinstance(tree, torch.Tensor):
            spec = resolve_spec(gl.shape, lg, mesh)
            out["cache"][name] = _whole(mesh, tree, spec)
            out["cache_blocks"][name] = (tuple(tree.shape), NamedSharding(
                mesh, spec).local_shape(gl.shape))
            return
        for f in tree._fields:
            walk(getattr(tree, f), getattr(gl, f), getattr(lg, f),
                 f"{name}.{f}")

    for f in ("layers", "dense_layers", "enc_out"):
        walk(getattr(cache, f), getattr(glob, f), getattr(logical, f), f)
    tc = TrainConfig(optimizer="adamw", learning_rate=1e-3, warmup_steps=1,
                     aux_weight=aux_weight)
    opt = make_optimizer(tc)
    grads = []
    clip = LOOP.OPT.clip_by_global_norm

    def keep(tree, max_norm, norm=None):
        if not grads:
            grads.append({k: g.detach().clone() for k, g in tree.items()})
        return clip(tree, max_norm, norm)

    with mock.patch.object(LOOP.OPT, "clip_by_global_norm", keep):
        _, _, m = make_train_step(cfg, tc, opt=opt, mesh=mesh)(
            P, opt.init(P), b)
    specs = M.param_specs(cfg, mesh)
    out["loss"] = float(m["loss"])
    out["grad_norm"] = float(m["grad_norm"])
    out["grads"] = {k: _np(specs[k].gather(g)) for k, g in grads[0].items()}
    return out


def job_mesh_steps(ctx, arch, state, tc, batches, mesh):
    """Train steps over a (data, model) mesh (DEFAULT_RULES: the weights
    split over model), int8 compressed where ``tc`` says so: per step
    the loss and the grad norm, then the parameters (and residuals),
    gathered."""
    from repro_torch import convert
    from repro_torch.models import model as M
    from repro_torch.train import (TrainConfig, init_compression_state,
                                   make_optimizer, make_train_step)

    mesh = _family_mesh(ctx, *mesh)
    if mesh is None:
        return None
    cfg = _lm_cfg(arch, {})
    P = M.init_params(cfg, device="cpu", mesh=mesh)
    P.load_state_dict(convert.shard_state_dict(
        {k: torch.from_numpy(v) for k, v in state.items()}, cfg, mesh))
    tc = TrainConfig(**tc)
    opt = make_optimizer(tc)
    st, err = opt.init(P), init_compression_state(P)
    step = make_train_step(cfg, tc, opt=opt, mesh=mesh)
    out = dict(loss=[], grad_norm=[])
    for bt in batches:
        b = {k: torch.from_numpy(v) for k, v in bt.items()}
        if tc.grad_compression == "int8":
            P, st, err, m = step(P, st, err, b)
        else:
            P, st, m = step(P, st, b)
        out["loss"].append(float(m["loss"]))
        out["grad_norm"].append(float(m["grad_norm"]))
    specs = M.param_specs(cfg, mesh)
    out["params"] = {k: _np(v) for k, v in convert.gather_state_dict(
        P.state_dict(), cfg, mesh).items()}
    if tc.grad_compression == "int8":
        out["err"] = {k: _np(specs[k].gather(v)) for k, v in err.items()}
    return out


JOBS = {"product": job_product, "memo": job_memo, "backends": job_backends,
        "traced": job_traced, "halo": job_halo, "lobpcg": job_lobpcg,
        "mesh": job_mesh, "initialized": job_initialized,
        "mesh_moe": job_mesh_moe, "mesh_lm": job_mesh_lm,
        "mesh_int8": job_mesh_int8, "mesh_ckpt": job_mesh_ckpt,
        "mesh_dry": job_mesh_dry, "mesh_family": job_mesh_family,
        "mesh_steps": job_mesh_steps}


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


def mesh_cuda_rank(rank: int, world: int, tmp: str, port: int) -> None:
    """One rank of ``test_torch_cuda.py``'s meshed prefill on the card:
    gloo on CUDA (staged through pinned host memory), a (1, world) mesh,
    the reduced mixtral's prefill through the flash kernel and through
    the plain attention, the whole logits and the launches to
    ``tmp/rank<r>.pkl``."""
    import dataclasses
    import os
    from unittest import mock

    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port),
                      WORLD_SIZE=str(world), RANK=str(rank),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world))
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    from repro_torch.configs import get_reduced_config
    from repro_torch.kernels import flash_attention as KF
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import attention as ATT
    from repro_torch.models import layers as L
    from repro_torch.models import model as M

    mesh = make_host_mesh(world, device="cuda")
    try:
        cfg = get_reduced_config("mixtral-8x22b")
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=8.0))
        P = M.init_params(cfg, seed=4, device=mesh.device, mesh=mesh)
        tok = torch.as_tensor(np.random.default_rng(0).integers(
            0, cfg.vocab, (2, 64)), device=mesh.device)
        spec = (None, None, M._table_sharding(cfg, mesh).spec[0])
        with torch.no_grad():
            KF.reset_launch_counts()
            got = M.prefill(cfg, P, tok, 80, mesh)[0]
            launches = dict(KF.LAUNCHES)
            with mock.patch.object(ATT, "flash_attention",
                                   KF.plain_attention):
                plain = M.prefill(cfg, P, tok, 80, mesh)[0]
        out = dict(kernel=_whole(mesh, got, spec),
                   plain=_whole(mesh, plain, spec), launches=launches,
                   staged=mesh.staged, n_layers=cfg.n_layers)
        with open(Path(tmp) / f"rank{rank}.pkl", "wb") as f:
            pickle.dump(out, f)
    finally:
        torch.distributed.destroy_process_group()
