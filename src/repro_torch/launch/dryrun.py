"""Dry run: the per-rank memory, FLOPs and collectives of every (arch x
shape x mesh) cell, traced on the meta device.  Port of the reference's
``repro.launch.dryrun``.

Usage:
  python -m repro_torch.launch.dryrun --arch gemma-2b --shape decode_32k --mesh single
  python -m repro_torch.launch.dryrun --all [--mesh both] [--out experiments/dryrun_torch]

Each cell writes ``<out>/<arch>__<shape>__<mesh>.json``.  No card is
needed: nothing is allocated.

The reference lowers and compiles each cell through XLA on a fake
512-device platform, parses the partitioned HLO and reads
``memory_analysis()``.  The port is explicit SPMD: a rank runs its own
eager op stream and calls every collective by hand.  So the port's dry
run is rank 0 of the production mesh (``make_production_mesh``'s
(16, 16) or (2, 16, 16)) as a dry mesh (``launch.mesh.make_dry_mesh``)
on the meta device, and ``trace_cell`` runs that rank's real step on
it: ``init_params(..., mesh=)`` draws the rank's parameter blocks as
shapes, the optimizer state is ``opt.init``'s on them, the decode cache
the rank's block (``cache_abstract`` laid as ``cache_logical``
resolves), and the step (``loss_fn`` with its grads through
``make_train_step``, ``prefill`` or ``decode_step``) runs under
``op_count.OpCounter`` (dot FLOPs and bytes, the flash op, the peak of
the temporaries) and ``record_collectives`` (calls, payload bytes and
ring-model wire bytes by kind).  ``roofline`` turns those into the
reference's three terms with the H100's constants.  ``op_count``'s
docstring states the scope: the counts are the op stream the port
launches, layer by layer, with no fusion and no loop trip counts.

Every figure is rank 0's.  ``resolve_spec`` never pads, so every
rank's argument bytes are equal; the ranks' step shapes are equal too.
The argument bytes split into parameters, optimizer state, cache and
inputs, each a rank's block as the reference shards it (Adafactor's
factored moments by ``factored_moment_specs``; the inputs: the batch
block, which the port's entry points make from the global batch, a
temporary).  ``argument_bytes`` is that static account; a traced cell
checks its meta tensors against it.

Every runnable cell is traced: every family's prefill and decode, and
every train step, whose backward runs on the meta device too (the
adjoint collectives of ``launch.mesh``, the gradient sums over the
axes a leaf is whole on, the clip's norm and the optimizer's update).
The grid's cells are ``ok`` or a documented ``skip``.  ``--save-hlo``
has no counterpart (there is no HLO) and is refused.
"""
from __future__ import annotations

import argparse
import json
import time
import traceback
from pathlib import Path
from typing import Optional

import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.device import torch_dtype
from repro_torch.dist.sharding import (DEFAULT_RULES, NamedSharding,
                                       factored_moment_specs, resolve_spec,
                                       rules_for, use_rules)
from repro_torch.launch import roofline as R
from repro_torch.launch.mesh import (make_dry_mesh, make_production_mesh,
                                     record_collectives)
from repro_torch.launch.op_count import OpCounter
from repro_torch.launch.shapes import SHAPES, ShapeSpec, cell_status, \
    input_specs
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models.config import ArchConfig
from repro_torch.train import optimizer as OPT
from repro_torch.train.loop import (TrainConfig, make_optimizer,
                                    make_train_step)

DEFAULT_OUT = "experiments/dryrun_torch"


# ------------------------------------------------------------ the blocks

def _block(t: torch.Tensor, logical, mesh) -> torch.Tensor:
    """A rank's block of a tensor of ``t``'s shape laid as ``logical``
    resolves on ``mesh`` (the whole where mesh is None), on meta."""
    shape = tuple(t.shape)
    if mesh is not None:
        shape = NamedSharding(mesh, resolve_spec(shape, logical, mesh)
                              ).local_shape(shape)
    return torch.empty(shape, dtype=t.dtype, device="meta")


def tree_bytes(tree) -> int:
    """Bytes of every tensor of a nest of tuples, lists, dicts and
    modules (None counts 0)."""
    if tree is None:
        return 0
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_bytes(v) for v in tree)
    if isinstance(tree, torch.nn.Module):
        return sum(tree_bytes(p) for p in tree.parameters())
    return 0


def _batch_logical(t: torch.Tensor) -> tuple:
    return ("batch",) + (None,) * (t.ndim - 1)


def param_blocks(cfg: ArchConfig, mesh) -> dict:
    """A rank's block of every parameter, by ``state_dict`` name."""
    dt = torch_dtype(cfg.params_dtype)
    return {n: _block(torch.empty(ab.shape, dtype=dt, device="meta"),
                      ab.logical, mesh)
            for n, ab in L.named_leaves(M.abstract_params(cfg))}


def pick_optimizer_name(cfg: ArchConfig) -> str:
    """The reference's pick: fp32 Adam state for 30 B parameters or more
    does not fit its pod, so it factors the second moments."""
    return "adamw" if cfg.n_params() < 30e9 else "adafactor"


def opt_state_blocks(opt_name: str, cfg: ArchConfig, mesh):
    """A rank's block of the optimizer state: the port's ``opt.init`` on
    the global parameter shapes, each moment cut as the reference shards
    it (AdamW's as its parameter; Adafactor's factored moments by
    ``factored_moment_specs`` of the layer-stacked parameter)."""
    ab = dict(L.named_leaves(M.abstract_params(cfg)))
    opt = make_optimizer(TrainConfig(optimizer=opt_name))
    state = opt.init(dict(L.named_leaves(M.param_shapes(cfg))))
    if opt_name == "adamw":
        return OPT.AdamState(
            mu={n: _block(t, ab[n].logical, mesh)
                for n, t in state.mu.items()},
            nu={n: _block(t, ab[n].logical, mesh)
                for n, t in state.nu.items()},
            count=state.count)
    moments = {}
    for key, (members, stacked) in OPT.layer_groups(ab).items():
        m = state.moments[key]
        logical = (("layers",) if stacked else ()) + tuple(
            ab[members[0]].logical)
        if isinstance(m, OPT.FactoredMoment):
            full = ((len(members),) if stacked else ()) + tuple(
                ab[members[0]].shape)
            if mesh is None:
                moments[key] = m
                continue
            row, col = factored_moment_specs(full, logical, mesh)
            moments[key] = OPT.FactoredMoment(
                row=torch.empty(NamedSharding(mesh, row).local_shape(
                    m.row.shape), dtype=m.row.dtype, device="meta"),
                col=torch.empty(NamedSharding(mesh, col).local_shape(
                    m.col.shape), dtype=m.col.dtype, device="meta"))
        else:
            moments[key] = _block(m, logical, mesh)
    return OPT.AdafactorState(moments=moments, count=state.count)


def _map_cache(fn, tree, logical):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map_cache(fn, tree[k], logical[k]) for k in tree}
    if isinstance(tree, torch.Tensor):
        return fn(tree, logical)
    return type(tree)(*(_map_cache(fn, t, ls)
                        for t, ls in zip(tree, logical)))


def cache_blocks(cfg: ArchConfig, batch: int, max_len: int, mesh,
                 dtype=None) -> M.DecodeCache:
    """A rank's block of the decode cache (``cache_abstract`` laid as
    ``cache_logical`` resolves), ``max_len`` kept under a mesh."""
    ab = M.cache_abstract(cfg, batch, max_len,
                          torch_dtype(dtype or cfg.compute_dtype))
    lg = M.cache_logical(cfg)
    out = M.DecodeCache(*(_map_cache(lambda t, ls: _block(t, ls, mesh),
                                     getattr(ab, f), getattr(lg, f))
                          for f in ("layers", "dense_layers", "enc_out")))
    return out._replace(max_len=None if mesh is None else max_len)


def input_blocks(cfg: ArchConfig, shape: ShapeSpec, mesh) -> dict:
    """A rank's block of each input but the cache: the batch split as
    ``("batch", None, ...)`` resolves."""
    specs = input_specs(cfg, shape)
    if shape.kind == "train":
        specs = specs["batch"]
    return {k: _block(t, _batch_logical(t), mesh)
            for k, t in specs.items() if k != "cache"}


def argument_bytes(cfg: ArchConfig, shape: ShapeSpec, mesh, *,
                   max_len: Optional[int] = None) -> dict:
    """The static account: a rank's argument bytes, split into
    parameters, optimizer state (train), cache (decode) and inputs."""
    out = {"params_bytes": tree_bytes(param_blocks(cfg, mesh)),
           "opt_state_bytes": 0, "cache_bytes": 0,
           "inputs_bytes": tree_bytes(input_blocks(cfg, shape, mesh))}
    if shape.kind == "train":
        out["opt_state_bytes"] = tree_bytes(tuple(opt_state_blocks(
            pick_optimizer_name(cfg), cfg, mesh)))
    if shape.kind == "decode":
        out["cache_bytes"] = tree_bytes(tuple(cache_blocks(
            cfg, shape.global_batch, max_len or shape.seq_len, mesh)))
    out["argument_size_in_bytes"] = sum(out.values())
    return out


def model_flops(cfg: ArchConfig, shape: ShapeSpec) -> float:
    """6 N_active T for a train step, 2 N_active T otherwise (T the
    step's tokens)."""
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    per = 6.0 if shape.kind == "train" else 2.0
    return per * cfg.n_active_params() * tokens


# ------------------------------------------------------------- tracing

def _step(cfg, shape, mesh, max_len):
    """(the rank's traced arguments by part, a thunk that runs its
    step)."""
    specs = input_specs(cfg, shape)
    params = M.init_params(cfg, device="meta", mesh=mesh)
    if shape.kind == "train":
        tc = TrainConfig(optimizer=pick_optimizer_name(cfg))
        opt = make_optimizer(tc)
        step = make_train_step(cfg, tc, opt=opt, mesh=mesh)
        state = opt.init(params)
        batch = specs["batch"]
        return (params, tuple(state), None), lambda: step(params, state,
                                                          batch)
    if shape.kind == "prefill":
        front = {k: v for k, v in specs.items() if k != "tokens"}
        max_len = max_len or shape.seq_len + (
            cfg.vis_seq if cfg.family == "vlm" else 0)
        return (params, None, None), lambda: M.prefill(
            cfg, params, specs["tokens"], max_len, mesh, **front)
    cache = cache_blocks(cfg, shape.global_batch, max_len or shape.seq_len,
                         mesh)
    return (params, None, cache), lambda: M.decode_step(
        cfg, params, cache, specs["tokens"], specs["positions"], mesh)


def count_step(run, device="meta") -> tuple:
    """(``run()``'s result, its counts): the collectives it calls (calls,
    payload bytes and ring-model wire bytes by kind, each under the
    port's kind names) and ``OpCounter``'s counts of its op stream on
    ``device``'s type.  The dry run and a real rank count alike."""
    with record_collectives() as stats, OpCounter(device) as oc:
        out = run()
    return out, dict(oc.counts(), calls=dict(stats.calls),
                     payload_bytes=dict(stats.bytes),
                     wire_bytes=dict(stats.wire))


def cell_rules(cfg: ArchConfig, shape: ShapeSpec):
    """The reference's rule table for a cell: DEFAULT_RULES for decode
    (sequence-sharded caches), ``rules_for(n_params)`` otherwise."""
    return (DEFAULT_RULES if shape.kind == "decode"
            else rules_for(cfg.n_params()))


def trace_cell(cfg: ArchConfig, shape: ShapeSpec, mesh=None, *,
               rules=None, max_len: Optional[int] = None) -> dict:
    """The account of one cell on one rank of ``mesh`` (a dry mesh, or
    None for one device), as ``run_cell`` writes it.  ``rules``: the
    rule table (default the reference's pick: DEFAULT_RULES for decode,
    ``rules_for(n_params)`` otherwise), scoped to the call; ``max_len``
    the cache's length (default the shape's)."""
    skip = cell_status(cfg, shape)
    if skip:
        return {"status": skip}
    rules = rules or cell_rules(cfg, shape)
    n_chips = 1 if mesh is None else mesh.size
    mflops = model_flops(cfg, shape)
    t0 = time.perf_counter()
    with use_rules(rules):
        args = argument_bytes(cfg, shape, mesh, max_len=max_len)
        rank = 0 if mesh is None else mesh.rank
        out = {"rank": rank, "n_chips": n_chips,
               "optimizer": (pick_optimizer_name(cfg)
                             if shape.kind == "train" else None),
               "per_rank": f"rank {rank}'s; resolve_spec never pads, so "
                           "every rank's argument bytes are equal"}
        (params, state, cache), run = _step(cfg, shape, mesh, max_len)
        traced = {"params_bytes": tree_bytes(params),
                  "opt_state_bytes": tree_bytes(state),
                  "cache_bytes": tree_bytes(cache)}
        for k, v in traced.items():
            if v != args[k]:
                raise AssertionError(f"{cfg.name} {shape.name}: the traced "
                                     f"{k} {v} differ from the static "
                                     f"account's {args[k]}")
        grad = torch.enable_grad() if shape.kind == "train" \
            else torch.no_grad()
        with grad:
            _, counts = count_step(run)
    coll = R.CollectiveStats()
    for kind, n in counts["calls"].items():
        coll.add(kind, counts["wire_bytes"][kind], n)
    temp = counts.pop("peak_bytes")
    out.update(
        status="ok",
        memory=dict(args, temp_size_in_bytes=temp),
        bytes_per_device=args["argument_size_in_bytes"] + temp,
        roofline=R.Roofline(
            flops=(counts["dot_flops"] + counts["flash_flops"]) * n_chips,
            hbm_bytes=(counts["dot_bytes"] + counts["flash_bytes"])
            * n_chips,
            wire_bytes=coll.wire_bytes, n_chips=n_chips,
            model_flops=mflops).as_dict(),
        collectives={"by_kind": coll.by_kind, "op_counts": coll.op_counts,
                     "calls": counts["calls"],
                     "payload_bytes": counts["payload_bytes"]},
        op_counts={k: v for k, v in counts.items()
                   if k not in ("wire_bytes", "calls", "payload_bytes")},
        trace_s=time.perf_counter() - t0)
    return out


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             out_dir: Optional[Path] = None) -> dict:
    """One cell of the grid, rank 0 of the production mesh; written to
    ``out_dir/<arch>__<shape>__<mesh>.json`` when out_dir is given."""
    mesh_name = "multi" if multi_pod else "single"
    tag = f"{arch}__{shape_name}__{mesh_name}"
    result = {"arch": arch, "shape": shape_name, "mesh": mesh_name}
    t0 = time.perf_counter()
    try:
        pm = make_production_mesh(multi_pod=multi_pod)
        result.update(trace_cell(get_config(arch), SHAPES[shape_name],
                                 make_dry_mesh(pm.axis_names, pm.sizes)))
        head = str(result["status"]).split(":")[0]
        print(f"[dryrun] {tag}: {head} bytes_per_device="
              f"{result.get('bytes_per_device')} argument_bytes="
              f"{result.get('memory', {}).get('argument_size_in_bytes')} "
              f"bottleneck={result.get('roofline', {}).get('bottleneck')}",
              flush=True)
    except Exception as e:
        result["status"] = f"FAIL: {type(e).__name__}: {e}"
        result["traceback"] = traceback.format_exc()
        print(f"[dryrun] {tag}: FAIL {e}", flush=True)
    result["total_s"] = time.perf_counter() - t0
    if out_dir is not None:
        out_dir.mkdir(parents=True, exist_ok=True)
        with open(out_dir / f"{tag}.json", "w") as f:
            json.dump(result, f, indent=1, default=str)
    return result


def grid(meshes=(False, True)) -> list:
    """Every (arch, shape, multi_pod) of the grid, in the reference's
    order."""
    return [(a, s, mp) for a in ARCH_IDS for s in SHAPES for mp in meshes]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--save-hlo", action="store_true",
                    help="refused: the port traces eager torch ops on the "
                    "meta device and has no HLO to save")
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)
    if args.save_hlo:
        ap.error("--save-hlo: the port traces eager torch ops on the meta "
                 "device and has no HLO to save")
    out = Path(args.out)
    meshes = {"single": (False,), "multi": (True,),
              "both": (False, True)}[args.mesh]
    if args.all:
        cells = grid(meshes)
    else:
        if not (args.arch and args.shape):
            ap.error("give --arch and --shape, or --all")
        cells = [(args.arch, args.shape, mp) for mp in meshes]
    n_fail = 0
    t0 = time.perf_counter()
    for a, s, mp in cells:
        tag = f"{a}__{s}__{'multi' if mp else 'single'}"
        if args.skip_existing and (out / f"{tag}.json").exists():
            prev = json.loads((out / f"{tag}.json").read_text())
            if str(prev.get("status", "")).startswith(("ok", "skip")):
                print(f"[dryrun] {tag}: cached ({prev['status'][:40]})")
                continue
        r = run_cell(a, s, mp, out)
        n_fail += str(r["status"]).startswith("FAIL")
    print(f"[dryrun] done, {len(cells)} runs in "
          f"{time.perf_counter() - t0:.1f} s, failures: {n_fail}")
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
