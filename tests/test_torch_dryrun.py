"""The port's dry-run accounting against the reference's, on the CPU.

* The shape functions (``param_shapes``, ``count_params``,
  ``cache_abstract``, ``shape_tree``, the three ``*_cache_abstract``
  and ``launch/shapes.py``) give the reference's names, shapes and
  dtypes exactly, for every config and every (arch, shape) pair.
* A rank's argument bytes (parameters, optimizer state, cache, inputs)
  at the production meshes (16, 16) and (2, 16, 16) equal the
  reference's, reckoned from its own shardings on an ``AbstractMesh``
  (``NamedSharding(...).shard_shape``), the train cells' optimizer
  state from ``jax.eval_shape(opt.init, ...)`` under the specs the
  reference's dry run builds (rebuilt here from ``repro.dist.sharding``
  and ``repro.models.model``: importing ``repro.launch.dryrun`` would
  set the process's ``XLA_FLAGS`` for every later subprocess).
* ``roofline.wire_bytes`` equals ``hlo_analysis.parse_collectives`` on
  one synthetic HLO line per kind.
* ``op_count``'s dot FLOPs and dot bytes of a reduced prefill equal
  ``hlo_parse.analyze_hlo`` of the reference's prefill jitted on the
  CPU (fp32, so the CPU keeps every dot's dtype), exactly, once the dots
  one side counts and the other does not are taken out: the reference's
  attention, its ``use_pallas=False`` path's two products QK^T and PV
  (over every (query, key) pair) in each layer, which the port counts
  as its flash op instead.  No other dot differs.
* A dry rank's collectives, shard bytes and op counts equal a real CPU
  rank's (two gloo ranks, ``tests/torch_dist_ranks.py``).
* The launcher writes ``ok`` cells, the ssm family's too; the flash op's
  meta route makes its output's shape and reports its FLOPs.
* Every (arch, shape, mesh) run of the grid traces (``ok``) or is a
  documented ``skip``: no ``partial`` is left (ROADMAP item 17.10).  A
  run of each family and of train steps over the model axis is traced
  here (the whole grid takes minutes; ``chip_smoke.py`` runs it), its
  argument bytes the reference's.
* A train step's dot FLOPs (reduced gemma-2b, one device, fp32, 1024
  positions: train_4k's two or more loss chunks) equal
  ``hlo_parse.analyze_hlo`` of the reference's jitted train step,
  exactly.  The reference's own dry run of gemma-2b train_4k on its
  production mesh fails under the installed jax (a mesh of explicit axes
  under ``with_sharding_constraint``, as its own
  ``tests/test_dryrun_smoke.py`` does), so its HLO at full size is not
  available here.
"""
import dataclasses
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")  # the reference-only CI has no torch

import jax
import jax.numpy as jnp
from jax.sharding import AbstractMesh, NamedSharding
from jax.sharding import PartitionSpec as JP
from repro.configs import ARCH_IDS
from repro.configs import get_config as ref_config
from repro.configs import get_reduced_config as ref_reduced
from repro.dist import sharding as RS
from repro.kernels.flash_attention.ref import attention_ref as ref_attention
from repro.launch import hlo_analysis as RHA
from repro.launch import hlo_parse as RHP
from repro.launch import shapes as RSH
from repro.models import attention as RATT
from repro.models import layers as RL
from repro.models import mamba2 as RSSM
from repro.models import model as RM
from repro.train import loop as RLOOP
from repro.train import optimizer as ROPT

from repro_torch.configs import get_config, get_reduced_config
from repro_torch.launch import dryrun as D
from repro_torch.launch import mesh as LM
from repro_torch.launch import roofline as R
from repro_torch.launch import shapes as SH
from repro_torch.launch.op_count import OpCounter
from repro_torch.dist.sharding import use_rules
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models import attention as ATT
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as SSM
from repro_torch.models import model as M

from torch_dist_ranks import spawn_ranks

TESTS = Path(__file__).resolve().parent
SRC = TESTS.parent / "src"
MESHES = {"single": (("data", "model"), (16, 16)),
          "multi": (("pod", "data", "model"), (2, 16, 16))}


def _dt(dtype) -> str:
    return str(dtype).split(".")[-1]


def _sd(t) -> tuple:
    return tuple(t.shape), _dt(t.dtype)


# ------------------------------------------------------------ shapes

def _ref_leaves(tree, is_leaf=None) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)
    return {".".join(str(getattr(p, "key", getattr(p, "name", p)))
                     for p in path): leaf for path, leaf in flat}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_shapes_and_count_match_reference(arch):
    """Every port leaf is one layer of the reference's stacked leaf (the
    ``layers`` axis leading) or the reference's own leaf; dtypes equal
    in the default and in an explicit dtype."""
    cfg, rcfg = get_config(arch), ref_config(arch)
    for dtype in (None, "bfloat16"):
        want = _ref_leaves(RM.param_shapes(
            rcfg, None if dtype is None else jnp.dtype(dtype)))
        got = dict(L.named_leaves(M.param_shapes(cfg, dtype)))
        stacks = {}
        for name, t in got.items():
            assert t.is_meta, name
            parts = name.split(".")
            if len(parts) > 2 and parts[1].isdigit():
                key = ".".join(parts[:1] + parts[2:])
                stacks.setdefault(key, []).append(_sd(t))
            else:
                assert _sd(t) == _sd(want[name]), name
                stacks[name] = None
        assert set(stacks) == set(want)
        for key, layers in stacks.items():
            if layers is None:
                continue
            assert len(set(layers)) == 1, key
            shape, dt = layers[0]
            assert ((len(layers),) + shape, dt) == _sd(want[key]), key
    ab = M.abstract_params(cfg)
    assert L.count_params(M.param_shapes(cfg)) == L.count_params(ab) \
        == RL.count_params(RM.abstract_params(rcfg))


def test_shape_tree_matches_reference():
    ab = M.abstract_params(get_reduced_config("deepseek-v3-671b"))
    rab = RM.abstract_params(ref_reduced("deepseek-v3-671b"))
    got = L.shape_tree(ab, torch.bfloat16)
    want = RL.shape_tree(rab, jnp.bfloat16)
    assert L.count_params(got) == RL.count_params(rab)
    assert got["embed"]["table"].is_meta
    assert _sd(got["embed"]["table"]) == _sd(want["embed"]["table"])
    assert _sd(got["blocks"][0]["ffn"]["up"]) == (
        want["blocks"]["ffn"]["up"].shape[1:], "bfloat16")


def _cache_tree(c) -> dict:
    """{path: (shape, dtype)} of a decode cache (either package's)."""
    out = {}
    for f in ("layers", "dense_layers", "enc_out"):
        v = getattr(c, f)
        for k, leaf in _ref_leaves(v).items():
            out[f"{f}.{k}"] = _sd(leaf)
    return out


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_abstract_matches_reference(arch):
    cfg, rcfg = get_config(arch), ref_config(arch)
    for dtype, rdtype in ((torch.bfloat16, jnp.bfloat16),
                          (torch.float32, jnp.float32)):
        got = M.cache_abstract(cfg, 3, 24, dtype)
        assert got.max_len is None
        assert all(t.is_meta for t in jax.tree_util.tree_leaves(
            (got.layers, got.dense_layers, got.enc_out)))
        assert _cache_tree(got) == _cache_tree(
            RM.cache_abstract(rcfg, 3, 24, rdtype))
    zeros = M.cache_zeros(get_reduced_config(arch), 2, 8, device="cpu")
    assert _cache_tree(zeros) == _cache_tree(
        M.cache_abstract(get_reduced_config(arch), 2, 8))


@pytest.mark.parametrize("arch", ["gemma-2b", "deepseek-v3-671b",
                                  "mamba2-780m"])
def test_layer_cache_abstracts_match_reference(arch):
    cfg, rcfg = get_config(arch), ref_config(arch)
    if cfg.ssm is not None:
        got, want = SSM.mamba_cache_abstract(cfg, 2), \
            RSSM.mamba_cache_abstract(rcfg, 2, jnp.bfloat16)
    elif cfg.mla is not None:
        got, want = ATT.mla_cache_abstract(cfg, 2, 40), \
            RATT.mla_cache_abstract(rcfg, 2, 40, jnp.bfloat16)
    else:
        got, want = ATT.gqa_cache_abstract(cfg, 2, 40, "float32"), \
            RATT.gqa_cache_abstract(rcfg, 2, 40, jnp.float32)
    assert type(got)._fields == type(want)._fields
    assert all(t.is_meta for t in got)
    assert [_sd(t) for t in got] == [_sd(t) for t in want]


def test_shapes_grid_matches_reference():
    assert list(SH.SHAPES) == list(RSH.SHAPES)
    for name, s in SH.SHAPES.items():
        assert dataclasses.asdict(s) == dataclasses.asdict(RSH.SHAPES[name])


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cell_status_and_input_specs_match_reference(arch):
    cfg, rcfg = get_config(arch), ref_config(arch)
    for name, shape in SH.SHAPES.items():
        rshape = RSH.SHAPES[name]
        assert SH.cell_status(cfg, shape) == RSH.cell_status(rcfg, rshape)
        got, want = SH.input_specs(cfg, shape), RSH.input_specs(rcfg, rshape)
        assert set(got) == set(want), name
        for k in got:
            if k == "cache":
                assert _cache_tree(got[k]) == _cache_tree(want[k])
            elif k == "batch":
                assert {n: _sd(t) for n, t in got[k].items()} == {
                    n: _sd(t) for n, t in want[k].items()}
            else:
                assert got[k].is_meta and _sd(got[k]) == _sd(want[k]), k


# ------------------------------------------------------ argument bytes

def _shard_bytes(sd, spec, mesh) -> int:
    shape = NamedSharding(mesh, spec).shard_shape(sd.shape)
    return math.prod(shape) * jnp.dtype(sd.dtype).itemsize


def _tree_bytes(shapes, specs, mesh) -> int:
    is_spec = lambda x: isinstance(x, JP)
    a = jax.tree.leaves(shapes)
    b = jax.tree.leaves(specs, is_leaf=is_spec)
    assert len(a) == len(b)
    return sum(_shard_bytes(x, s, mesh) for x, s in zip(a, b))


def _ref_opt_specs(opt_name, rcfg, mesh):
    """The reference dry run's optimizer-state specs (its
    ``opt_state_shardings``), rebuilt from its sharding functions."""
    ab = RM.abstract_params(rcfg)
    if opt_name == "adamw":
        t = RL.pspec_tree(ab, mesh)
        return ROPT.AdamState(mu=t, nu=t, count=JP())

    def fact(a):
        if len(a.shape) >= 2:
            row, col = RS.factored_moment_specs(a.shape, a.logical, mesh)
            return ROPT.FactoredMoment(row=row, col=col)
        return RS.resolve_spec(a.shape, a.logical, mesh)

    return ROPT.AdafactorState(
        moments=jax.tree.map(fact, ab, is_leaf=RL.is_pab), count=JP())


def _ref_argument_bytes(rcfg, shape, mesh) -> dict:
    """A rank's argument bytes by part, reckoned from the reference's
    shardings under its rule pick for the cell."""
    rules = (RS.DEFAULT_RULES if shape.kind == "decode"
             else RS.rules_for(rcfg.n_params()))
    prev = RS.set_active_rules(rules)
    try:
        pspecs = RL.pspec_tree(RM.abstract_params(rcfg), mesh)
        out = {"params_bytes": _tree_bytes(RM.param_shapes(rcfg), pspecs,
                                           mesh),
               "opt_state_bytes": 0, "cache_bytes": 0}
        specs = RSH.input_specs(rcfg, shape)

        def batch_bytes(tree):
            return sum(_shard_bytes(sd, RS.resolve_spec(
                sd.shape, ("batch",) + (None,) * (len(sd.shape) - 1), mesh),
                mesh) for sd in jax.tree.leaves(tree))

        if shape.kind == "train":
            name = "adamw" if rcfg.n_params() < 30e9 else "adafactor"
            opt = RLOOP.make_optimizer(RLOOP.TrainConfig(optimizer=name))
            out["opt_state_bytes"] = _tree_bytes(
                jax.eval_shape(opt.init, RM.param_shapes(rcfg)),
                _ref_opt_specs(name, rcfg, mesh), mesh)
            out["inputs_bytes"] = batch_bytes(specs["batch"])
        else:
            cache = specs.pop("cache", None)
            out["inputs_bytes"] = batch_bytes(specs)
            if cache is not None:
                flat, treedef = jax.tree.flatten(cache)
                logical = treedef.flatten_up_to(RM.cache_logical(rcfg))
                out["cache_bytes"] = sum(
                    _shard_bytes(sd, RS.resolve_spec(sd.shape, ls, mesh),
                                 mesh) for sd, ls in zip(flat, logical))
    finally:
        RS.set_active_rules(prev)
    out["argument_size_in_bytes"] = sum(out.values())
    return out


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_argument_bytes_match_reference(arch, mesh):
    names, sizes = MESHES[mesh]
    cfg, rcfg = get_config(arch), ref_config(arch)
    pm = LM.make_production_mesh(multi_pod=mesh == "multi")
    assert (pm.axis_names, pm.sizes) == (names, sizes)
    rm = AbstractMesh(sizes, names)
    for name, shape in SH.SHAPES.items():
        if SH.cell_status(cfg, shape):
            continue
        with use_rules(D.cell_rules(cfg, shape)):
            got = D.argument_bytes(cfg, shape, pm)
        assert got == _ref_argument_bytes(rcfg, RSH.SHAPES[name], rm), name


# --------------------------------------------------------- wire model

@pytest.mark.parametrize("group", [2, 4, 16])
@pytest.mark.parametrize("kind", ["all-gather", "all-reduce",
                                  "reduce-scatter", "all-to-all",
                                  "collective-permute"])
def test_wire_bytes_match_reference_parser(kind, group):
    shape = "bf16[64,1024]{1,0}"
    out_bytes = 64 * 1024 * 2
    line = (f"  %c.1 = {shape} {kind}(bf16[64,1024]{{1,0}} %p.0), "
            f"channel_id=1, replica_groups=[{256 // group},{group}]<=[256]")
    stats = RHA.parse_collectives(line)
    assert stats.op_counts == {kind: 1}
    assert R.wire_bytes(kind, out_bytes, group) == stats.by_kind[kind]
    assert R.wire_bytes(kind.replace("-", "_"), out_bytes, group) \
        == stats.wire_bytes


def test_roofline_terms_and_bottleneck():
    r = R.Roofline(flops=2 * R.PEAK_FLOPS_BF16, hbm_bytes=R.HBM_BW,
                   wire_bytes=3 * R.LINK_BW, n_chips=2, model_flops=1e12)
    d = r.as_dict()
    assert (d["t_compute_s"], d["t_memory_s"], d["t_collective_s"]) == (
        1.0, 0.5, 3.0)
    assert d["bottleneck"] == "collective"
    static = R.Roofline(flops=1.0, hbm_bytes=R.HBM_BW, wire_bytes=None,
                        n_chips=1).as_dict()
    assert static["t_collective_s"] is None
    assert static["bottleneck"] == "memory"


# ------------------------------------------------------------ op counts

def _ref_dots(rcfg, B, S, max_len) -> dict:
    params = RM.init_params(rcfg, jax.random.PRNGKey(0))
    fn = jax.jit(lambda p, t: RM.prefill(rcfg, p, t, max_len)[0])
    return RHP.analyze_hlo(fn.lower(params, jnp.zeros((B, S), jnp.int32))
                           .compile().as_text())


def _ref_attention_dots(cfg, B, S) -> dict:
    if cfg.mla is not None:
        D_, Dv, Hkv = (cfg.mla.nope_dim + cfg.mla.rope_dim, cfg.mla.v_dim,
                       cfg.n_heads)
    else:
        D_ = Dv = cfg.resolved_head_dim
        Hkv = cfg.n_kv_heads
    q = jnp.zeros((B, cfg.n_heads, S, D_), jnp.float32)
    k = jnp.zeros((B, Hkv, S, D_), jnp.float32)
    v = jnp.zeros((B, Hkv, S, Dv), jnp.float32)
    fn = jax.jit(lambda q, k, v: ref_attention(q, k, v, causal=True,
                                               window=cfg.window))
    return RHP.analyze_hlo(fn.lower(q, k, v).compile().as_text())


@pytest.mark.parametrize("arch", ["gemma-2b", "mixtral-8x22b"])
def test_dot_counts_match_reference_hlo(arch):
    """Tolerance: exact.  The reduced configs compute in fp32; the
    reference's attention dots (QK^T and PV of every layer, its plain
    path's) are taken out of its total, the port's flash op is apart."""
    B, S, max_len = 2, 32, 40
    cfg = get_reduced_config(arch)
    assert cfg.compute_dtype == "float32" and S <= 1024
    P = M.init_params(cfg, device="meta")
    with torch.no_grad(), OpCounter("meta") as oc:
        M.prefill(cfg, P, torch.empty((B, S), dtype=torch.int32,
                                      device="meta"), max_len)
    ref = _ref_dots(ref_reduced(arch), B, S, max_len)
    att = _ref_attention_dots(cfg, B, S)
    assert oc.dot_flops == ref["flops"] - cfg.n_layers * att["flops"]
    assert oc.dot_bytes == ref["dot_bytes"] - cfg.n_layers * att["dot_bytes"]
    assert oc.flash_calls == cfg.n_layers
    hd = cfg.resolved_head_dim
    pairs = S * (S + 1) // 2 if not cfg.window or cfg.window >= S else None
    if pairs is not None:
        assert oc.flash_flops == (2 * B * cfg.n_heads * 2 * hd * pairs
                                  * cfg.n_layers)


def test_counts_equal_on_cpu_and_meta():
    """The same prefill counted on the CPU (the plain attention inside
    the flash op, not counted as dots) and on the meta device."""
    cfg = get_reduced_config("deepseek-v3-671b")
    got = {}
    for dev in ("cpu", "meta"):
        P = M.init_params(cfg, device=dev)
        tok = torch.zeros((2, 16), dtype=torch.int32, device=dev)
        with torch.no_grad():
            _, counts = D.count_step(lambda: M.prefill(cfg, P, tok, 20),
                                     dev)
        counts.pop("peak_bytes")
        got[dev] = counts
    assert got["cpu"] == got["meta"]
    assert got["meta"]["flash_calls"] == cfg.n_layers


def test_flash_meta_route_shape_and_flops():
    B, Hq, Hkv, S, D_, Dv = 2, 8, 2, 48, 64, 32
    q = torch.empty((B, Hq, S, D_), dtype=torch.bfloat16, device="meta")
    k = torch.empty((B, Hkv, S, D_), dtype=torch.bfloat16, device="meta")
    v = torch.empty((B, Hkv, S, Dv), dtype=torch.bfloat16, device="meta")
    with OpCounter("meta") as oc:
        out = flash_attention(q, k, v, causal=True, window=16)
    assert out.is_meta and tuple(out.shape) == (B, Hq, S, Dv)
    assert out.dtype == torch.bfloat16
    pairs = sum(min(i + 1, 16) for i in range(S))
    assert oc.flash_calls == 1 and oc.dot_flops == 0
    assert oc.flash_flops == 2 * B * Hq * (D_ + Dv) * pairs
    assert oc.flash_bytes == 2 * (q.numel() + k.numel() + v.numel()
                                  + B * Hq * S * Dv)
    # the pad to D where the kernel does not take Dv is on the meta
    # route too: its buffer counts in the peak
    assert oc.peak_bytes >= 2 * B * Hkv * S * D_


def test_peak_bytes_follow_storages():
    with OpCounter("meta") as oc:
        a = torch.empty(1000, device="meta")          # 4000 bytes
        b = a + 1                                     # 4000 more
        del a
        c = b.view(10, 100)                           # a view: nothing
        d = torch.empty(500, device="meta")           # 2000 more
        assert c.shape == (10, 100) and d.numel() == 500
    assert oc.peak_bytes == 8000 and oc.live_bytes == 6000


# ------------------------------------------------ dry rank vs real ranks

def test_dry_rank_counts_equal_real_cpu_ranks(tmp_path):
    """Reduced mixtral over (data 1, model 2): each dry rank's prefill
    and decode step count the collectives (calls, payload and wire
    bytes by kind), the ops and the parameter bytes of the real gloo
    rank of the same coordinates."""
    arch, B, S, max_len = "mixtral-8x22b", 2, 16, 24
    real = spawn_ranks(2, {"jobs": [("dry", "mesh_dry", dict(
        arch=arch, model=2, batch=B, seq=S, max_len=max_len))]}, tmp_path)
    cfg = get_reduced_config(arch)
    for rank, res in enumerate(real):
        res = res["dry"]
        mesh = LM.make_dry_mesh(("data", "model"), (1, 2), rank)
        P = M.init_params(cfg, device="meta", mesh=mesh)
        assert sum(p.numel() * p.element_size() for p in P.parameters()) \
            == res["params_bytes"]
        tok = torch.empty((B, S), dtype=torch.int32, device="meta")
        with torch.no_grad():
            (_, cache, pos), pre = D.count_step(
                lambda: M.prefill(cfg, P, tok, max_len, mesh))
            one = torch.empty((B, 1), dtype=torch.int32, device="meta")
            _, dec = D.count_step(
                lambda: M.decode_step(cfg, P, cache, one, one, mesh))
        assert pos == S
        for got, want in ((pre, res["prefill"]), (dec, res["decode"])):
            for k in ("calls", "payload_bytes", "wire_bytes", "dot_flops",
                      "dot_bytes", "flash_flops", "flash_bytes", "dots"):
                assert got[k] == want[k], (rank, k)
        assert pre["calls"].get("all_to_all") and dec["calls"]


def test_dry_mesh_collectives_shapes_and_counts():
    mesh = LM.make_dry_mesh(("data", "model"), (2, 4), rank=5)
    assert mesh.coords == {"data": 1, "model": 1} and mesh.dry
    t = torch.empty((4, 6), dtype=torch.bfloat16, device="meta")
    with LM.record_collectives() as st:
        assert LM.all_reduce(mesh, t, ("data", "model")).shape == (4, 6)
        g = LM.all_gather(mesh, t, "model", dim=1)
        assert g.shape == (4, 24) and g.dtype == torch.bfloat16
        assert LM.all_to_all(mesh, t, "model").shape == (4, 6)
        assert LM.reduce_scatter(mesh, t, "model", dim=0).shape == (1, 6)
    assert st.calls == {"all_reduce": 1, "all_gather": 1, "all_to_all": 1,
                        "reduce_scatter": 1}
    assert st.bytes["all_reduce"] == 4 * 6 * 4        # summed in fp32
    assert st.wire["all_reduce"] == (R.wire_bytes("all-reduce", 96, 4)
                                     + R.wire_bytes("all-reduce", 96, 2))
    assert st.wire["all_gather"] == R.wire_bytes("all-gather", 4 * 48, 4)
    assert st.wire["reduce_scatter"] == R.wire_bytes("reduce-scatter", 12, 4)
    assert set(st.seconds.values()) == {0.0}
    with pytest.raises(RuntimeError, match="shape-only"):
        LM.all_reduce(LM.make_production_mesh(), t, "model")


# ------------------------------------------------------------ launcher

def _launch(tmp_path, *argv):
    env = {"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin",
           "HOME": str(tmp_path)}
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", *argv,
         "--out", str(tmp_path)], env=env, capture_output=True, text=True,
        timeout=300)


@pytest.mark.parametrize("arch,shape,status", [
    ("gemma-2b", "decode_32k", "ok"), ("chatglm3-6b", "prefill_32k", "ok"),
    ("mamba2-780m", "prefill_32k", "ok")])
def test_launcher_writes_the_cell(tmp_path, arch, shape, status):
    r = _launch(tmp_path, "--arch", arch, "--shape", shape, "--mesh",
                "single")
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    out = json.loads((tmp_path / f"{arch}__{shape}__single.json")
                     .read_text())
    assert out["status"].split(":")[0] == status, out["status"]
    roof = out["roofline"]
    assert roof["bottleneck"] in ("compute", "memory", "collective")
    assert out["memory"]["argument_size_in_bytes"] > 0
    assert roof["model_flops"] > 0 and out["trace_s"] > 0
    assert out["bytes_per_device"] > out["memory"]["argument_size_in_bytes"]
    assert roof["flops"] > 0
    # decode runs DEFAULT_RULES (collectives over model); a prefill of a
    # model under 10 B parameters is pure DP (rules_for), with none
    collectives = shape == "decode_32k"
    assert (roof["wire_bytes_per_dev"] > 0) == collectives
    assert bool(out["collectives"]["op_counts"]) == collectives


TRACED = [("mamba2-780m", "decode_32k", "single"),
          ("mamba2-780m", "long_500k", "multi"),
          ("jamba-1.5-large-398b", "decode_32k", "single"),
          ("jamba-1.5-large-398b", "long_500k", "single"),
          ("whisper-small", "prefill_32k", "single"),
          ("whisper-small", "decode_32k", "multi"),
          ("whisper-small", "train_4k", "multi"),
          ("internvl2-1b", "prefill_32k", "multi"),
          ("internvl2-1b", "decode_32k", "single"),
          ("internvl2-1b", "train_4k", "single"),
          ("gemma-2b", "train_4k", "single"),
          ("chatglm3-6b", "train_4k", "multi")]


@pytest.mark.parametrize("arch,shape,mesh", TRACED)
def test_grid_run_is_traced_with_the_reference_argument_bytes(arch, shape,
                                                              mesh):
    """Runs that waited for ROADMAP item 17.10 (the ssm, hybrid, encdec
    and vlm families under a mesh, train steps over the model axis of
    16): each traces on rank 0 of its production mesh, ``ok``, with the
    reference's argument bytes on an ``AbstractMesh`` (``trace_cell``
    holds its traced meta tensors to the same account)."""
    names, sizes = MESHES[mesh]
    r = D.run_cell(arch, shape, mesh == "multi")
    assert r["status"] == "ok", r["status"]
    mem = dict(r["memory"])
    mem.pop("temp_size_in_bytes")
    assert mem == _ref_argument_bytes(ref_config(arch), RSH.SHAPES[shape],
                                      AbstractMesh(sizes, names))
    assert r["bytes_per_device"] > mem["argument_size_in_bytes"]
    if shape == "train_4k" or SH.SHAPES[shape].kind == "decode":
        assert r["collectives"]["calls"], r["collectives"]


def test_grid_has_no_partial_run():
    """Every run of the grid is traced or a documented skip: the runs
    that are neither are the skips of ``cell_status``, 14 of 80."""
    runs = D.grid()
    skips = [(a, s) for a, s, _ in runs
             if SH.cell_status(get_config(a), SH.SHAPES[s])]
    assert len(runs) == 80 and len(skips) == 14
    assert not hasattr(D, "PENDING")


def test_train_step_dot_counts_match_reference_hlo():
    """Tolerance: exact.  Reduced gemma-2b, one device, fp32, B 2 x S
    1024 (two loss chunks of 512, as train_4k's eight): the port's
    meta-device count of one train step (forward, backward, AdamW)
    against ``hlo_parse.analyze_hlo`` of the reference's jitted step.
    The flash op's forward is apart; its backward (the plain attention's
    QK^T and PV, recomputed, and their four gradients) and the
    reference's six attention dots a layer are the same count.  At a
    single loss chunk the reference's compiler folds the chunk's
    recomputed logits into the forward, one (B, S, V) product fewer
    (``op_count``'s docstring)."""
    from repro_torch.data.tokens import batch_specs
    from repro_torch.train import TrainConfig, make_optimizer, make_train_step
    from repro.train import TrainConfig as RTrainConfig
    from repro.train import make_optimizer as ref_make_optimizer
    from repro.train import make_train_step as ref_make_train_step
    from torch_lm_pairs import batch, pair

    B, S = 2, 1024
    cfg, _, rcfg, rp = pair("gemma-2b")
    tc = TrainConfig()
    opt = make_optimizer(tc)
    P = M.init_params(cfg, device="meta")
    state = opt.init(P)
    with OpCounter("meta") as oc, torch.enable_grad():
        make_train_step(cfg, tc, opt=opt)(P, state, batch_specs(cfg, B, S))
    rtc = RTrainConfig()
    ropt = ref_make_optimizer(rtc)
    _, rb = batch(cfg, B=B, S=S)
    step = jax.jit(ref_make_train_step(rcfg, rtc, opt=ropt))
    ref = RHP.analyze_hlo(step.lower(rp, ropt.init(rp), rb).compile()
                          .as_text())
    assert oc.dot_flops == ref["flops"]
    assert oc.flash_calls == cfg.n_layers


def test_launcher_refuses_save_hlo(tmp_path):
    r = _launch(tmp_path, "--arch", "gemma-2b", "--shape", "decode_32k",
                "--save-hlo")
    assert r.returncode == 2 and "no HLO" in r.stderr
    assert not list(tmp_path.glob("*.json"))


def test_dry_mesh_runs_no_process_and_real_meshes_are_not_dry():
    assert not LM.make_production_mesh().dry
    assert not LM.make_host_mesh(1, device="cpu").dry
    with pytest.raises(ValueError):
        LM.make_dry_mesh(("data", "model"), (2, 2), rank=4)
    assert os.environ.get("XLA_FLAGS", "").find("512") < 0
