"""The port's sharding substrate against the reference's, in one process.

``repro_torch.dist.sharding`` (rules, ``resolve_spec``,
``logical_to_mesh``, ``factored_moment_specs``), the parameter and
cache spec trees of every config (``layers.pspec_tree`` /
``model.param_shardings``, ``model.cache_logical``) and the int8
quantization of ``repro_torch.dist.compression``, each held exactly
against the reference's own functions: case by case and in a
hypothesis sweep of shapes, logical names, rules and meshes.  The
reference's functions take a ``jax.sharding.AbstractMesh`` of the same
shape (its current signature: ``AbstractMesh(sizes, names)``).  Also
the single-process parts of the mesh: ``launch.mesh``'s meshes,
``NamedSharding``, ``relayout`` and ``constrain``, the int8 train step
on a one-rank mesh (the reference's convergence contract), and the
families and train steps a mesh does not run yet raising.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the reference-only CI has no torch

import jax
import jax.numpy as jnp
from hypothesis import given, settings
from hypothesis import strategies as st
from jax.sharding import AbstractMesh
from repro.configs import ARCH_IDS
from repro.configs import get_config as ref_config
from repro.dist import compression as RC
from repro.dist import sharding as RS
from repro.models import layers as RL
from repro.models import model as RM

from repro_torch.configs import get_config, get_reduced_config
from repro_torch.dist import compression as C
from repro_torch.dist import sharding as S
from repro_torch.launch import mesh as LM
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models import moe as MOE

MESHES = [(("data", "model"), (16, 16)), (("pod", "data", "model"),
                                           (2, 16, 16)),
          (("data", "model"), (2, 4)), (("data", "model"), (4, 1)),
          (("data", "model"), (1, 4))]


def _meshes(names, sizes):
    return (LM.Mesh(tuple(names), tuple(sizes), abstract=True),
            AbstractMesh(tuple(sizes), tuple(names)))


def _rules(which):
    port = {"default": S.DEFAULT_RULES, "dp": S.DP_RULES,
            "dp_sp": S.DP_RULES.extend(seq_sp=("model",)),
            "embed": S.DEFAULT_RULES.extend(embed=("model",))}[which]
    ref = {"default": RS.DEFAULT_RULES, "dp": RS.DP_RULES,
           "dp_sp": RS.DP_RULES.extend(seq_sp=("model",)),
           "embed": RS.DEFAULT_RULES.extend(embed=("model",))}[which]
    return port, ref


RULES = ("default", "dp", "dp_sp", "embed")

# the reference test file's cases (tests/test_dist_sharding.py)
CASES = [
    ((4096, 16384), ("embed", "mlp")),
    ((64, 64), ("latent", None)),
    ((32, 6, 128, 64), ("batch", "kv", "seq", None)),
    ((2, 6, 128, 64), ("batch", "kv", "seq", None)),
    ((32, 1024), ("batch", "seq")),
    ((256, 512, 64), ("batch", "seq_sp", "embed")),
    ((256, 8, 128, 64), ("attn_batch", "heads", "seq", None)),
    ((4096,), ("embed",)),
    ((32, 16384), ("heads", "mlp")),
    ((160, 5120, 1536), ("experts", "embed", "mlp")),
    ((48, 6144, 128), ("heads", "embed", None)),
]


@pytest.mark.parametrize("rules", RULES)
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: str(m[1]))
@pytest.mark.parametrize("shape,logical", CASES,
                         ids=[str(c[0]) for c in CASES])
def test_resolve_spec_matches_reference(shape, logical, mesh, rules):
    pm, rm = _meshes(*mesh)
    pr, rr = _rules(rules)
    assert tuple(S.resolve_spec(shape, logical, pm, pr)) == tuple(
        RS.resolve_spec(shape, logical, rm, rr))
    assert S.logical_to_mesh(logical, pm, pr) == RS.logical_to_mesh(
        logical, rm, rr)
    if len(shape) >= 2:
        got = S.factored_moment_specs(shape, logical, pm, pr)
        want = RS.factored_moment_specs(shape, logical, rm, rr)
        assert [tuple(s) for s in got] == [tuple(s) for s in want]


NAMES = sorted(k for k, _ in S.DEFAULT_RULES.items()) + [None]


@settings(max_examples=150, deadline=None)
@given(dims=st.lists(st.tuples(st.sampled_from([1, 2, 3, 4, 6, 8, 12, 16,
                                                 32, 48, 64, 256, 6144]),
                               st.sampled_from(NAMES)),
                     min_size=1, max_size=5),
       mesh=st.sampled_from(MESHES), rules=st.sampled_from(RULES))
def test_resolve_spec_sweep_matches_reference(dims, mesh, rules):
    shape = tuple(d for d, _ in dims)
    logical = tuple(n for _, n in dims)
    pm, rm = _meshes(*mesh)
    pr, rr = _rules(rules)
    assert tuple(S.resolve_spec(shape, logical, pm, pr)) == tuple(
        RS.resolve_spec(shape, logical, rm, rr))
    assert S.logical_to_mesh(logical, pm, pr) == RS.logical_to_mesh(
        logical, rm, rr)
    if len(shape) >= 2:
        assert [tuple(s) for s in S.factored_moment_specs(
            shape, logical, pm, pr)] == [tuple(s) for s in
                                         RS.factored_moment_specs(
                                             shape, logical, rm, rr)]


def test_rule_tables_and_scoping_match_reference():
    for name in ("DEFAULT_RULES", "DP_RULES"):
        assert dict(getattr(S, name).items()) == dict(
            getattr(RS, name).items())
    assert S.DP_PARAM_THRESHOLD == RS.DP_PARAM_THRESHOLD
    for n in (1e6, 9.99e9, 10e9, 1e12):
        assert (S.rules_for(n) is S.DP_RULES) == (RS.rules_for(n)
                                                  is RS.DP_RULES)
    r = S.DEFAULT_RULES.extend(embed=("model",))
    assert r.get("embed") == ("model",) and "embed" in r
    assert r != S.DEFAULT_RULES and S.DEFAULT_RULES.get("embed") == ()
    assert hash(S.AxisRules({"a": "x"})) == hash(S.AxisRules({"a": ("x",)}))
    assert S.active_rules() is S.DEFAULT_RULES
    prev = S.set_active_rules(S.DP_RULES)
    assert prev is S.DEFAULT_RULES and S.active_rules() is S.DP_RULES
    S.set_active_rules(prev)
    with S.use_rules(S.DP_RULES) as r:
        assert r is S.DP_RULES and S.active_rules() is S.DP_RULES
    assert S.active_rules() is S.DEFAULT_RULES
    with pytest.raises(TypeError):
        S.set_active_rules({"batch": "data"})


# ------------------------------------------------------------ spec trees

def _ref_specs(tree):
    """{port state_dict name: spec entries} of the reference's stacked
    spec tree: the layer index of ``blocks`` / ``dense_blocks`` /
    ``enc_blocks`` leaves is the port's per-layer name, the stacked
    leading (never sharded) axis dropped."""
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    out = {}
    for path, spec in flat:
        keys = [p.key for p in path]
        out[".".join(keys)] = tuple(spec)
    return out


def _padded(spec, n):
    return tuple(spec) + (None,) * (n - len(spec))


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_shardings_match_reference(arch, multi_pod):
    pm = LM.make_production_mesh(multi_pod=multi_pod)
    rm = AbstractMesh(tuple(pm.sizes), pm.axis_names)
    want = _ref_specs(RL.pspec_tree(RM.abstract_params(ref_config(arch)),
                                    rm))
    got = dict(L.named_leaves(L.pspec_tree(
        M.abstract_params(get_config(arch)), pm)))
    shardings = M.param_specs(get_config(arch), pm)
    ab = dict(L.named_leaves(M.abstract_params(get_config(arch))))
    seen = set()
    for name, spec in got.items():
        parts = name.split(".")
        stacked = len(parts) > 2 and parts[1].isdigit()
        key = ".".join(parts[:1] + parts[2:]) if stacked else name
        seen.add(key)
        n = len(ab[name].shape)
        ref = want[key]
        if stacked:
            assert _padded(ref, n + 1)[0] is None, name
            ref = _padded(ref, n + 1)[1:]
        assert _padded(spec, n) == _padded(ref, n), name
        assert tuple(shardings[name].spec) == tuple(spec)
    assert seen == set(want)


def _ref_cache(tree):
    if type(tree).__name__ == "DecodeCache":
        return {f: _ref_cache(getattr(tree, f)) for f in tree._fields}
    if isinstance(tree, dict):
        return {k: _ref_cache(v) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return {f: tuple(getattr(tree, f)) for f in tree._fields}
    return tree


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_logical_matches_reference(arch):
    got = _ref_cache(M.cache_logical(get_config(arch)))
    got.pop("max_len")
    assert got == _ref_cache(RM.cache_logical(ref_config(arch)))


# ------------------------------------------------------------ compression

@pytest.mark.parametrize("shape,scale", [((64, 64), 1.0), ((3,), 1e-3),
                                         ((5, 7, 2), 1e4), ((8,), 0.0),
                                         ((1000,), 1e-38)])
def test_int8_quantization_bit_equal_to_reference(shape, scale):
    x = (np.random.default_rng(0).standard_normal(shape)
         * scale).astype(np.float32)
    if x.size > 4:
        x.flat[3] = 0.5 * np.abs(x).max() / 127.0 * 3   # a rounding tie
    q, s = C.quantize_int8(torch.from_numpy(x))
    rq, rs = RC.quantize_int8(jnp.asarray(x))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    assert np.float32(s.item()).tobytes() == np.asarray(rs).tobytes()
    np.testing.assert_array_equal(
        C.dequantize_int8(q, s).numpy(), np.asarray(RC.dequantize_int8(rq,
                                                                       rs)))


def test_compressed_psum_error_feedback_matches_reference():
    """The reference's contract on a one-device mesh: the error feedback
    carries the residual, so the mean over steps converges to the
    gradient; step by step equal to the reference's."""
    g = np.random.default_rng(0).standard_normal((64, 64)).astype(np.float32)
    mesh = LM.build_mesh(("data",), (1,), device="cpu")
    rmesh = jax.make_mesh((1,), ("data",))
    err = C.init_error_feedback({"w": torch.from_numpy(g)})
    rerr = RC.init_error_feedback({"w": jnp.asarray(g)})
    acc = torch.zeros(g.shape)
    for _ in range(32):
        out, err = C.compressed_psum_tree({"w": torch.from_numpy(g)}, err,
                                          mesh, "data")
        rout, rerr = RC.compressed_psum_tree({"w": jnp.asarray(g)}, rerr,
                                             rmesh, "data")
        np.testing.assert_array_equal(out["w"].numpy(),
                                      np.asarray(rout["w"]))
        np.testing.assert_allclose(err["w"].numpy(), np.asarray(rerr["w"]),
                                   atol=1e-7)
        acc += out["w"]
    np.testing.assert_allclose((acc / 32).numpy(), g, atol=2e-3)
    with pytest.raises(ValueError, match="compression axis"):
        C.compressed_psum_tree({"w": torch.from_numpy(g)}, err, mesh,
                               "model")


def test_compressed_train_step_converges():
    """The reference's test_compressed_train_step_converges in the port:
    make_train_step(grad_compression='int8') on a one-rank mesh threads
    the residual and still drives the loss down."""
    from repro_torch.data import SyntheticTokens
    from repro_torch.train import (TrainConfig, init_compression_state,
                                   make_optimizer, make_train_step)

    cfg = get_reduced_config("gemma-2b")
    P = M.init_params(cfg, device="cpu")
    data = SyntheticTokens(cfg, batch=4, seq=32, seed=0, device="cpu")
    mesh = LM.build_mesh(("data",), (1,), device="cpu")
    tc = TrainConfig(optimizer="adamw", learning_rate=5e-3, warmup_steps=2,
                     total_steps=40, clip_norm=1.0, grad_compression="int8")
    opt = make_optimizer(tc)
    step = make_train_step(cfg, tc, opt=opt, mesh=mesh)
    state = opt.init(P)
    err = init_compression_state(P)
    losses = []
    for i in range(20):
        P, state, err, m = step(P, state, err, data.batch_at(i % 4))
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.3, losses[::5]
    assert np.isfinite(losses).all()


# ------------------------------------------------------------------ mesh

def test_meshes_and_named_sharding():
    pm = LM.make_production_mesh()
    assert pm.shape == {"data": 16, "model": 16} and pm.size == 256
    assert LM.make_production_mesh(multi_pod=True).shape == {
        "pod": 2, "data": 16, "model": 16}
    with pytest.raises(RuntimeError, match="shape-only"):
        LM.all_reduce(pm, torch.zeros(2), "model")
    m = LM.Mesh(("data", "model"), (2, 4), rank=6, abstract=True)
    assert m.coords == {"data": 1, "model": 2}
    assert m.index(("data", "model")) == 6 and m.count(("data",
                                                        "model")) == 8
    ns = S.NamedSharding(m, S.PartitionSpec(None, ("data", "model")))
    full = torch.arange(3 * 16).view(3, 16)
    assert ns.local_shape((3, 16)) == (3, 2)
    torch.testing.assert_close(ns.shard(full), full[:, 12:14])
    # a block of its own: the global tensor's storage is not kept alive
    rows = S.NamedSharding(m, S.PartitionSpec(("data", "model")))
    block = rows.shard(torch.arange(16 * 3).view(16, 3))
    assert block._base is None
    assert block.untyped_storage().nbytes() == 2 * 3 * 8
    assert S.constrain(full, None, ("batch", "seq")) is full
    one = LM.make_host_mesh(1, device="cpu")
    assert one.shape == {"data": 1, "model": 1} and one.size == 1
    torch.testing.assert_close(S.constrain(full, one, ("batch", "seq")), full)
    from repro_torch.grblas import dist

    dm = dist.device_mesh(device="cpu")
    assert isinstance(dm, LM.Mesh) and dm.shape == {"data": 1}


def test_moe_block_without_a_model_axis_is_meshless():
    """A mesh without a ``model`` axis takes the meshless path, as the
    reference's moe_block does."""
    cfg = get_reduced_config("mixtral-8x22b")
    P = M.init_params(cfg, device="cpu")
    blk = P["blocks"][0]["ffn"]
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 5, cfg.d_model)).astype(np.float32))
    mesh = LM.build_mesh(("data",), (1,), device="cpu")
    with torch.no_grad():
        y, aux = MOE.moe_block(cfg, blk, x, mesh=mesh)
        y0, aux0 = MOE.moe_block(cfg, blk, x)
    assert torch.equal(y, y0) and torch.equal(aux, aux0)


@pytest.mark.parametrize("arch", ["mamba2-780m", "jamba-1.5-large-398b",
                                  "whisper-small", "internvl2-1b"])
def test_families_under_a_mesh_draw_their_blocks(arch):
    """Every family draws under a mesh (ROADMAP item 17.10): rank 0 of
    the production mesh holds each leaf's block as its spec lays it."""
    cfg = get_config(arch)
    mesh = LM.make_dry_mesh(("data", "model"), (16, 16))
    P = M.init_params(cfg, device="meta", mesh=mesh)
    specs = M.param_specs(cfg, mesh)
    shapes = dict(L.named_leaves(M.param_shapes(cfg)))
    for name, t in P.named_parameters():
        assert tuple(t.shape) == specs[name].local_shape(
            shapes[name].shape), name
    # the Mamba2 projections split over model, their column blocks
    if cfg.ssm is not None:
        name = next(n for n in specs if n.endswith("mamba.in_proj"))
        assert specs[name].spec == (None, "model")


@pytest.mark.parametrize("opt_name", ["adamw", "adafactor"])
def test_train_step_over_a_model_axis_runs(opt_name):
    """A train step over a model axis of two ranks (rank 0 of a dry
    (data 1, model 2) mesh, on the meta device): it runs, its backward
    calls the adjoint collectives (a reduce-scatter where the forward
    all-gathered), and it sums a norm scale's gradient over model."""
    from repro_torch.launch.dryrun import count_step
    from repro_torch.data.tokens import batch_specs
    from repro_torch.train import TrainConfig, make_optimizer, make_train_step
    from repro_torch.train import loop as LOOP

    cfg = get_reduced_config("gemma-2b")
    mesh = LM.make_dry_mesh(("data", "model"), (1, 2))
    tc = TrainConfig(optimizer=opt_name)
    opt = make_optimizer(tc)
    P = M.init_params(cfg, device="meta", mesh=mesh)
    state = opt.init(P)
    step = make_train_step(cfg, tc, opt=opt, mesh=mesh)
    with torch.enable_grad():
        (P, state, m), counts = count_step(
            lambda: step(P, state, batch_specs(cfg, 2, 32)))
    assert m["loss"].is_meta and int(state.count) == 1
    fwd = M.forward_train
    with torch.no_grad():
        _, fwd_counts = count_step(lambda: fwd(
            cfg, P, torch.empty((2, 32), dtype=torch.int32, device="meta"),
            mesh))
    assert counts["calls"]["reduce_scatter"] > fwd_counts["calls"][
        "reduce_scatter"]
    assert counts["calls"]["all_gather"] > fwd_counts["calls"]["all_gather"]
    axes = LOOP.leaf_axes(cfg, mesh)
    assert axes["final_norm.scale"][:2] == ((), ("model",))
    assert axes["blocks.0.attn.wq"][:2] == (("model",), ())


def test_vocab_argmax_breaks_ties_to_the_lowest_index():
    logits = torch.tensor([[0.0, 3.0, 3.0, 1.0], [2.0, 2.0, -1.0, 2.0]])
    assert L.vocab_argmax(logits).tolist() == [1, 0]
    assert L.vocab_argmax(logits).tolist() == torch.argmax(logits,
                                                           -1).tolist()


def test_reduced_meshed_step_on_one_rank_equals_meshless():
    """On a (1, 1) mesh every collective is the identity: the meshed
    forward, prefill, decode and loss equal the meshless ones bit for
    bit (the a2a schedule at no-drop capacity)."""
    cfg = get_reduced_config("mixtral-8x22b")
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=8.0))
    mesh = LM.make_host_mesh(1, device="cpu")
    P = M.init_params(cfg, device="cpu")
    Pm = M.init_params(cfg, device="cpu", mesh=mesh)
    tok = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (2, 12)).astype(np.int32))
    with torch.no_grad():
        assert torch.equal(M.forward_train(cfg, P, tok)[0],
                           M.forward_train(cfg, Pm, tok, mesh)[0])
        l0, c0, p0 = M.prefill(cfg, P, tok, 16)
        l1, c1, p1 = M.prefill(cfg, Pm, tok, 16, mesh)
        assert torch.equal(l0, l1) and c1.max_len == 16 and p0 == p1
        pos = torch.full((2, 1), p0, dtype=torch.int32)
        d0, _ = M.decode_step(cfg, P, c0, tok[:, :1], pos)
        d1, _ = M.decode_step(cfg, Pm, c1, tok[:, :1], pos, mesh)
        assert torch.equal(d0, d1)
        with pytest.raises(ValueError, match="max_len"):
            M.decode_step(cfg, Pm, c0, tok[:, :1], pos, mesh)
