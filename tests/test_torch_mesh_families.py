"""The ssm, hybrid, encdec and vlm families under a mesh, and train
steps over a model axis, on gloo CPU ranks.

One ``torch.multiprocessing.spawn`` of four CPU ranks
(``tests/torch_dist_ranks.py``, jobs ``mesh_family`` and
``mesh_steps``) runs each reduced config under (data 1, model 2) and
(data 2, model 2) meshes on weights drawn in the reference's tree
(``torch_lm_pairs.pair``): the prefill, two decode steps, the decode
cache and one train step's gradients, all gathered; and three int8
compressed steps over (data 1, model 2) and three Adafactor steps over
(data 2, model 2).  Meanwhile this process runs
the port without a mesh on the same weights and inputs, and the
reference's ``prefill`` / ``decode_step`` and ``jax.grad`` of its
``loss_fn``.

InternVL2's heads are cut to 3 (1 kv head), so they do not divide the
model axis and the batch spreads over it (``attn_batch``), as the full
config's 14 heads do over 4.

Tolerances: the meshed runs against the meshless port 1e-5 relative
(Frobenius, a leaf or an output at a time: the collectives sum the same
fp32 terms in another order); the meshless port against the reference
at ``test_torch_encdec_vlm.py``'s / ``test_torch_mamba2.py``'s LOGITS
(rtol 1e-5, atol 1e-4) and ``test_torch_train_grads.py``'s GRAD (rtol
1e-4, atol 1e-5).  The MoE families' gradients are taken at aux weight
0: under a mesh the router aux is a mean of shard-local estimators,
another function than the meshless one (the reference's too,
``tests/test_moe_dispatch.py``), so only the NLL's gradients are the
same function.  The int8 steps: the losses and grad norms 1e-5
relative to the same steps on a one-rank mesh; each residual (the gradient less its
quantized value, so its error is the gradient's) within 1e-5 of the
leaf's largest gradient and each parameter within 1e-5, except where a
value lay at a rounding tie of the quantizer (the two sides' gradients
differ in their last bits, and a tie may round either way) and where
that moved the next steps' gradients: at most 1% of a leaf, each
residual within a quantum of the one-rank one, each parameter within
the AdamW steps' reach (2 lr a step).
"""
import dataclasses
import pickle
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the reference-only CI has no torch

import jax
import jax.numpy as jnp
from repro.models import model as RM

from repro_torch import convert
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import model as M
from repro_torch.train import (TrainConfig, init_compression_state,
                               make_optimizer, make_train_step)
from repro_torch.train import loop as LOOP
from torch_dist_ranks import _rank_main
from torch_lm_pairs import batch, pair

torch.set_num_threads(1)

REL = 1e-5
LOGITS = dict(rtol=1e-5, atol=1e-4)
GRAD = dict(rtol=1e-4, atol=1e-5)
SERVED = ("mamba2-780m", "jamba-1.5-large-398b", "whisper-small",
          "internvl2-1b")
FAMILIES = ("gemma-2b", "mixtral-8x22b") + SERVED     # the six families
OVERRIDE = {"internvl2-1b": dict(n_heads=3, n_kv_heads=1)}
MESHES = {"1x2": (1, 2), "2x2": (2, 2)}
B, S, STEPS = 4, 32, 2
INT8_TC = dict(optimizer="adamw", learning_rate=5e-3, warmup_steps=2,
               total_steps=40, clip_norm=1.0, grad_compression="int8")
ADAFACTOR_TC = dict(optimizer="adafactor", learning_rate=5e-3,
                    warmup_steps=1, total_steps=40, clip_norm=1.0)


def _aux(cfg):
    return 0.0 if cfg.moe is not None else 0.01


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


def _case(arch):
    override = OVERRIDE.get(arch, {})
    cfg, P, rcfg, rp = pair(arch, **override)
    if cfg.moe is not None:      # no pair drops on either side
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=8.0))
        rcfg = dataclasses.replace(rcfg, moe=dataclasses.replace(
            rcfg.moe, capacity_factor=8.0))
    b, rb = batch(cfg, B=B, S=S)
    steps = np.random.default_rng(9).integers(
        0, cfg.vocab, (B, STEPS)).astype(np.int32)
    P_ = cfg.vis_seq if cfg.family == "vlm" else 0
    return cfg, P, rcfg, rp, b, rb, steps, P_ + S + STEPS


def _grads_of_step(cfg, P, b, mesh=None, aux=0.01):
    """The train step's reduced, unclipped gradients of step 0 and its
    loss (the optimizer's clip is wrapped to keep them)."""
    from unittest import mock

    grads = []
    clip = LOOP.OPT.clip_by_global_norm

    def keep(tree, max_norm, norm=None):
        if not grads:
            grads.append({k: g.detach().clone() for k, g in tree.items()})
        return clip(tree, max_norm, norm)

    tc = TrainConfig(optimizer="adamw", learning_rate=1e-3, warmup_steps=1,
                     aux_weight=aux)
    opt = make_optimizer(tc)
    with mock.patch.object(LOOP.OPT, "clip_by_global_norm", keep):
        _, _, m = make_train_step(cfg, tc, opt=opt, mesh=mesh)(
            P, opt.init(P), b)
    return float(m["loss"]), {k: g.numpy() for k, g in grads[0].items()}


def _meshless(cfg, P, b, steps, max_len):
    front = {k: b[k] for k in ("enc_frames", "extra_embeds") if k in b}
    out = {}
    with torch.no_grad():
        logits, cache, pos = M.prefill(cfg, P, b["tokens"], max_len, **front)
        out["prefill"], out["pos"], out["decode"] = logits.numpy(), pos, []
        for i in range(steps.shape[1]):
            d, cache = M.decode_step(
                cfg, P, cache, torch.from_numpy(steps[:, i:i + 1]),
                torch.full((B, 1), pos + i, dtype=torch.int32))
            out["decode"].append(d.numpy())
    out["cache"] = {}

    def walk(tree, name):
        if tree is None:
            return
        if isinstance(tree, dict):
            for k in tree:
                walk(tree[k], f"{name}.{k}")
        elif isinstance(tree, torch.Tensor):
            out["cache"][name] = tree.numpy()
        else:
            for f in tree._fields:
                walk(getattr(tree, f), f"{name}.{f}")

    for f in ("layers", "dense_layers", "enc_out"):
        walk(getattr(cache, f), f)
    return out


def _reference(rcfg, rp, rb, steps, pos, max_len):
    """The reference's prefill logits and decode steps (at the port's
    next position: P + S for a vlm model) and its loss's gradients."""
    front = {k: rb[k] for k in ("enc_frames", "extra_embeds") if k in rb}
    logits, cache, _ = RM.prefill(rcfg, rp, rb["tokens"], max_len, **front)
    dec = []
    for i in range(steps.shape[1]):
        d, cache = RM.decode_step(rcfg, rp, cache,
                                  jnp.asarray(steps[:, i:i + 1]),
                                  jnp.full((B, 1), pos + i, jnp.int32))
        dec.append(np.asarray(d))
    return dict(prefill=np.asarray(logits), decode=dec)


def _ref_grads(rcfg, rp, rb):
    def loss(p):
        return RM.loss_fn(rcfg, p, rb["tokens"], rb["labels"],
                          aux_weight=_aux(rcfg),
                          **{k: rb[k] for k in ("extra_embeds", "enc_frames")
                             if k in rb})

    (_, _), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(rp)
    return {k: v.numpy() for k, v in convert.lm_state_dict(
        jax.tree.map(np.asarray, g)).items()}


def _int8_batches(cfg):
    rng = np.random.default_rng(5)
    out = []
    for _ in range(3):
        tok = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
        out.append(dict(tokens=tok, labels=np.roll(tok, -1, 1)))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the ranks' results, the meshless port's, the reference's): the
    spawn runs while this process computes the other two."""
    import torch.multiprocessing as mp

    tmp = tmp_path_factory.mktemp("families")
    jobs, cases = [], {}
    for arch in FAMILIES:
        cfg, P, rcfg, rp, b, rb, steps, max_len = _case(arch)
        cases[arch] = (cfg, P, rcfg, rp, b, rb, steps, max_len)
        state = {k: v.numpy() for k, v in P.state_dict().items()}
        for name, mesh in MESHES.items():
            override = dict(OVERRIDE.get(arch, {}))
            if cfg.moe is not None:
                override["moe"] = dict(capacity_factor=8.0)
            jobs.append((f"{arch}/{name}", "mesh_family", dict(
                arch=arch, override=override, state=state,
                batch={k: v.numpy() for k, v in b.items()}, steps=steps,
                max_len=max_len, mesh=mesh, aux_weight=_aux(cfg))))
    g_cfg, g_P = cases["gemma-2b"][:2]
    g_state = {k: v.numpy() for k, v in g_P.state_dict().items()}
    batches = _int8_batches(g_cfg)
    jobs.append(("int8", "mesh_steps", dict(
        arch="gemma-2b", state=g_state, tc=INT8_TC, batches=batches,
        mesh=(1, 2))))
    jobs.append(("adafactor", "mesh_steps", dict(
        arch="gemma-2b", state=g_state, tc=ADAFACTOR_TC, batches=batches,
        mesh=(2, 2))))
    with open(tmp / "spec.pkl", "wb") as f:
        pickle.dump({"jobs": jobs}, f)
    ctx = mp.start_processes(_rank_main, args=(4, str(tmp)), nprocs=4,
                             join=False, start_method="spawn")
    local, ref = {}, {}
    for arch, (cfg, P, rcfg, rp, b, rb, steps, max_len) in cases.items():
        out = _meshless(cfg, P, b, steps, max_len) if arch in SERVED else {}
        out["loss"], out["grads"] = _grads_of_step(cfg, _fresh(cfg, P), b,
                                                   aux=_aux(cfg))
        local[arch] = out
        ref[arch] = dict(grads=_ref_grads(rcfg, rp, rb))
        if arch in SERVED:
            ref[arch].update(_reference(rcfg, rp, rb, steps, out["pos"],
                                        max_len))
    local["int8"] = _int8_one_rank(g_cfg, g_state, batches)
    local["adafactor"] = _steps_meshless(g_cfg, g_state, batches)
    while not ctx.join():
        pass
    ranks = []
    for r in range(4):
        with open(tmp / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    return ranks, local, ref


def _fresh(cfg, P):
    """A copy of P's weights in a tree of their own (the step writes in
    place)."""
    Q = M.init_params(cfg, device="cpu")
    Q.load_state_dict(P.state_dict())
    return Q


def _int8_one_rank(cfg, state, batches):
    """The int8 steps on a one-rank (1, 1) mesh: every collective the
    identity, the quantizer's scale over the whole leaf."""
    mesh = make_host_mesh(1, device="cpu")
    P = M.init_params(cfg, device="cpu", mesh=mesh)
    P.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    tc = TrainConfig(**INT8_TC)
    opt = make_optimizer(tc)
    st, err = opt.init(P), init_compression_state(P)
    step = make_train_step(cfg, tc, opt=opt, mesh=mesh)
    out = dict(loss=[], grad_norm=[])
    for bt in batches:
        P, st, err, m = step(P, st, err, {k: torch.from_numpy(v)
                                          for k, v in bt.items()})
        out["loss"].append(float(m["loss"]))
        out["grad_norm"].append(float(m["grad_norm"]))
    out["params"] = {k: v.detach().numpy().copy()
                     for k, v in P.state_dict().items()}
    out["err"] = {k: v.numpy() for k, v in err.items()}
    return out


def _steps_meshless(cfg, state, batches):
    """ADAFACTOR_TC's steps without a mesh."""
    P = M.init_params(cfg, device="cpu")
    P.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    tc = TrainConfig(**ADAFACTOR_TC)
    opt = make_optimizer(tc)
    st = opt.init(P)
    step = make_train_step(cfg, tc, opt=opt)
    out = dict(loss=[], grad_norm=[])
    for bt in batches:
        P, st, m = step(P, st, {k: torch.from_numpy(v)
                                for k, v in bt.items()})
        out["loss"].append(float(m["loss"]))
        out["grad_norm"].append(float(m["grad_norm"]))
    out["params"] = {k: v.detach().numpy().copy()
                     for k, v in P.state_dict().items()}
    return out


def _ranks_of(ranks, key):
    return [res[key] for res in ranks if res[key] is not None]


# ------------------------------------------------------------- serving

@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", SERVED)
def test_meshed_prefill_and_decode_equal_meshless(runs, arch, mesh):
    ranks, local, _ = runs
    want = local[arch]
    got_all = _ranks_of(ranks, f"{arch}/{mesh}")
    assert len(got_all) == MESHES[mesh][0] * MESHES[mesh][1]
    for got in got_all:
        assert got["pos"] == want["pos"]
        assert _rel(got["prefill"], want["prefill"]) <= REL
        for g, w in zip(got["decode"], want["decode"]):
            assert _rel(g, w) <= REL
    for got in got_all[1:]:      # every rank gathers the same logits
        np.testing.assert_array_equal(got["prefill"], got_all[0]["prefill"])


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", SERVED)
def test_meshed_cache_follows_cache_logical(runs, arch, mesh):
    """Each cache leaf's block has the shape its ``cache_logical`` spec
    gives, and the blocks gathered are the meshless cache."""
    ranks, local, _ = runs
    want = local[arch]["cache"]
    for got in _ranks_of(ranks, f"{arch}/{mesh}"):
        assert set(got["cache"]) == set(want)
        for name, (block, spec_block) in got["cache_blocks"].items():
            assert block == spec_block, name
            assert _rel(got["cache"][name], want[name]) <= REL, name
    # a sharded cache on a model axis of 2: some leaf is split
    got = _ranks_of(ranks, f"{arch}/{mesh}")[0]
    assert any(b != got["cache"][n].shape
               for n, (b, _) in got["cache_blocks"].items())


@pytest.mark.parametrize("arch", SERVED)
def test_meshless_serving_matches_reference(runs, arch):
    _, local, ref = runs
    np.testing.assert_allclose(local[arch]["prefill"], ref[arch]["prefill"],
                               **LOGITS)
    for g, w in zip(local[arch]["decode"], ref[arch]["decode"]):
        np.testing.assert_allclose(g, w, **LOGITS)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", SERVED)
def test_state_dict_gathers_back_whole(runs, arch, mesh):
    """``convert.shard_state_dict`` then ``gather_state_dict`` give the
    whole tree back, bit for bit: the Mamba2, encoder, cross-attention
    and patch-path leaves included."""
    ranks, _, _ = runs
    want = {k: v.numpy() for k, v in _case(arch)[1].state_dict().items()}
    for got in _ranks_of(ranks, f"{arch}/{mesh}"):
        assert set(got["state"]) == set(want)
        for k, w in want.items():
            np.testing.assert_array_equal(got["state"][k], w, k)


# ------------------------------------------------------------ training

@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", FAMILIES)
def test_step0_grads_over_a_model_axis_equal_one_process(runs, arch, mesh):
    """Every leaf, the replicated ones (norm scales, whole leaves of the
    divisibility fallback, Mamba2's A_log / D / dt_bias) included."""
    ranks, local, _ = runs
    want = local[arch]
    for got in _ranks_of(ranks, f"{arch}/{mesh}"):
        assert abs(got["loss"] - want["loss"]) <= REL * abs(want["loss"])
        assert set(got["grads"]) == set(want["grads"])
        bad = {k: _rel(g, want["grads"][k]) for k, g in got["grads"].items()
               if not _rel(g, want["grads"][k]) <= REL}
        assert not bad, bad


@pytest.mark.parametrize("arch", FAMILIES)
def test_one_process_grads_match_reference(runs, arch):
    _, local, ref = runs
    want = ref[arch]["grads"]
    assert set(want) == set(local[arch]["grads"])
    for k, g in local[arch]["grads"].items():
        np.testing.assert_allclose(g, want[k], **GRAD, err_msg=k)


def test_int8_steps_over_a_model_axis_equal_one_rank(runs):
    ranks, local, _ = runs
    want = local["int8"]
    got_all = _ranks_of(ranks, "int8")
    assert len(got_all) == 2
    lr_bound = 2 * INT8_TC["learning_rate"] * len(want["loss"])
    for got in got_all:
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=REL)
        np.testing.assert_allclose(got["grad_norm"], want["grad_norm"],
                                   rtol=REL)
        for k, w in want["err"].items():
            g = got["err"][k]
            # a residual is c - deq(c): its error is c's, 1e-5 of the
            # leaf's largest |c|, 127 quanta; a quantum is at least
            # twice the largest residual (a residual is at most half one)
            quantum = 2 * float(np.abs(w).max())
            off = ~np.isclose(g, w, rtol=0, atol=REL * 127 * quantum)
            # a tie, and where it moved the next steps' gradients: at
            # most 1% of a leaf, each within a quantum and the tolerance
            assert off.mean() <= 0.01, (k, off.sum())
            assert (np.abs(g - w)[off]
                    <= (1 + 2 * REL * 127) * quantum).all(), k
            p, pw = got["params"][k], want["params"][k]
            np.testing.assert_allclose(p[~off], pw[~off], rtol=REL,
                                       atol=REL, err_msg=k)
            # where the residuals differ, AdamW moved the two by at most
            # its step (lr a step) each
            assert (np.abs(p - pw)[off] <= lr_bound).all(), k
    for got in got_all[1:]:
        for k in got["params"]:
            np.testing.assert_array_equal(got["params"][k],
                                          got_all[0]["params"][k])


def test_adafactor_steps_over_both_axes_equal_meshless(runs):
    """Three Adafactor steps over (data 2, model 2): its factored row
    and column means, the row mean of the row moment and the update
    clip's RMS taken over a leaf's blocks on every rank, and the clip's
    global norm, give the meshless steps' parameters."""
    ranks, local, _ = runs
    want = local["adafactor"]
    for got in _ranks_of(ranks, "adafactor"):
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=REL)
        np.testing.assert_allclose(got["grad_norm"], want["grad_norm"],
                                   rtol=REL)
        bad = {k: _rel(g, want["params"][k]) for k, g in got["params"].items()
               if not _rel(g, want["params"][k]) <= REL}
        assert not bad, bad
