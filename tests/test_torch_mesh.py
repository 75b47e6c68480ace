"""The port's sharded paths on gloo CPU ranks against the reference.

One ``torch.multiprocessing.spawn`` of four ranks
(``tests/torch_dist_ranks.py``) runs, on host meshes (1, 4) and (2, 2):
the three mesh schedules of ``moe_block`` (the all-to-all at S = 32
and S = 8, the EP psum at S = 6 and S = 1, the TP psum with 2 experts over
model = 4, deepseek's shared expert on both), the reduced mixtral and
deepseek models (``forward_train``, ``prefill`` and three
``decode_step``s, ``loss_fn``, the meshed engine's greedy tokens;
mixtral's window cut to 6 so it masks over the sequence-sharded cache)
and a checkpoint saved from (1, 4) and
restored onto (2, 2) and onto no mesh.  A spawn of two ranks runs the
int8 compressed train step for three steps.

The reference side: its meshed ``moe_block`` and its compressed train
step run in a subprocess with four host devices
(``tests/torch_mesh_ref.py``, as ``tests/test_moe_dispatch.py`` runs
its mesh); its meshless model runs here.  Every case gets the same
numpy inputs and weights on both sides.

Tolerances: fp32 at the reference's own mesh test's rtol 2e-4 / atol
2e-5 (``tests/test_moe_dispatch.py``); the models at capacity factor 8
(no pair drops, as that test runs); the MoE at 1.25 too, where drops
are reckoned from each shard's tokens on both sides.  The loss's MoE
aux is a mean of shard-local estimators (that test's note), so the
model's NLL is held and the aux only to its scale.  The int8 step: the
loss and grad norm within the tolerance; each residual within it of
what the reference's value before quantization (its "pre", in quanta,
shifted by any residual the port carried in) leaves after rounding,
except where that value lies within the tolerance's rtol of a rounding
tie (the two sides' global gradients differ in their last bits, and a
tie may round either way): there the residual differs by one quantum.
The parameters within the tolerance of the reference's, and where a
residual moved, within 1e-6 of the reference's AdamW update replayed
on the gradients those residuals give.
"""
import dataclasses
import inspect
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the reference-only CI has no torch

import jax
import jax.numpy as jnp
from repro.configs import get_reduced_config as ref_reduced
from repro.models import layers as RL
from repro.models import model as RM
from repro.models import moe as RMOE
from repro.serve.engine import GenerationConfig as RGen
from repro.serve.engine import ServeEngine as RServe
from repro.train import TrainConfig as RTrainConfig
from repro.train import optimizer as ROPT

from repro_torch import convert
from repro_torch.configs import get_reduced_config
from repro_torch.models import moe as MOE

from torch_dist_ranks import spawn_ranks

TOL = dict(rtol=2e-4, atol=2e-5)
TESTS = Path(__file__).resolve().parent
SRC = TESTS.parent / "src"
B = 4


def _moe_cases():
    out = {}
    for mesh in ((1, 4), (2, 2)):
        for cf in (1.25, 8.0):
            for S in (32, 8, 6, 1):
                out[f"mixtral-{mesh}-cf{cf}-S{S}"] = (
                    "mixtral-8x22b", dict(capacity_factor=cf), mesh, S)
            for S in (32, 1):
                out[f"deepseek-{mesh}-cf{cf}-S{S}"] = (
                    "deepseek-v3-671b", dict(capacity_factor=cf), mesh, S)
    for cf in (1.25, 8.0):
        for S in (32, 1):
            out[f"tp-(1, 4)-cf{cf}-S{S}"] = (
                "mixtral-8x22b", dict(capacity_factor=cf, n_experts=2),
                (1, 4), S)
    return out


MOE_CASES = _moe_cases()
LM_ARCHS = ("mixtral-8x22b", "deepseek-v3-671b")
LM_MODELS = (4, 2)
S_LM, STEPS, MAX_LEN = 16, 3, 20
# mixtral's sliding window cut to 6 positions, so it masks in prefill and
# in decoding against the sequence-sharded cache (global positions)
LM_OVERRIDE = {"mixtral-8x22b": dict(window=6), "deepseek-v3-671b": {}}
INT8_TC = dict(optimizer="adamw", learning_rate=5e-3, warmup_steps=2,
               total_steps=40, clip_norm=1.0, grad_compression="int8")


def _draw(abstract, seed):
    """Numpy parameters of a reference abstract tree (its init rules)."""
    rng = np.random.default_rng(seed)

    def draw(ab):
        if ab.init == "zeros":
            return np.zeros(ab.shape, np.float32)
        if ab.init == "ones":
            return np.ones(ab.shape, np.float32)
        return (ab.scale * rng.standard_normal(ab.shape)).astype(np.float32)

    return jax.tree.map(draw, abstract, is_leaf=RL.is_pab)


def _ref_cfg(arch, **moe):
    rcfg = ref_reduced(arch)
    if moe:
        rcfg = dataclasses.replace(rcfg, moe=dataclasses.replace(rcfg.moe,
                                                                 **moe))
    return rcfg


def _lm_inputs(arch):
    rcfg = dataclasses.replace(_ref_cfg(arch, capacity_factor=8.0),
                               **LM_OVERRIDE[arch])
    rp = _draw(RM.abstract_params(rcfg), 7)
    rng = np.random.default_rng(3)
    tok = rng.integers(0, rcfg.vocab, (B, S_LM)).astype(np.int32)
    steps = rng.integers(0, rcfg.vocab, (B, STEPS)).astype(np.int32)
    return rcfg, rp, tok, steps


def _ref_lm(rcfg, rp, tok, steps):
    """The reference's meshless forward, prefill, decode steps and NLL."""
    p = jax.tree.map(jnp.asarray, rp)
    t = jnp.asarray(tok)
    x, aux = RM.forward_train(rcfg, p, t)
    logits, cache, pos = RM.prefill(rcfg, p, t, MAX_LEN)
    dec = []
    for i in range(STEPS):
        d, cache = RM.decode_step(
            rcfg, p, cache, jnp.asarray(steps[:, i:i + 1]),
            jnp.full((B, 1), pos + i, jnp.int32))
        dec.append(np.asarray(d))
    lab = np.roll(tok, -1, 1)
    lab[:, -1] = -100
    _, (nll, raux) = RM.loss_fn(rcfg, p, t, jnp.asarray(lab))
    engine = RServe(rcfg, p, max_len=MAX_LEN).generate(
        tok, RGen(max_new_tokens=STEPS))
    return dict(hidden=np.asarray(x), prefill=np.asarray(logits),
                decode=dec, nll=float(nll), aux=float(aux),
                engine=np.asarray(engine))


def _int8_inputs():
    rcfg = ref_reduced("gemma-2b")
    rp = _draw(RM.abstract_params(rcfg), 11)
    rng = np.random.default_rng(5)
    batches = []
    for _ in range(3):
        tok = rng.integers(0, rcfg.vocab, (B, 32)).astype(np.int32)
        lab = np.roll(tok, -1, 1)
        batches.append(dict(tokens=tok, labels=lab))
    return rp, batches


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case on both sides: (reference results, port rank results
    of the four-rank spawn, of the two-rank spawn, meshless port MoE)."""
    tmp = tmp_path_factory.mktemp("mesh")
    moe_in, jobs, meshless = {}, [], {}
    for name, (arch, moe, mesh, S) in MOE_CASES.items():
        rcfg = _ref_cfg(arch, **moe)
        params = _draw(RMOE.moe_ab(rcfg), 1)
        x = np.random.default_rng(2).standard_normal(
            (B, S, rcfg.d_model)).astype(np.float32)
        moe_in[name] = dict(arch=arch, moe=moe, mesh=mesh, params=params,
                            x=x)
        jobs.append((f"moe/{name}", "mesh_moe", dict(
            arch=arch, override={"moe": moe}, params=params, x=x,
            model=mesh[1])))
        cfg = get_reduced_config(arch)
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                               **moe))
        with torch.no_grad():
            meshless[name] = MOE.moe_block(cfg, convert_tree(params),
                                           torch.from_numpy(x))[0].numpy()
    rp8, batches = _int8_inputs()
    spec = {"moe": moe_in,
            "int8": dict(arch="gemma-2b", params=rp8, ranks=2, tc=INT8_TC,
                         batches=batches)}
    with open(tmp / "ref_in.pkl", "wb") as f:
        pickle.dump(spec, f)
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    ref_proc = subprocess.Popen(
        [sys.executable, str(TESTS / "torch_mesh_ref.py"),
         str(tmp / "ref_in.pkl"), str(tmp / "ref_out.pkl")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

    lm = {}
    for arch in LM_ARCHS:
        rcfg, rp, tok, steps = _lm_inputs(arch)
        state = {k: v.numpy() for k, v in convert.lm_state_dict(rp).items()}
        for model in LM_MODELS:
            jobs.append((f"lm/{arch}/{model}", "mesh_lm", dict(
                arch=arch, override={"moe": dict(capacity_factor=8.0),
                                     **LM_OVERRIDE[arch]},
                state=state, tokens=tok, steps=steps, max_len=MAX_LEN,
                model=model)))
        lm[arch] = (rcfg, rp, tok, steps)
    jobs.append(("ckpt", "mesh_ckpt", dict(arch="mixtral-8x22b",
                                          directory=str(tmp / "ckpt"))))
    (tmp / "four").mkdir()
    four = spawn_ranks(4, {"jobs": jobs}, tmp / "four")
    state8 = {k: v.numpy() for k, v in convert.lm_state_dict(rp8).items()}
    (tmp / "two").mkdir()
    two = spawn_ranks(2, {"jobs": [("int8", "mesh_int8", dict(
        arch="gemma-2b", state=state8, tc=INT8_TC, batches=batches))]},
        tmp / "two")
    ref_lm = {arch: _ref_lm(*args) for arch, args in lm.items()}
    out, err = ref_proc.communicate(timeout=600)
    assert "MESH_REF_OK" in out, out[-2000:] + err[-4000:]
    with open(tmp / "ref_out.pkl", "rb") as f:
        ref = pickle.load(f)
    ref["lm"] = ref_lm
    return ref, four, two, meshless


def convert_tree(tree):
    if isinstance(tree, dict):
        return {k: convert_tree(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


# ---------------------------------------------------------------- MoE

@pytest.mark.parametrize("name", list(MOE_CASES))
def test_moe_block_schedule_matches_reference_meshed(runs, name):
    ref, four, _, _ = runs
    want = ref["moe"][name]
    for r, res in enumerate(four):
        got = res[f"moe/{name}"]
        np.testing.assert_allclose(got["y"], want["y"], **TOL,
                                   err_msg=f"rank {r}")
        assert got["aux"] == pytest.approx(want["aux"], rel=2e-4, abs=2e-5)
    # every rank holds the same output, bit for bit
    for res in four[1:]:
        np.testing.assert_array_equal(res[f"moe/{name}"]["y"],
                                      four[0][f"moe/{name}"]["y"])


def test_moe_drops_under_a_mesh_differ_from_meshless(runs):
    """At capacity factor 1.25 some case drops pairs the meshless
    capacity keeps (capacity reckoned from each shard's tokens): its
    output leaves the meshless one, while the reference's agrees with
    the port's (the test above)."""
    ref, _, _, meshless = runs
    differ = [n for n in MOE_CASES if "cf1.25" in n and not np.allclose(
        ref["moe"][n]["y"], meshless[n], **TOL)]
    assert differ, "no case at 1.25 dropped a pair"
    for n in MOE_CASES:
        if "cf8.0" in n:
            np.testing.assert_allclose(ref["moe"][n]["y"], meshless[n], **TOL)


# -------------------------------------------------------------- models

@pytest.mark.parametrize("model", LM_MODELS)
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_meshed_model_matches_meshless_reference(runs, arch, model):
    ref, four, _, _ = runs
    want = ref["lm"][arch]
    for res in four:
        got = res[f"lm/{arch}/{model}"]
        np.testing.assert_allclose(got["hidden"], want["hidden"], **TOL)
        np.testing.assert_allclose(got["prefill"], want["prefill"], **TOL)
        for g, w in zip(got["decode"], want["decode"]):
            np.testing.assert_allclose(g, w, **TOL)
        assert got["nll"] == pytest.approx(want["nll"], rel=2e-4)
        assert got["pick_equal"]
        # the meshed engine's greedy tokens, every request on every rank
        np.testing.assert_array_equal(got["engine"], want["engine"])
        # a mean of shard-local load-balance estimators: the same scale
        assert abs(got["aux"] - want["aux"]) < 0.5 * want["aux"] + 0.1


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_meshed_cache_is_split_over_the_sequence(runs, arch):
    """Both reduced models have fewer than 16 kv heads (MLA none): the
    cache is sequence-sharded over model, so decoding ran the
    flash-decoding merge."""
    _, four, _, _ = runs
    for model in LM_MODELS:
        got = four[0][f"lm/{arch}/{model}"]
        assert got["cache_block"][-2] == MAX_LEN // model
        assert got["place"][1] == ("model",)


# ------------------------------------------------------------ training

def _flat(tree):
    """A reference tree as the port's per-layer numpy state dict."""
    return {k: v.numpy() for k, v in convert.lm_state_dict(tree).items()}


def _adamw_replica(want, p0, steps_g):
    """The reference's AdamW (its defaults, the test's TrainConfig) over
    the given per-step gradients of some elements, from ``p0``, with
    the reference's clip scale and learning rate of each step."""
    d = inspect.signature(ROPT.adamw).parameters
    b1, b2, eps = (d[n].default for n in ("b1", "b2", "eps"))
    tc = RTrainConfig(**INT8_TC)
    p, m, v = p0.astype(np.float32), 0.0, 0.0
    for t, g in enumerate(steps_g):
        g = g * min(1.0, tc.clip_norm / max(want["grad_norm"][t], 1e-9))
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        step = (m / (1 - b1 ** (t + 1))) / (
            np.sqrt(v / (1 - b2 ** (t + 1))) + eps) + tc.weight_decay * p
        p = (p - want["lr"][t] * step).astype(np.float32)
    return p


def test_int8_compressed_step_matches_reference(runs):
    ref, _, two, _ = runs
    want = ref["int8"]
    got = two[0]["int8"]
    np.testing.assert_allclose(got["loss"], want["loss"], **TOL)
    np.testing.assert_allclose(got["grad_norm"], want["grad_norm"], **TOL)
    w_err = [_flat(t) for t in want["err"]]
    red = [_flat(t) for t in want["red"]]
    # d[t][k]: the port's residual less the reference's after step t
    d, flipped = [], {}
    for t, g_err in enumerate(got["err"]):
        pre, quantum = _flat(want["pre"][t]), _flat(want["quantum"][t])
        assert set(g_err) == set(w_err[t])
        d.append({})
        for k, w in w_err[t].items():
            # what the port quantized, in quanta: the reference's value
            # shifted by the residual the port carried in
            shift = d[t - 1][k] / quantum[k] if t else 0.0
            x = pre[k] + shift
            expect = (x - np.clip(np.rint(x), -127, 127)) * quantum[k]
            off = ~np.isclose(g_err[k], expect, **TOL)
            # a rounding tie: x within the test's rtol of k + 1/2, and
            # the residuals one quantum apart
            tie = (np.abs(np.abs(x - np.rint(x)) - 0.5)
                   <= TOL["rtol"] * np.abs(x))
            assert (tie | ~off).all(), (t, k, np.flatnonzero(off & ~tie))
            np.testing.assert_allclose(np.abs(g_err[k] - expect)[off],
                                       quantum[k][off], rtol=0.05,
                                       err_msg=f"{t} {k}")
            # two at most a leaf a step (one was seen)
            assert off.sum() <= 2, (t, k, off.sum())
            d[t][k] = g_err[k] - w
            flipped[k] = flipped.get(k, False) | ~np.isclose(g_err[k], w,
                                                             **TOL)
    assert any(f.any() for f in flipped.values()), "no residual moved"
    w_par = _flat(want["params"])
    p0 = _flat(_int8_inputs()[0])
    for k, w in w_par.items():
        same = ~flipped[k]
        np.testing.assert_allclose(got["params"][k][same], w[same],
                                   **TOL, err_msg=k)
        if same.all():
            continue
        # where a residual moved, the reference's update for the port's
        # residuals: step t's reduced gradient moves by d[t-1] - d[t]
        at = ~same
        g = [red[t][k][at] - d[t][k][at] + (d[t - 1][k][at] if t else 0)
             for t in range(len(d))]
        mine = _adamw_replica(want, p0[k][at], g)
        # the replica, given the reference's own gradients, is the
        # reference's update
        np.testing.assert_allclose(_adamw_replica(
            want, p0[k][at], [r[k][at] for r in red]), w[at], rtol=0,
            atol=1e-6, err_msg=k)
        np.testing.assert_allclose(got["params"][k][at], mine, rtol=0,
                                   atol=1e-6, err_msg=k)


def test_int8_replicas_stay_bit_identical(runs):
    _, _, two, _ = runs
    a, b = two[0]["int8"], two[1]["int8"]
    assert a["loss"] == b["loss"]
    for k in a["params"]:
        np.testing.assert_array_equal(a["params"][k], b["params"][k])
    for ea, eb in zip(a["err"], b["err"]):
        for k in ea:
            np.testing.assert_array_equal(ea[k], eb[k])


# ---------------------------------------------------------- checkpoint

def test_checkpoint_saved_on_1x4_restores_on_2x2_and_no_mesh(runs):
    _, four, _, _ = runs
    from repro_torch.models import model as M

    cfg = get_reduced_config("mixtral-8x22b")
    want = {k: v.numpy() for k, v in
            M.init_params(cfg, seed=5, device="cpu").state_dict().items()}
    for res in four:
        got = res["ckpt"]
        assert got["extra"] == {"step": 1}
        for k, w in want.items():
            np.testing.assert_array_equal(got["onto_square"][k], w, k)
            np.testing.assert_array_equal(got["onto_none"][k], w, k)
    # on (2, 2) a rank holds half of the experts' up projections
    up = "blocks.0.ffn.up"
    assert four[0]["ckpt"]["block_shapes"][up][0] == want[up].shape[0] // 2
