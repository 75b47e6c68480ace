"""The port's training substrate (``repro_torch.train``, ``data``,
``launch.train``, ``models.model.loss_fn`` and ``layers.chunked_xent``)
against the reference on the CPU, with weights drawn in the reference's
tree and carried across by ``convert.lm_state_dict``
(``torch_lm_pairs.py``) and the same numpy inputs; and the
reference's own train-substrate criteria (``tests/test_train_substrate.py``)
held on the port.  The gradients and whole train steps are in
``test_torch_train_grads.py``.

Tolerances: the fp32 losses to rtol 1e-5 (the reference sums the chunk
NLLs in fp64 under x64, the port in fp32); the optimizers' updates on the
same grads to 1e-6; remat against no remat to 1e-6 (the same ops, run
twice).  The synthetic tokens come from ``jax.random`` in the reference
and from a ``torch.Generator`` here, so they are held by their process
and determinism, not token for token."""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the reference-only CI has no torch

import jax
import jax.numpy as jnp
from repro.configs import get_reduced_config as ref_reduced
from repro.models import layers as RL
from repro.models import model as RM
from repro.train import optimizer as ROPT
from repro.train.loop import TrainConfig as RefTrainConfig
from repro.train.loop import lr_schedule as ref_lr_schedule

from repro_torch.configs import ARCH_IDS, get_reduced_config
from repro_torch.data import SyntheticTokens, batch_specs
from repro_torch.launch import train as launch_train
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.train import (CheckpointManager, StepWatchdog, TrainConfig,
                               init_compression_state, lr_schedule,
                               make_train_step, run_with_restarts)
from repro_torch.train import optimizer as OPT
from torch_lm_pairs import batch, loss_kw, pair

torch.set_num_threads(1)

LOSS = dict(rtol=1e-5, atol=0)
UPDATE = dict(rtol=1e-6, atol=1e-6)


# ------------------------------------------------------------ loss_fn


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_loss_fn_matches_reference(arch):
    cfg, P, rcfg, rp = pair(arch)
    b, rb = batch(cfg)
    loss, (nll, aux) = M.loss_fn(cfg, P, b["tokens"], b["labels"],
                                 **loss_kw(b))
    rloss, (rnll, raux) = jax.jit(lambda p: RM.loss_fn(
        rcfg, p, rb["tokens"], rb["labels"], **loss_kw(rb)))(rp)
    np.testing.assert_allclose(float(loss), float(rloss), **LOSS)
    np.testing.assert_allclose(float(nll), float(rnll), **LOSS)
    np.testing.assert_allclose(float(aux), float(raux), rtol=1e-5,
                               atol=1e-6)
    assert (float(aux) > 0) == (cfg.moe is not None)


# ------------------------------------------------------- chunked_xent


@pytest.mark.parametrize("S", [64, 1024])
def test_chunked_xent_matches_reference(S):
    """Padded vocabulary rows (V 520 for 500 real) and masked labels;
    S = 1024 runs two chunks of 512.  The grads of x and the table too."""
    rng = np.random.default_rng(S)
    B, D, V, real = 2, 16, 520, 500
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    tab = rng.standard_normal((V, D)).astype(np.float32)
    lab = rng.integers(0, real, (B, S)).astype(np.int32)
    lab[rng.random((B, S)) < 0.2] = -100
    xt = torch.from_numpy(x).requires_grad_()
    tt = torch.from_numpy(tab).requires_grad_()
    got = L.chunked_xent({"table": tt}, xt, torch.from_numpy(lab),
                         real_vocab=real)
    gx, gt = torch.autograd.grad(got, [xt, tt])

    def ref(x, tab):
        return RL.chunked_xent({"table": tab}, x, jnp.asarray(lab),
                               real_vocab=real)

    want, (wx, wt) = jax.value_and_grad(ref, argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(tab))
    np.testing.assert_allclose(float(got.detach()), float(want), **LOSS)
    np.testing.assert_allclose(gx.numpy(), np.asarray(wx), rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(gt.numpy(), np.asarray(wt), rtol=1e-4,
                               atol=1e-6)


def test_chunked_xent_ragged_length_fails_in_both_packages():
    """The reference splits S = 1101 into 2 chunks of 550 and its
    reshape fails on the 1101st position; the port raises there."""
    x = np.ones((1, 1101, 4), np.float32)
    tab = np.ones((16, 4), np.float32)
    lab = np.zeros((1, 1101), np.int32)
    with pytest.raises(TypeError, match="reshape"):
        RL.chunked_xent({"table": jnp.asarray(tab)}, jnp.asarray(x),
                        jnp.asarray(lab))
    with pytest.raises(ValueError, match="1101 positions"):
        L.chunked_xent({"table": torch.from_numpy(tab)}, torch.from_numpy(x),
                       torch.from_numpy(lab))
    # 1100 = 2 x 550 splits in both
    got = L.chunked_xent({"table": torch.from_numpy(tab)},
                         torch.from_numpy(x[:, :1100]),
                         torch.from_numpy(lab[:, :1100]))
    want = RL.chunked_xent({"table": jnp.asarray(tab)},
                           jnp.asarray(x[:, :1100]),
                           jnp.asarray(lab[:, :1100]))
    np.testing.assert_allclose(float(got), float(want), **LOSS)


# -------------------------------------------------------------- remat


@pytest.mark.parametrize("arch", ["gemma-2b", "jamba-1.5-large-398b",
                                  "whisper-small"])
def test_remat_full_equals_none(arch):
    """Blocks, a hybrid group and the encoder's blocks recomputed in the
    backward give the loss and grads of the plain backward."""
    cfg = get_reduced_config(arch)
    b, _ = batch(cfg)
    outs = []
    for remat in ("none", "full"):
        c = dataclasses.replace(cfg, remat=remat)
        P = M.init_params(c, seed=3, device="cpu").requires_grad_(True)
        loss, _ = M.loss_fn(c, P, b["tokens"], b["labels"], **loss_kw(b))
        outs.append((float(loss.detach()), torch.autograd.grad(
            loss, list(P.parameters()))))
    assert outs[0][0] == pytest.approx(outs[1][0], rel=1e-6)
    for a, g in zip(outs[0][1], outs[1][1]):
        np.testing.assert_allclose(g.numpy(), a.numpy(), rtol=1e-6,
                                   atol=1e-6)


def test_remat_leaves_serving_untouched():
    """Without grad the remat wrapper runs the block as it is: the
    prefill under remat="full" equals "none" bit for bit."""
    cfg = get_reduced_config("gemma-2b")
    b, _ = batch(cfg)
    P = M.init_params(cfg, device="cpu")
    with torch.no_grad():
        a = M.forward_train(cfg, P, b["tokens"])[0]
        c = M.forward_train(dataclasses.replace(cfg, remat="full"), P,
                            b["tokens"])[0]
    assert torch.equal(a, c)


# --------------------------------------------------------- optimizers


def _tree(seed=0):
    """A per-layer tree as the port names it (two layers of a block, an
    embedding), and grads for it, as numpy."""
    rng = np.random.default_rng(seed)
    shapes = {"embed.table": (24, 8), "final_norm.scale": (8,)}
    for i in range(2):
        shapes.update({f"blocks.{i}.attn.wq": (8, 2, 4),
                       f"blocks.{i}.ffn.up": (8, 16),
                       f"blocks.{i}.ln1.scale": (8,)})
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    grads = [{k: rng.standard_normal(s).astype(np.float32) * 10 ** (i - 1)
              for k, s in shapes.items()} for i in range(3)]
    return params, grads


def _stack(t):
    """The reference's layout of a ``_tree``: each per-layer leaf stacked
    on a leading layers axis."""
    out = {k: v for k, v in t.items() if not k.startswith("blocks.")}
    for leaf in ("attn.wq", "ffn.up", "ln1.scale"):
        out[f"blocks.{leaf}"] = np.stack([t[f"blocks.{i}.{leaf}"]
                                          for i in range(2)])
    return out


@pytest.mark.parametrize("name,stacked", [("adamw", True),
                                          ("adafactor", True),
                                          ("adafactor", False)])
def test_optimizer_updates_match_reference(name, stacked):
    """Three updates from the same grads, at a learning rate that
    changes, on the port's per-layer tree against the reference's on
    its stacked tree: Adafactor factors the norm scale across the two
    layers and clips over both, as the reference does.  Unstacked: a
    tree with no layer index, the same leaves in both packages."""
    params, grads = _tree()
    ref_tree = _stack if stacked else (lambda t: t)
    if not stacked:
        params, grads = _stack(params), [_stack(g) for g in grads]
    if name == "adamw":
        opt, ropt = OPT.adamw(), ROPT.adamw()
    else:
        opt = OPT.adafactor(weight_decay=0.01)
        ropt = ROPT.adafactor(weight_decay=0.01)
    P = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    rp = {k: jnp.asarray(v) for k, v in ref_tree(params).items()}
    state, rstate = opt.init(P), ropt.init(rp)
    rupdate = jax.jit(ropt.update)
    if name == "adafactor":               # one moment a (stacked) group
        assert set(state.moments) == set(ref_tree(params))
        assert tuple(state.moments["blocks.ln1.scale"].row.shape) == (2,)
        assert tuple(state.moments["final_norm.scale"].shape) == (8,)
    for i, g in enumerate(grads):
        lr = 1e-2 / (i + 1)
        P, state = opt.update({k: torch.from_numpy(v) for k, v in g.items()},
                              state, P, lr)
        rp, rstate = rupdate({k: jnp.asarray(v)
                              for k, v in ref_tree(g).items()},
                             rstate, rp, jnp.float32(lr))
        got = ref_tree({k: v.numpy() for k, v in P.items()})
        for k, v in got.items():
            np.testing.assert_allclose(v, np.asarray(rp[k]), **UPDATE,
                                       err_msg=f"{k} step {i}")
    assert int(state.count) == 3


def test_layer_groups_invert_lm_state_dict():
    names = ["embed.table", "blocks.0.ln1.scale", "blocks.1.ln1.scale",
             "blocks.10.ln1.scale", "blocks.2.ln1.scale",
             "dense_blocks.0.attn.wq", "blocks.0.sub1.mamba.D",
             "blocks.1.sub1.mamba.D"]
    groups = OPT.layer_groups(names)
    assert groups["embed.table"] == (["embed.table"], False)
    assert groups["blocks.ln1.scale"] == ([
        "blocks.0.ln1.scale", "blocks.1.ln1.scale", "blocks.2.ln1.scale",
        "blocks.10.ln1.scale"], True)
    assert groups["dense_blocks.attn.wq"] == (["dense_blocks.0.attn.wq"],
                                              True)
    assert groups["blocks.sub1.mamba.D"][0] == ["blocks.0.sub1.mamba.D",
                                                "blocks.1.sub1.mamba.D"]
    with pytest.raises(ValueError, match="more than one layer index"):
        OPT.layer_groups(["blocks.0.sub.1.x"])


def test_clip_by_global_norm_and_lr_schedule_match_reference():
    _, grads = _tree(2)
    g = grads[2]                                   # norm well above 1
    got, n = OPT.clip_by_global_norm(
        {k: torch.from_numpy(v.copy()) for k, v in g.items()}, 1.0)
    want, rn = ROPT.clip_by_global_norm({k: jnp.asarray(v)
                                         for k, v in g.items()}, 1.0)
    np.testing.assert_allclose(float(n), float(rn), rtol=1e-6)
    for k in g:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   **UPDATE)
    small = {"w": torch.full((3,), 0.1)}
    assert torch.equal(OPT.clip_by_global_norm(small, 1.0)[0]["w"],
                       torch.full((3,), 0.1))
    for kw in (dict(), dict(warmup_steps=5, total_steps=40),
               dict(warmup_steps=0, total_steps=10)):
        tc, rtc = TrainConfig(**kw), RefTrainConfig(**kw)
        for step in (0, 1, 3, 5, 6, 20, 39, 40, 99, 5000, 20000):
            np.testing.assert_allclose(
                lr_schedule(tc, step),
                float(ref_lr_schedule(rtc, jnp.int32(step))), rtol=1e-6)


def test_adafactor_memory_is_factored():
    cfg = get_reduced_config("gemma-2b")
    P = M.init_params(cfg, device="cpu")
    st = OPT.adafactor().init(P)
    n_par = sum(p.numel() for p in P.parameters())
    n_opt = sum(t.numel() for m in st.moments.values()
                for t in (m if isinstance(m, tuple) else (m,)))
    assert n_opt < 0.2 * n_par, (n_opt, n_par)      # vs 2x for adam
    assert len(st.moments) == 2 + 9                 # one a stacked group


def test_int8_compression_names_the_sharding_item():
    """Item 17.7 ported the compressed step; without a mesh it raises
    the reference's ValueError (its psum axis lives on the mesh)."""
    cfg = get_reduced_config("gemma-2b")
    with pytest.raises(ValueError, match="needs a mesh"):
        make_train_step(cfg, TrainConfig(grad_compression="int8"))
    with pytest.raises(ValueError, match="unknown grad_compression"):
        make_train_step(cfg, TrainConfig(grad_compression="fp8"))
    P = M.init_params(cfg, device="cpu")
    err = init_compression_state(P)
    assert set(err) == set(P.state_dict())
    assert all(t.dtype == torch.float32 and not t.any()
               for t in err.values())


# --------------------------------------------------------------- data


def test_data_deterministic_and_elastic():
    cfg = get_reduced_config("gemma-2b")
    a = SyntheticTokens(cfg, batch=4, seq=32, seed=1,
                        device="cpu").batch_at(17)
    b = SyntheticTokens(cfg, batch=4, seq=32, seed=1,
                        device="cpu").batch_at(17)
    assert torch.equal(a["tokens"], b["tokens"])
    assert torch.equal(a["labels"], b["labels"])
    c = SyntheticTokens(cfg, batch=4, seq=32, seed=1,
                        device="cpu").batch_at(18)
    assert not torch.equal(a["tokens"], c["tokens"])
    d = SyntheticTokens(cfg, batch=4, seq=32, seed=2,
                        device="cpu").batch_at(17)
    assert not torch.equal(a["tokens"], d["tokens"])


def test_data_process_matches_reference():
    """The reference's process: tokens in [0, vocab), each step a drift
    in [-3, 3] mod vocab, the seven drifts about equally likely (as
    jax.random.randint draws them), labels the next token with -100
    last; int32, like the reference's."""
    from repro.data import SyntheticTokens as RefTokens

    cfg = get_reduced_config("gemma-2b")
    v = cfg.vocab
    for src in (SyntheticTokens(cfg, 64, 256, device="cpu").batch_at(0),
                RefTokens(ref_reduced("gemma-2b"), 64, 256).batch_at(0)):
        tok = np.asarray(src["tokens"])
        lab = np.asarray(src["labels"])
        assert tok.dtype == lab.dtype == np.int32
        assert tok.min() >= 0 and tok.max() < v
        drift = (np.diff(tok.astype(np.int64), axis=1) + 3) % v - 3
        assert drift.min() == -3 and drift.max() == 3
        freq = np.bincount(drift.ravel() + 3, minlength=7) / drift.size
        np.testing.assert_allclose(freq, 1 / 7, atol=0.01)
        np.testing.assert_array_equal(lab[:, :-1], tok[:, 1:])
        assert (lab[:, -1] == -100).all()


@pytest.mark.parametrize("arch", ["whisper-small", "internvl2-1b",
                                  "gemma-2b"])
def test_data_front_end_inputs_and_specs(arch):
    cfg = get_reduced_config(arch)
    b = SyntheticTokens(cfg, batch=3, seq=8, device="cpu").batch_at(0)
    specs = batch_specs(cfg, 3, 8)
    want = {"tokens", "labels"} | (
        {"enc_frames"} if cfg.family == "encdec" else set()) | (
        {"extra_embeds"} if cfg.family == "vlm" else set())
    assert set(b) == set(specs) == want
    for k, t in b.items():
        assert specs[k].device.type == "meta"
        assert (t.shape, t.dtype) == (specs[k].shape, specs[k].dtype)
    if "enc_frames" in b:
        assert b["enc_frames"].shape == (3, cfg.enc_seq, cfg.d_model)
        assert abs(float(b["enc_frames"].std()) - 1.0) < 0.1
    if "extra_embeds" in b:
        assert b["extra_embeds"].shape == (3, cfg.vis_seq, cfg.d_model)


# --------------------------------------------------------- checkpoint


def test_checkpoint_roundtrip(tmp_path):
    """A (params, opt_state) tree: the module loaded in place, the
    moments and count as new tensors, a bf16 leaf bit for bit."""
    cfg = get_reduced_config("gemma-2b")
    P = M.init_params(cfg, device="cpu")
    st = OPT.adamw().init(P)
    for m in st.mu.values():
        m.normal_()
    bf = torch.randn(5, 7).to(torch.bfloat16)
    mgr = CheckpointManager(tmp_path, keep=2)
    mgr.save(7, (P, st, {"bf": bf}), extra={"note": "x"})
    manifest = json.loads((tmp_path / "step_7" / "manifest.json").read_text())
    assert manifest["leaves"]["2/bf"]["dtype"] == "bfloat16"
    assert "0/blocks.0.attn.wq" in manifest["leaves"]
    assert "1/mu/blocks.0.attn.wq" in manifest["leaves"]
    Q = M.init_params(cfg, seed=5, device="cpu")
    like = (Q, OPT.adamw().init(Q), {"bf": torch.zeros(5, 7,
                                                       dtype=torch.bfloat16)})
    (Q2, st2, other), extra = mgr.restore(7, like)
    assert extra == {"note": "x"} and Q2 is Q
    for (k, a), b in zip(P.state_dict().items(), Q.state_dict().values()):
        assert torch.equal(a, b), k
    for k in st.mu:
        assert torch.equal(st.mu[k], st2.mu[k])
    assert st2.count.dtype == torch.int32
    assert other["bf"].dtype == torch.bfloat16
    assert torch.equal(other["bf"].view(torch.int16), bf.view(torch.int16))


def test_checkpoint_gc_and_latest(tmp_path):
    small = {"w": torch.ones(3)}
    mgr = CheckpointManager(tmp_path, keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, small)
    (tmp_path / "step_9.tmp").mkdir()          # a crashed save
    assert mgr.latest() == 4
    assert mgr.steps() == [3, 4]              # older GC'd, tmp ignored
    step, tree, _ = mgr.restore_latest({"w": torch.zeros(3)})
    assert step == 4 and torch.equal(tree["w"], small["w"])
    assert CheckpointManager(tmp_path / "empty").restore_latest(small)[0] \
        is None


# ---------------------------------------------------- fault tolerance


def test_run_with_restarts_recovers(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=3)
    crashes = {"left": 2}

    def body(step, state):
        if step == 5 and crashes["left"] > 0:
            crashes["left"] -= 1
            raise RuntimeError("simulated node failure")
        return {"x": state["x"] + 1}

    final_step, state, report = run_with_restarts(
        body, {"x": torch.zeros(())}, mgr, start_step=0, end_step=10,
        save_every=2, max_restarts=5, sleep_fn=lambda s: None)
    assert final_step == 10
    assert report["restarts"] == 2
    assert report["restored_from"] == [4, 4]
    assert float(state["x"]) == 10.0      # no lost or repeated increments


def test_run_with_restarts_resets_to_initial_without_checkpoint(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=3)
    crashes = {"left": 2}
    starts = []

    def body(step, state):
        if step == 0:
            starts.append(float(state["x"]))
        if step == 1 and crashes["left"] > 0:
            crashes["left"] -= 1
            raise RuntimeError("boom before any checkpoint")
        return {"x": state["x"] + 1}

    sleeps = []
    final_step, state, report = run_with_restarts(
        body, {"x": torch.zeros(())}, mgr, start_step=0, end_step=4,
        save_every=100, max_restarts=5, sleep_fn=sleeps.append)
    assert final_step == 4 and float(state["x"]) == 4.0
    assert starts == [0.0, 0.0, 0.0]        # every retry from the initial
    assert report["restored_from"] == ["initial", "initial"]
    assert len(report["errors"]) == 2
    assert all("RuntimeError: boom" in e for e in report["errors"])
    assert isinstance(report["last_error"], RuntimeError)
    assert sleeps == [0.02, 0.04]           # base * 2^restarts, injectable


def test_run_with_restarts_backoff_is_capped(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=3)
    crashes = {"left": 4}

    def body(step, state):
        if crashes["left"] > 0:
            crashes["left"] -= 1
            raise ValueError("flaky")
        return {"x": state["x"] + 1}

    sleeps = []
    _, _, report = run_with_restarts(
        body, {"x": torch.zeros(())}, mgr, start_step=0, end_step=1,
        max_restarts=10, backoff_base=0.5, backoff_cap=1.0,
        sleep_fn=sleeps.append)
    assert sleeps == [1.0, 1.0, 1.0, 1.0]   # capped
    assert report["restarts"] == 4 and report["last_error"] is not None


def test_run_with_restarts_exhaustion_reraises(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=3)

    def body(step, state):
        raise RuntimeError("permanent failure")

    with pytest.raises(RuntimeError, match="permanent failure"):
        run_with_restarts(body, {"x": torch.zeros(())}, mgr,
                          start_step=0, end_step=4, max_restarts=2,
                          sleep_fn=lambda s: None)


def test_watchdog_flags_stragglers():
    wd = StepWatchdog(factor=3.0)
    for i in range(10):
        wd.record(i, 0.1)
    assert wd.record(10, 0.5)
    assert not wd.record(11, 0.12)
    assert len(wd.straggler_steps) == 1


# ----------------------------------------------------------- launcher


def test_launch_train_on_cpu_falls_and_resumes(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    args = ["--arch", "gemma-2b", "--reduced", "--device", "cpu",
            "--batch", "4", "--seq", "32", "--save-every", "10",
            "--log-every", "1", "--ckpt-dir", str(tmp_path / "ck")]
    out = launch_train.main(args + ["--steps", "20"])
    losses = [e["loss"] for e in out["log"]]
    assert np.isfinite(losses).all() and len(losses) == 20
    assert np.mean(losses[-4:]) < np.mean(losses[:4]) - 0.3, losses
    saved = json.loads((tmp_path / "experiments" /
                        "train_gemma-2b.json").read_text())
    assert saved["steps"] == 20 and len(saved["log"]) == 20
    assert sorted(p.name for p in (tmp_path / "ck" / "gemma-2b")
                  .iterdir()) == ["step_10", "step_20"]
    again = launch_train.main(args + ["--steps", "24", "--resume"])
    assert again["start_step"] == 20
    assert [e["step"] for e in again["log"]] == [20, 21, 22, 23]
    assert np.isfinite([e["loss"] for e in again["log"]]).all()
