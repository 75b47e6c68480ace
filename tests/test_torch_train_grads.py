"""The port's gradients and whole train steps against the reference on
the CPU (reduced fp32 configs, weights drawn in the reference's tree and
carried across by ``convert.lm_state_dict``: ``torch_lm_pairs.py``), and
the reference's own train-step criteria
(``tests/test_train_substrate.py``) held on the port.  The losses,
optimizers, data, checkpoints and the launcher are in
``test_torch_train.py``.

Tolerances: every leaf's grad to rtol 1e-4 / atol 1e-5 against
``jax.grad`` of the reference's ``loss_fn`` (fp32, summed in another
order).  A whole step's parameters to 5e-3 at lr 1e-3: Adam's first
step is close to lr * sign(g), so a grad near zero that the two
packages round to opposite signs moves a weight by up to 2e-3 the other
way; the reference's own microbatch test holds 5e-3 for that reason
(``test_train_substrate.py:57``).  Its loss to rtol 1e-4."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the reference-only CI has no torch

import jax
from repro.models import model as RM
from repro.train import TrainConfig as RefTrainConfig
from repro.train import make_optimizer as ref_make_optimizer
from repro.train import make_train_step as ref_make_train_step

from repro_torch import convert
from repro_torch.configs import get_reduced_config
from repro_torch.data import SyntheticTokens
from repro_torch.models import model as M
from repro_torch.train import TrainConfig, make_optimizer, make_train_step
from torch_lm_pairs import batch, loss_kw, pair

torch.set_num_threads(1)

GRAD = dict(rtol=1e-4, atol=1e-5)
STEP_ATOL = 5e-3

# one config of each family; deepseek holds MLA and a leading dense block
FAMILIES = ["gemma-2b", "mixtral-8x22b", "deepseek-v3-671b", "mamba2-780m",
            "jamba-1.5-large-398b", "whisper-small", "internvl2-1b"]


@pytest.mark.parametrize("arch", FAMILIES)
def test_grads_match_reference_leaf_by_leaf(arch):
    cfg, P, rcfg, rp = pair(arch)
    b, rb = batch(cfg)
    P.requires_grad_(True)
    names, leaves = zip(*P.named_parameters())
    loss, _ = M.loss_fn(cfg, P, b["tokens"], b["labels"], **loss_kw(b))
    grads = torch.autograd.grad(loss, leaves)

    def ref_loss(p):
        return RM.loss_fn(rcfg, p, rb["tokens"], rb["labels"],
                          **loss_kw(rb))

    (rloss, _), rgrads = jax.jit(jax.value_and_grad(ref_loss,
                                                    has_aux=True))(rp)
    want = convert.lm_state_dict(jax.tree.map(np.asarray, rgrads))
    assert set(want) == set(names)
    np.testing.assert_allclose(float(loss.detach()), float(rloss),
                               rtol=1e-5)
    for name, g in zip(names, grads):
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), **GRAD,
                                   err_msg=name)
    assert any(float(g.abs().max()) > 0 for g in grads)


@pytest.mark.parametrize("opt_name", ["adamw", "adafactor"])
def test_one_train_step_matches_reference(opt_name):
    """One step of the whole reduced gemma-2b, clip and lr schedule
    included; Adafactor with the stacked grouping (``make_optimizer``'s)
    against the reference's stacked leaves."""
    cfg, P, rcfg, rp = pair("gemma-2b")
    b, rb = batch(cfg, B=4, S=32)
    kw = dict(optimizer=opt_name, learning_rate=1e-3, warmup_steps=1)
    tc, rtc = TrainConfig(**kw), RefTrainConfig(**kw)
    opt, ropt = make_optimizer(tc), ref_make_optimizer(rtc)
    state = opt.init(P)
    # a first step at lr 0 (warmup), so the second runs at lr 1e-3 with
    # moments of two grads
    for _ in range(2):
        P, state, m = make_train_step(cfg, tc, opt)(P, state, b)
    rstep = jax.jit(ref_make_train_step(rcfg, rtc, opt=ropt))
    rstate = ropt.init(rp)
    for _ in range(2):
        rp, rstate, rm = rstep(rp, rstate, rb)
    assert float(m["lr"]) == pytest.approx(1e-3) and int(state.count) == 2
    np.testing.assert_allclose(float(m["loss"]), float(rm["loss"]),
                               rtol=1e-4)
    np.testing.assert_allclose(float(m["grad_norm"]),
                               float(rm["grad_norm"]), rtol=1e-4)
    want = convert.lm_state_dict(jax.tree.map(np.asarray, rp))
    moved = 0.0
    for name, t in P.state_dict().items():
        np.testing.assert_allclose(t.numpy(), want[name].numpy(), rtol=0,
                                   atol=STEP_ATOL, err_msg=name)
        moved = max(moved, float(np.abs(want[name].numpy()).max()))
    assert moved > 0


@pytest.fixture(scope="module")
def setup():
    cfg = get_reduced_config("gemma-2b")
    data = SyntheticTokens(cfg, batch=4, seq=32, seed=0, device="cpu")
    return cfg, data


@pytest.mark.parametrize("opt_name", ["adamw", "adafactor"])
def test_loss_decreases(setup, opt_name):
    """The reference's criterion: a fall of 0.3 in 25 steps over 4
    batches in turn."""
    cfg, data = setup
    P = M.init_params(cfg, device="cpu")
    tc = TrainConfig(optimizer=opt_name, learning_rate=5e-3, warmup_steps=2,
                     total_steps=40, clip_norm=1.0)
    opt = make_optimizer(tc)
    step = make_train_step(cfg, tc, opt=opt)
    state = opt.init(P)
    losses = []
    for i in range(25):
        P, state, m = step(P, state, data.batch_at(i % 4))
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.3, losses[::6]
    assert np.isfinite(losses).all()


def test_microbatch_equals_full_batch(setup):
    """Grad accumulation matches the single-shot gradient step."""
    cfg, data = setup
    b = data.batch_at(0)
    outs = {}
    for mb in (1, 2):
        P = M.init_params(cfg, device="cpu")
        tc = TrainConfig(optimizer="adamw", learning_rate=1e-3,
                         microbatch=mb, warmup_steps=1)
        opt = make_optimizer(tc)
        step = make_train_step(cfg, tc, opt=opt)
        state = opt.init(P)
        for _ in range(2):                 # the second step at lr 1e-3
            P, state, m = step(P, state, b)
        outs[mb] = (P.state_dict(), float(m["loss"]), float(m["grad_norm"]))
    np.testing.assert_allclose(outs[1][1], outs[2][1], rtol=1e-4)
    np.testing.assert_allclose(outs[1][2], outs[2][2], rtol=1e-4)
    d = max(float((outs[1][0][k] - outs[2][0][k]).abs().max())
            for k in outs[1][0])
    assert d < STEP_ATOL
    with pytest.raises(ValueError, match="microbatches"):
        make_train_step(cfg, TrainConfig(microbatch=3))(
            M.init_params(cfg, device="cpu"),
            make_optimizer(TrainConfig()).init(
                M.init_params(cfg, device="cpu")), b)


def test_train_step_on_bf16_params():
    """A bf16 parameter tree (the MoE and jamba configs hold bf16
    parameters) trains in place: the moments fp32, the parameters
    staying bf16, the microbatch grads accumulated in fp32."""
    cfg = get_reduced_config("mixtral-8x22b")
    P = M.init_params(cfg, device="cpu", dtype="bfloat16")
    before = {k: v.clone() for k, v in P.state_dict().items()}
    tc = TrainConfig(learning_rate=1e-2, warmup_steps=1, microbatch=2)
    opt = make_optimizer(tc)
    state = opt.init(P)
    data = SyntheticTokens(cfg, batch=4, seq=16, device="cpu")
    for i in range(2):
        P, state, m = make_train_step(cfg, tc, opt)(P, state,
                                                    data.batch_at(i))
    assert all(p.dtype == torch.bfloat16 for p in P.parameters())
    assert all(t.dtype == torch.float32 for t in state.mu.values())
    assert np.isfinite(float(m["loss"])) and float(m["aux"]) > 0
    changed = sum(not torch.equal(before[k], v)
                  for k, v in P.state_dict().items())
    assert changed == len(before)
