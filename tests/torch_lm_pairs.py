"""Shared inputs of the port's training tests (``test_torch_train.py``,
``test_torch_train_grads.py``): a reduced config's parameters in the
reference's tree, drawn with numpy from a seed by the reference's own
init rules (``abstract_params``: each leaf's shape, normal / zeros /
ones and scale), handed to the reference as they are and carried into
the port by ``convert.lm_state_dict``; and one batch as both packages'
tensors.  numpy draws them in milliseconds, where the reference's eager
``init_params`` compiles a random kernel shape by shape (seconds a
config)."""
import dataclasses

import numpy as np
import torch

import jax
import jax.numpy as jnp
from repro.configs import get_reduced_config as ref_reduced
from repro.models import layers as RL
from repro.models import model as RM

from repro_torch import convert
from repro_torch.configs import get_reduced_config
from repro_torch.models import model as M


def _ref_params(rcfg, seed=0):
    rng = np.random.default_rng(seed)
    dtype = jnp.dtype(rcfg.params_dtype)

    def draw(ab):
        if ab.init == "zeros":
            return jnp.zeros(ab.shape, dtype)
        if ab.init == "ones":
            return jnp.ones(ab.shape, dtype)
        return jnp.asarray(ab.scale * rng.standard_normal(ab.shape), dtype)

    return jax.tree.map(draw, RM.abstract_params(rcfg), is_leaf=RL.is_pab)


def pair(arch, **override):
    """(port cfg, port params, reference cfg, reference params) with the
    same weights in both; ``override`` replaces config fields that leave
    the parameter shapes as they are."""
    rcfg = dataclasses.replace(ref_reduced(arch), **override)
    cfg = dataclasses.replace(get_reduced_config(arch), **override)
    rp = _ref_params(rcfg)
    P = M.init_params(cfg, device="cpu")
    P.load_state_dict(convert.lm_state_dict(jax.tree.map(np.asarray, rp)))
    return cfg, P, rcfg, rp


def batch(cfg, B=2, S=32, seed=0):
    """One numpy batch (tokens, labels with -100 last and one masked
    label a row, and the front end's input), as the port's and the
    reference's tensors."""
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    lab = np.roll(tok, -1, axis=1)
    lab[:, -1] = -100
    lab[:, S // 2] = -100
    b = {"tokens": tok, "labels": lab}
    if cfg.family == "encdec":
        b["enc_frames"] = rng.standard_normal(
            (B, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        b["extra_embeds"] = rng.standard_normal(
            (B, cfg.vis_seq, cfg.d_model)).astype(np.float32)
    return ({k: torch.from_numpy(v) for k, v in b.items()},
            {k: jnp.asarray(v) for k, v in b.items()})


def loss_kw(b):
    """The front end's keyword arguments of a batch."""
    return {k: b[k] for k in ("extra_embeds", "enc_frames") if k in b}
