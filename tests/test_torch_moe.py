"""The port's MoE (``repro_torch.models.moe``), MLA attention and the flash
op's narrower value head dim against the reference, on the CPU.

Reduced configs (``get_reduced_config``: mixtral 4 experts top 2,
deepseek 4 routed experts top 2 plus 1 shared, MLA ranks 32/16); the
reference's weights carried across as numpy arrays, inputs from numpy
seeds, the reference run eagerly and meshless, as its own tests run it.

Tolerances: in fp32, activations rtol/atol 1e-5 (the parity tests'
bound); routing (expert ids, queue slots, keep, token indices) exactly."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the reference-only CI has no torch

import jax
import jax.numpy as jnp
from repro.configs import get_reduced_config as ref_reduced
from repro.kernels.flash_attention.ref import attention_ref as ref_attention
from repro.kernels.flash_attention.ref import \
    attention_ref_chunked as ref_chunked
from repro.models import attention as RATT
from repro.models import layers as RL
from repro.models import moe as RMOE

from repro_torch.configs import get_reduced_config
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_attention.flash_attention import \
    check_operands
from repro_torch.models import attention as ATT
from repro_torch.models import moe as MOE

torch.set_num_threads(1)

ACT = dict(rtol=1e-5, atol=1e-5)
MOE_ARCHS = ["mixtral-8x22b", "deepseek-v3-671b"]


def _cfgs(arch, **moe):
    """(port cfg, reference cfg), the MoE config overridden by ``moe``."""
    cfg, rcfg = get_reduced_config(arch), ref_reduced(arch)
    if moe:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                               **moe))
        rcfg = dataclasses.replace(rcfg, moe=dataclasses.replace(rcfg.moe,
                                                                 **moe))
    return cfg, rcfg


def _init(abstract, seed):
    """The reference's parameters for an abstract tree: (numpy tree,
    jax tree)."""
    rp = RL.init_tree(abstract, jax.random.PRNGKey(seed), jnp.float32)
    return jax.tree.map(np.asarray, rp), rp


def _torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("T", [1, 3, 8, 24, 100, 4096])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_capacity_matches_reference(arch, T):
    for cf in (1.25, 0.3, 2.0):
        cfg, rcfg = _cfgs(arch, capacity_factor=cf)
        assert MOE._capacity(cfg, T) == RMOE._capacity(rcfg, T)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_router_matches_reference(arch):
    cfg, rcfg = _cfgs(arch)
    w = 0.2 * _x((cfg.d_model, cfg.moe.n_experts), 1)
    x = _x((24, cfg.d_model), 2)
    got = MOE._router(cfg, torch.from_numpy(w), torch.from_numpy(x))
    want = RMOE._router(rcfg, jnp.asarray(w), jnp.asarray(x))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), **ACT)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(float(got[2]), float(want[2]), **ACT)


def test_router_ties_go_to_the_lower_expert_like_lax_top_k():
    """Duplicated router columns: every probability appears twice, so
    each token's top 2 is a tie; lax.top_k takes the lower index
    first."""
    cfg, rcfg = _cfgs("mixtral-8x22b")
    w = 0.2 * _x((cfg.d_model, 2), 3)
    w = np.concatenate([w, w], axis=1)             # experts 0=2, 1=3
    x = _x((32, cfg.d_model), 4)
    got = MOE._router(cfg, torch.from_numpy(w), torch.from_numpy(x))
    want = RMOE._router(rcfg, jnp.asarray(w), jnp.asarray(x))
    ids = got[1].numpy()
    np.testing.assert_array_equal(ids, np.asarray(want[1]))
    assert (ids[:, 0] < ids[:, 1]).all() and (ids[:, 1] - ids[:, 0] == 2).all()
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), **ACT)
    np.testing.assert_allclose(float(got[2]), float(want[2]), **ACT)


@pytest.mark.parametrize("cf,e_start,e_count,drops", [
    (1.25, 0, 4, False),     # the published factor, C >= every queue here
    (0.5, 0, 4, True),       # C below the busiest queues: pairs drop
    (0.5, 1, 2, True),       # local experts 1..2; the rest to the trash lane
])
def test_dispatch_indices_match_reference(cf, e_start, e_count, drops):
    cfg, rcfg = _cfgs("mixtral-8x22b", capacity_factor=cf)
    T = 40
    ids = np.random.default_rng(5).integers(
        0, cfg.moe.n_experts, (T, cfg.moe.top_k)).astype(np.int32)
    C = RMOE._capacity(rcfg, T) if e_count == 4 else 10
    got = MOE._dispatch_indices(cfg, torch.from_numpy(ids), T, C, e_start,
                                e_count)
    want = RMOE._dispatch_indices(rcfg, jnp.asarray(ids), T, C, e_start,
                                  e_count)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    keep, eid = got[3].numpy(), got[1].numpy()
    assert (~keep[eid < e_count]).any() == drops
    assert ((eid == e_count) == ((ids.reshape(-1) < e_start)
                                 | (ids.reshape(-1) >= e_start + e_count))
            ).all()


@pytest.mark.parametrize("arch,shared,cf", [
    ("mixtral-8x22b", 0, 1.25), ("mixtral-8x22b", 0, 0.25),
    ("deepseek-v3-671b", 1, 1.25), ("deepseek-v3-671b", 1, 0.25),
    ("deepseek-v3-671b", 0, 1.25)])
def test_moe_block_matches_reference(arch, shared, cf):
    """y and aux, with and without the shared expert, with and without
    drops (cf 0.25: C = 8 of 24 tokens' 48 pairs over 4 experts)."""
    cfg, rcfg = _cfgs(arch, capacity_factor=cf, n_shared=shared)
    p_np, rp = _init(RMOE.moe_ab(rcfg), seed=6)
    assert ("shared" in p_np) == bool(shared)
    x = _x((2, 12, cfg.d_model), 7)
    y, aux = MOE.moe_block(cfg, _torch_tree(p_np), torch.from_numpy(x))
    ry, raux = RMOE.moe_block(rcfg, rp, jnp.asarray(x))
    np.testing.assert_allclose(y.numpy(), np.asarray(ry), **ACT)
    np.testing.assert_allclose(float(aux), float(raux), **ACT)
    _, ids, _ = RMOE._router(rcfg, rp["router"],
                             jnp.asarray(x.reshape(24, -1)))
    keep = RMOE._dispatch_indices(rcfg, ids, 24, RMOE._capacity(rcfg, 24),
                                  0, cfg.moe.n_experts)[3]
    assert bool((~np.asarray(keep)).any()) == (cf < 1)


@pytest.mark.parametrize("act,gated", [("silu", True), ("gelu", False)])
def test_expert_ffn_matches_reference(act, gated):
    cfg, rcfg = (dataclasses.replace(c, act=act, gated=gated)
                 for c in _cfgs("mixtral-8x22b"))
    p_np, rp = _init(RMOE.moe_ab(rcfg), seed=8)
    xe = _x((cfg.moe.n_experts, 5, cfg.d_model), 9)
    P = _torch_tree(p_np)
    got = MOE._expert_ffn(cfg, P["up"], P["gate"], P["down"],
                          torch.from_numpy(xe))
    want = RMOE._expert_ffn(rcfg, rp["up"], rp["gate"], rp["down"],
                            jnp.asarray(xe))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ACT)


def test_moe_block_with_a_mesh_raises_naming_item_17_7():
    cfg, _ = _cfgs("mixtral-8x22b")
    with pytest.raises(NotImplementedError, match=r"item 17\.7"):
        MOE.moe_block(cfg, {}, torch.zeros((1, 2, cfg.d_model)),
                      mesh=object())


def _mla_inputs(S, seed):
    cfg, rcfg = get_reduced_config("deepseek-v3-671b"), ref_reduced(
        "deepseek-v3-671b")
    p_np, rp = _init(RATT.mla_ab(rcfg), seed)
    x = _x((2, S, cfg.d_model), seed + 1)
    return cfg, rcfg, _torch_tree(p_np), rp, x


def test_mla_train_matches_reference():
    cfg, rcfg, P, rp, x = _mla_inputs(10, 10)
    pos = np.tile(np.arange(10), (2, 1)).astype(np.int32)
    got, (c_kv, k_rope) = ATT.mla_train(cfg, P, torch.from_numpy(x),
                                        torch.from_numpy(pos),
                                        return_latent=True)
    want, (rc, rk) = RATT.mla_train(rcfg, rp, jnp.asarray(x),
                                    jnp.asarray(pos), return_latent=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ACT)
    np.testing.assert_allclose(c_kv.numpy(), np.asarray(rc), **ACT)
    np.testing.assert_allclose(k_rope.numpy(), np.asarray(rk), **ACT)


def test_mla_decode_matches_reference_and_writes_the_cache_in_place():
    cfg, rcfg, P, rp, x = _mla_inputs(1, 12)
    m = cfg.mla
    c0 = _x((2, 12, m.kv_lora_rank), 13)
    k0 = _x((2, 12, m.rope_dim), 14)
    pos = np.full((2, 1), 7, np.int32)
    cache = ATT.MLACache(c_kv=torch.from_numpy(c0.copy()),
                         k_rope=torch.from_numpy(k0.copy()))
    got, new = ATT.mla_decode(cfg, P, torch.from_numpy(x), cache,
                              torch.from_numpy(pos))
    want, rnew = RATT.mla_decode(rcfg, rp, jnp.asarray(x),
                                 RATT.MLACache(jnp.asarray(c0),
                                               jnp.asarray(k0)),
                                 jnp.asarray(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ACT)
    assert new.c_kv is cache.c_kv and new.k_rope is cache.k_rope
    np.testing.assert_allclose(new.c_kv.numpy(), np.asarray(rnew.c_kv), **ACT)
    np.testing.assert_allclose(new.k_rope.numpy(), np.asarray(rnew.k_rope),
                               **ACT)
    assert not np.array_equal(new.c_kv.numpy()[:, 7], c0[:, 7])
    np.testing.assert_array_equal(np.delete(new.c_kv.numpy(), 7, 1),
                                  np.delete(c0, 7, 1))


@pytest.mark.parametrize("S,window", [(64, None), (64, 20), (1100, None)])
def test_flash_op_takes_a_narrower_value_head_dim(S, window):
    """Dv = 16 < D = 24 (MLA's shape, narrowed): the op's output is
    (B, Hq, S, Dv), against the reference's attention_ref and, above
    S = 1024 where the op chunks queries, its attention_ref_chunked."""
    rng = np.random.default_rng(S)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((1, 4, S, 24), (1, 2, S, 24), (1, 2, S, 16)))
    got = flash_attention(*map(torch.from_numpy, (q, k, v)), causal=True,
                          window=window).numpy()
    assert got.shape == (1, 4, S, 16)
    args = tuple(map(jnp.asarray, (q, k, v)))
    np.testing.assert_allclose(
        got, np.asarray(ref_attention(*args, causal=True, window=window)),
        **ACT)
    if S > 1024:
        np.testing.assert_allclose(
            got, np.asarray(ref_chunked(*args, causal=True, window=window)),
            **ACT)


def test_flash_op_rejects_a_value_of_another_batch_head_or_length():
    q = torch.zeros((1, 4, 8, 24))
    k = torch.zeros((1, 2, 8, 24))
    check_operands(q, k, torch.zeros((1, 2, 8, 16)), None)
    for bad in ((1, 2, 9, 16), (1, 1, 8, 16), (2, 2, 8, 16)):
        with pytest.raises(ValueError, match="Dv"):
            check_operands(q, k, torch.zeros(bad), None)
