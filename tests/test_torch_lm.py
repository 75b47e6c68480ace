"""The port's LM serve path (``repro_torch.models``, ``serve``, ``launch``)
against the reference on reduced configs, with the reference's weights
carried across by ``convert.lm_state_dict``: the dense family and the
moe family (mixtral: MoE with GQA and a sliding window; deepseek: MoE
with a shared expert, a leading dense layer and MLA).

Decode against a full forward agrees only where no (token, expert) pair
drops: the forward over S + 1 tokens may drop the last position's
pairs, the decode step with its own capacity does not.  The MoE
teacher-forcing checks therefore run under a capacity factor of
n_experts / top_k (C = T); the comparisons with the reference keep the
published 1.25, since both packages drop the same pairs.

Tolerances: in fp32 (the reduced configs' compute dtype), activations
to rtol/atol 1e-5 and logits, whose magnitude reaches ~100 (the
embedding is scaled by sqrt(d) and the tied table unembeds), to rtol
1e-5 / atol 1e-4; greedy tokens exactly.  bfloat16 keeps 8 significant
bits (unit roundoff 2^-8) and the two frameworks round at different
points, so the bf16 case is held to a relative error of 2^-6, a few
roundoffs, over the whole logit tensor (measured: 2.4e-3)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the reference-only CI has no torch

import jax
import jax.numpy as jnp
from repro.configs import ARCH_IDS as REF_ARCH_IDS
from repro.configs import get_config as ref_get_config
from repro.configs import get_reduced_config as ref_reduced
from repro.models import layers as RL
from repro.models import model as RM
from repro.serve import GenerationConfig as RefGenerationConfig
from repro.serve import ServeEngine as RefServeEngine

from repro_torch import convert
from repro_torch.configs import ARCH_IDS, get_config, get_reduced_config
from repro_torch.launch import serve as launch_serve
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.serve import GenerationConfig, ServeEngine

torch.set_num_threads(1)

ACT = dict(rtol=1e-5, atol=1e-5)
LOGITS = dict(rtol=1e-5, atol=1e-4)
DENSE = ["gemma-2b", "internlm2-20b", "granite-8b", "chatglm3-6b"]
MOE_ARCHS = ["mixtral-8x22b", "deepseek-v3-671b"]


def _no_drop(cfg):
    """cfg with capacity factor n_experts / top_k: C = T, no pair drops."""
    m = cfg.moe
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        m, capacity_factor=m.n_experts / m.top_k))


def _pair(cfg_name, seed=0, no_drop=False, **override):
    """(port cfg, port params, reference cfg, reference params) with the
    reference's weights loaded into the port."""
    rcfg = dataclasses.replace(ref_reduced(cfg_name), **override)
    cfg = dataclasses.replace(get_reduced_config(cfg_name), **override)
    if no_drop:
        cfg, rcfg = _no_drop(cfg), _no_drop(rcfg)
    rp = RM.init_params(rcfg, jax.random.PRNGKey(seed))
    P = M.init_params(cfg, device="cpu")
    P.load_state_dict(convert.lm_state_dict(jax.tree.map(np.asarray, rp)))
    return cfg, P, rcfg, rp


def _tokens(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, (B, S)).astype(np.int32)


def _np(t):
    return t.detach().to(torch.float32).numpy()


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_configs_equal_reference(arch):
    assert set(ARCH_IDS) == set(REF_ARCH_IDS)
    for get, ref_get in ((get_config, ref_get_config),
                         (get_reduced_config, ref_reduced)):
        cfg, rcfg = get(arch), ref_get(arch)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(rcfg)
        assert cfg.n_params() == rcfg.n_params()
        assert cfg.padded_vocab == rcfg.padded_vocab
        assert cfg.resolved_head_dim == rcfg.resolved_head_dim


def test_gemma_2b_is_full_width():
    cfg = get_config("gemma-2b")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.resolved_head_dim, cfg.d_ff, cfg.padded_vocab) == \
        (18, 2048, 8, 1, 256, 16384, 256000)
    n = sum(int(np.prod(a.shape)) for a in
            jax.tree.leaves(RM.param_shapes(ref_get_config("gemma-2b"))))
    assert 2.5e9 < n < 2.52e9


def test_state_dict_keys_and_shapes_follow_reference():
    cfg, P, rcfg, rp = _pair("gemma-2b")
    sd = P.state_dict()
    assert len(sd) == 2 + cfg.n_layers * 9    # embed, final norm; 9 a block
    wq = rp["blocks"]["attn"]["wq"]
    assert sd["blocks.1.attn.wq"].shape == wq.shape[1:]
    np.testing.assert_array_equal(
        sd["blocks.1.ffn.gate"].numpy(),
        np.asarray(rp["blocks"]["ffn"]["gate"][1]))
    assert sd["embed.table"].shape == (cfg.padded_vocab, cfg.d_model)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_state_dict_keys_and_shapes_follow_reference(arch):
    """One key a leaf and layer of each stacked run (``blocks`` and
    deepseek's ``dense_blocks``): the router, the (E, ., .) expert
    weights, the shared expert and MLA's projections."""
    cfg, P, rcfg, rp = _pair(arch)
    sd = P.state_dict()
    n_leaves = {name: len(jax.tree.leaves(rp[name]))
                for name in ("blocks", "dense_blocks") if name in rp}
    nd = cfg.moe.first_dense
    assert len(sd) == 2 + n_leaves["blocks"] * (cfg.n_layers - nd) + (
        n_leaves.get("dense_blocks", 0) * nd)
    m = cfg.moe
    E, d = m.n_experts, cfg.d_model
    assert sd["blocks.0.ffn.router"].shape == (d, E)
    assert sd["blocks.0.ffn.up"].shape == (E, d, m.d_expert)
    assert sd["blocks.0.ffn.down"].shape == (E, m.d_expert, d)
    np.testing.assert_array_equal(
        sd[f"blocks.{cfg.n_layers - nd - 1}.ffn.gate"].numpy(),
        np.asarray(rp["blocks"]["ffn"]["gate"][-1]))
    if arch == "deepseek-v3-671b":
        assert sd["dense_blocks.0.ffn.up"].shape == (d, cfg.d_ff)
        assert sd["blocks.1.ffn.shared.up"].shape == (d, m.d_expert)
        np.testing.assert_array_equal(
            sd["dense_blocks.0.attn.wkv_a"].numpy(),
            np.asarray(rp["dense_blocks"]["attn"]["wkv_a"][0]))
        assert "blocks.0.attn.wq" not in sd
    else:
        assert "dense_blocks.0.ln1.scale" not in sd
        assert sd["blocks.1.attn.wk"].shape == rp["blocks"]["attn"][
            "wk"].shape[1:]


@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16])
def test_rmsnorm_matches_reference(dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal(64)).astype(np.float32)
    want = RL.rmsnorm({"scale": jnp.asarray(scale)},
                      jnp.asarray(x).astype(dtype), 1e-6)
    tdt = torch.float32 if dtype == np.float32 else torch.bfloat16
    got = L.rmsnorm({"scale": torch.from_numpy(scale)},
                    torch.from_numpy(x).to(tdt), 1e-6)
    tol = ACT if dtype == np.float32 else dict(rtol=2 ** -7, atol=2 ** -7)
    np.testing.assert_allclose(_np(got), np.asarray(want.astype(jnp.float32)),
                               **tol)


@pytest.mark.parametrize("fraction", [1.0, 0.5])
def test_apply_rope_matches_reference(fraction):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 3, 7, 16)).astype(np.float32)
    pos = np.tile(np.arange(7) + 3, (2, 1))
    want = RL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10000.0, fraction)
    got = L.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 10000.0,
                       fraction)
    np.testing.assert_allclose(_np(got), np.asarray(want), **ACT)


@pytest.mark.parametrize("act,gated", [("gelu", True), ("silu", True),
                                       ("silu", False)])
def test_mlp_matches_reference(act, gated):
    rng = np.random.default_rng(2)
    p = {"up": rng.standard_normal((16, 32)), "down":
         rng.standard_normal((32, 16)), "gate": rng.standard_normal((16, 32))}
    p = {k: (0.2 * v).astype(np.float32) for k, v in p.items()}
    if not gated:
        del p["gate"]
    x = rng.standard_normal((2, 5, 16)).astype(np.float32)
    want = RL.mlp({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
                  act, gated)
    got = L.mlp({k: torch.from_numpy(v) for k, v in p.items()},
                torch.from_numpy(x), act, gated)
    np.testing.assert_allclose(_np(got), np.asarray(want), **ACT)


def test_embed_and_unembed_match_reference():
    rng = np.random.default_rng(3)
    tab = rng.standard_normal((512, 16)).astype(np.float32)
    toks = rng.integers(0, 500, (2, 4)).astype(np.int32)
    x = rng.standard_normal((2, 4, 16)).astype(np.float32)
    np.testing.assert_allclose(
        _np(L.embed({"table": torch.from_numpy(tab)}, torch.from_numpy(toks))),
        np.asarray(RL.embed({"table": jnp.asarray(tab)}, jnp.asarray(toks))),
        **ACT)
    got = L.unembed_logits({"table": torch.from_numpy(tab)},
                           torch.from_numpy(x), real_vocab=500)
    want = RL.unembed_logits({"table": jnp.asarray(tab)}, jnp.asarray(x),
                             real_vocab=500)
    np.testing.assert_allclose(_np(got), np.asarray(want), **LOGITS)
    assert float(got[..., 500:].max()) < -1e29


@pytest.mark.parametrize("arch", DENSE + MOE_ARCHS)
def test_forward_train_matches_reference(arch):
    """Hidden states and aux: the sum of the MoE layers' Switch losses
    (0 for the dense family)."""
    cfg, P, rcfg, rp = _pair(arch, seed=1)
    toks = _tokens(cfg, 2, 12, seed=1)
    x, aux = M.forward_train(cfg, P, torch.from_numpy(toks))
    rx, raux = RM.forward_train(rcfg, rp, jnp.asarray(toks))
    np.testing.assert_allclose(_np(x), np.asarray(rx), **ACT)
    if cfg.moe is None:
        assert float(aux) == float(raux) == 0.0
    else:
        assert float(raux) > 0
        np.testing.assert_allclose(float(aux), float(raux), **ACT)


def _assert_cache_close(got, want):
    """A stacked KVCache / MLACache (or None) against the reference's."""
    assert (got is None) == (want is None)
    if got is None:
        return
    assert type(got).__name__ == type(want).__name__
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(_np(g), np.asarray(w), **ACT)


@pytest.mark.parametrize("arch,window", [
    pytest.param("gemma-2b", None, id="None"),
    pytest.param("gemma-2b", 5, id="5"),
    pytest.param("mixtral-8x22b", 4, id="mixtral-8x22b-4"),
    pytest.param("deepseek-v3-671b", None, id="deepseek-v3-671b")])
def test_prefill_and_decode_match_reference(arch, window):
    """Prefill logits and cache, then three decode steps, each step's
    logits and the cache it leaves (a sliding window of 5, or mixtral's
    window cut to 4, exercises the windowed masks of both the prefill
    and the decode; deepseek's cache is MLA latents, its leading dense
    layer in ``dense_layers``)."""
    cfg, P, rcfg, rp = _pair(arch, seed=2, window=window)
    toks = _tokens(cfg, 2, 9, seed=2)
    logits, cache, pos = M.prefill(cfg, P, torch.from_numpy(toks), 16)
    rlogits, rcache, rpos = RM.prefill(rcfg, rp, jnp.asarray(toks), 16)
    assert pos == rpos == 9
    np.testing.assert_allclose(_np(logits), np.asarray(rlogits), **LOGITS)
    _assert_cache_close(cache.layers, rcache.layers)
    _assert_cache_close(cache.dense_layers, rcache.dense_layers)
    nxt = toks[:, -1:]
    for i in range(3):
        positions = np.full((2, 1), pos + i, np.int32)
        logits, cache = M.decode_step(cfg, P, cache, torch.from_numpy(nxt),
                                      torch.from_numpy(positions))
        rlogits, rcache = RM.decode_step(rcfg, rp, rcache, jnp.asarray(nxt),
                                         jnp.asarray(positions))
        np.testing.assert_allclose(_np(logits), np.asarray(rlogits),
                                   **LOGITS)
        nxt = np.asarray(jnp.argmax(rlogits[:, -1], -1))[:, None].astype(
            np.int32)
    _assert_cache_close(cache.layers, rcache.layers)
    _assert_cache_close(cache.dense_layers, rcache.dense_layers)


def test_cache_zeros_matches_reference_layout():
    cfg = get_reduced_config("gemma-2b")
    c = M.cache_zeros(cfg, 3, 20, device="cpu")
    rc = RM.cache_zeros(ref_reduced("gemma-2b"), 3, 20)
    assert c.layers.k.shape == rc.layers.k.shape
    assert c.layers.k.dtype == torch.bfloat16
    assert c.dense_layers is None and c.enc_out is None


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_cache_zeros_matches_reference_layout(arch):
    c = M.cache_zeros(get_reduced_config(arch), 3, 20, device="cpu")
    rc = RM.cache_zeros(ref_reduced(arch), 3, 20)
    for got, want in ((c.layers, rc.layers),
                      (c.dense_layers, rc.dense_layers)):
        assert (got is None) == (want is None)
        if got is not None:
            assert type(got).__name__ == type(want).__name__
            assert [f.shape for f in got] == [f.shape for f in want]
            assert all(f.dtype == torch.bfloat16 and not f.any()
                       for f in got)
    assert c.enc_out is None


def _engine_tokens_equal_reference(arch, seed):
    cfg, P, rcfg, rp = _pair(arch, seed=seed)
    prompts = _tokens(cfg, 2, 8, seed=seed)
    gen = dict(max_new_tokens=6, temperature=0.0)
    got = ServeEngine(cfg, P, max_len=32).generate(
        prompts, GenerationConfig(**gen))
    want = RefServeEngine(rcfg, rp, max_len=32).generate(
        prompts, RefGenerationConfig(**gen))
    assert got.dtype == np.int32 and got.shape == (2, 6)
    np.testing.assert_array_equal(got, want)


def test_engine_greedy_tokens_equal_reference_engine():
    _engine_tokens_equal_reference("gemma-2b", seed=3)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_engine_greedy_tokens_equal_reference_engine(arch):
    _engine_tokens_equal_reference(arch, seed=3)


def _engine_matches_teacher_forcing(arch, seed, **pair):
    cfg, P, _, _ = _pair(arch, seed=seed, **pair)
    prompt = _tokens(cfg, 1, 6, seed=seed)
    out = ServeEngine(cfg, P, max_len=32).generate(
        prompt, GenerationConfig(max_new_tokens=4))
    seq = prompt.copy()
    for i in range(4):
        x, _ = M.forward_train(cfg, P, torch.from_numpy(seq))
        logits = L.unembed_logits(P["embed"], x[:, -1:], real_vocab=cfg.vocab)
        nxt = int(torch.argmax(logits[0, -1]))
        assert nxt == int(out[0, i]), f"step {i}"
        seq = np.concatenate([seq, [[nxt]]], axis=1)


def test_engine_matches_teacher_forcing():
    """Greedy engine tokens == argmax of the full forward, step by step
    (the in-place cache updates of decode agree with recomputing)."""
    _engine_matches_teacher_forcing("gemma-2b", seed=4)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_engine_matches_teacher_forcing_without_drops(arch):
    """As the dense case, under C = T (no pair drops): the in-place
    GQA / MLA cache updates and the MoE's per-step capacity agree with
    recomputing."""
    _engine_matches_teacher_forcing(arch, seed=4, no_drop=True)


def test_engine_sampling_is_seeded_and_stops_at_eos():
    cfg, P, _, _ = _pair("gemma-2b", seed=5)
    engine = ServeEngine(cfg, P, max_len=32)
    prompts = _tokens(cfg, 2, 5, seed=5)
    a = engine.generate(prompts, GenerationConfig(max_new_tokens=5,
                                                  temperature=1.0, seed=7))
    b = engine.generate(prompts, GenerationConfig(max_new_tokens=5,
                                                  temperature=1.0, seed=7))
    np.testing.assert_array_equal(a, b)
    assert ((a >= 0) & (a < cfg.vocab)).all()
    assert engine.timing["decode_steps"] == 4
    first = engine.generate(prompts, GenerationConfig(max_new_tokens=1))
    eos = int(first[0, 0])
    out = engine.generate(prompts[:1], GenerationConfig(max_new_tokens=5,
                                                        eos_id=eos))
    assert out.shape == (1, 1)
    with pytest.raises(ValueError, match="max_len"):
        engine.generate(prompts, GenerationConfig(max_new_tokens=40))


def _bf16_prefill_within_bound(arch, seed):
    cfg, P, rcfg, rp = _pair(arch, seed=seed, compute_dtype="bfloat16")
    toks = _tokens(cfg, 2, 10, seed=seed)
    logits, _, _ = M.prefill(cfg, P, torch.from_numpy(toks), 16)
    rlogits, _, _ = RM.prefill(rcfg, rp, jnp.asarray(toks), 16)
    assert logits.dtype == torch.bfloat16
    got, want = _np(logits), np.asarray(rlogits.astype(jnp.float32))
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel <= 2 ** -6, rel


def test_bf16_forward_matches_reference_within_bf16_bound():
    _bf16_prefill_within_bound("gemma-2b", seed=6)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_bf16_forward_matches_reference_within_bf16_bound(arch):
    """The whole model in bf16 (routing included) at the dense case's
    2^-6."""
    _bf16_prefill_within_bound(arch, seed=6)


@pytest.mark.parametrize("arch", ["mamba2-780m", "jamba-1.5-large-398b",
                                  "whisper-small", "internvl2-1b"])
def test_unported_families_raise_naming_roadmap(arch):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        M.init_params(get_reduced_config(arch), device="cpu")


def test_launch_serve_runs_reduced_on_cpu(capsys):
    out = launch_serve.main(["--arch", "gemma-2b", "--reduced", "--device",
                             "cpu", "--batch", "2", "--prompt-len", "5",
                             "--max-new", "3"])
    assert out.shape == (2, 3)
    assert "on cpu" in capsys.readouterr().out


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_launch_serve_runs_moe_reduced_on_cpu(arch, capsys):
    out = launch_serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                             "--batch", "2", "--prompt-len", "5",
                             "--max-new", "3"])
    assert out.shape == (2, 3)
    assert f"{arch} on cpu" in capsys.readouterr().out
