"""The port's encdec (whisper-small) and vlm (internvl2-1b) families
against the reference on reduced configs, with the reference's weights
carried across by ``convert.lm_state_dict``: LayerNorm, cross-attention
(``gqa_train(kv_override=...)``), the forward, prefill, decode, the
serve engine and ``launch.serve``.  The front ends are the reference's
stubs: whisper takes (B, enc_seq, d) frames, InternVL2 (B, P, d) patch
embeddings prepended to the prompt.  Inputs are drawn from a seed with
numpy and handed to both packages.

The reference's ``prefill`` returns S as the next position of a vlm
model, though its cache holds the P patch positions too; decoding there
overwrites a cached prompt entry.  The port returns P + S, and its
decode is held against the reference's ``decode_step`` at P + S and
against the reference's own teacher-forced forward
(``test_reference_vlm_prefill_position_fault`` records the fault).

Tolerances as in ``test_torch_lm.py``: fp32 activations to rtol/atol
1e-5, logits (magnitude up to ~60) to rtol 1e-5 / atol 1e-4, greedy
tokens exactly; bf16 LayerNorm to 2^-7, a roundoff of the output; a
whole bf16 model's logits to 2^-6 relative (the two frameworks round
at different points)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the reference-only CI has no torch

import jax
import jax.numpy as jnp
from repro.configs import get_reduced_config as ref_reduced
from repro.models import attention as RATT
from repro.models import layers as RL
from repro.models import model as RM
from repro.serve import GenerationConfig as RefGenerationConfig
from repro.serve import ServeEngine as RefServeEngine

from repro_torch import convert
from repro_torch.configs import get_reduced_config
from repro_torch.launch import serve as launch_serve
from repro_torch.models import attention as ATT
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.serve import GenerationConfig, ServeEngine

torch.set_num_threads(1)

ACT = dict(rtol=1e-5, atol=1e-5)
LOGITS = dict(rtol=1e-5, atol=1e-4)
BF16_ACT = dict(rtol=2 ** -7, atol=2 ** -7)
WHISPER, INTERNVL = "whisper-small", "internvl2-1b"
ARCHS = [WHISPER, INTERNVL]


def _pair(arch, seed=0, **override):
    """(port cfg, port params, reference cfg, reference params) with the
    reference's weights loaded into the port."""
    rcfg = dataclasses.replace(ref_reduced(arch), **override)
    cfg = dataclasses.replace(get_reduced_config(arch), **override)
    rp = RM.init_params(rcfg, jax.random.PRNGKey(seed))
    P = M.init_params(cfg, device="cpu")
    P.load_state_dict(convert.lm_state_dict(jax.tree.map(np.asarray, rp)))
    return cfg, P, rcfg, rp


def _tokens(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, (B, S)).astype(np.int32)


def _front(cfg, B, seed=0):
    """The stub front end's input as numpy: {"enc_frames": ...} or
    {"extra_embeds": ...}."""
    rng = np.random.default_rng(100 + seed)
    if cfg.family == "encdec":
        return {"enc_frames": rng.standard_normal(
            (B, cfg.enc_seq, cfg.d_model)).astype(np.float32)}
    return {"extra_embeds": rng.standard_normal(
        (B, cfg.vis_seq, cfg.d_model)).astype(np.float32)}


def _t(kw):
    return {k: torch.from_numpy(v) for k, v in kw.items()}


def _j(kw):
    return {k: jnp.asarray(v) for k, v in kw.items()}


def _np(t):
    return t.detach().to(torch.float32).numpy()


def _patches(kw):
    return kw["extra_embeds"].shape[1] if "extra_embeds" in kw else 0


@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16])
def test_layernorm_matches_reference(dtype):
    rng = np.random.default_rng(0)
    x = (3 + 2 * rng.standard_normal((2, 5, 64))).astype(np.float32)
    p = {"scale": (1 + 0.1 * rng.standard_normal(64)).astype(np.float32),
         "bias": (0.5 * rng.standard_normal(64)).astype(np.float32)}
    want = RL.layernorm({k: jnp.asarray(v) for k, v in p.items()},
                        jnp.asarray(x).astype(dtype), 1e-5)
    tdt = torch.float32 if dtype == np.float32 else torch.bfloat16
    got = L.layernorm({k: torch.from_numpy(v) for k, v in p.items()},
                      torch.from_numpy(x).to(tdt), 1e-5)
    assert got.dtype == tdt
    tol = ACT if dtype == np.float32 else BF16_ACT
    np.testing.assert_allclose(_np(got), np.asarray(want.astype(jnp.float32)),
                               **tol)


@pytest.mark.parametrize("Sq", [1, 5])
def test_cross_attention_matches_reference(Sq):
    """k and v from the memory (Sk = enc_seq = 16, Sq 1 or 5), neither q
    nor k rotated, no causal mask."""
    cfg, P, rcfg, rp = _pair(WHISPER, seed=1)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, Sq, cfg.d_model)).astype(np.float32)
    mem = rng.standard_normal((2, cfg.enc_seq, cfg.d_model)).astype(
        np.float32)
    pos = np.tile(np.arange(Sq) + 3, (2, 1)).astype(np.int32)
    got = ATT.gqa_train(cfg, P["blocks"][0]["xattn"], torch.from_numpy(x),
                        torch.from_numpy(pos), causal=False,
                        kv_override=torch.from_numpy(mem))
    rxp = jax.tree.map(lambda a: a[0], rp["blocks"]["xattn"])
    want = RATT.gqa_train(rcfg, rxp, jnp.asarray(x), jnp.asarray(pos),
                          causal=False, kv_override=jnp.asarray(mem))
    assert got.shape == (2, Sq, cfg.d_model)
    np.testing.assert_allclose(_np(got), np.asarray(want), **ACT)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_train_matches_reference(arch):
    """Hidden states over the P + S positions (InternVL2) or the
    decoder's S after the encoder (whisper); aux 0."""
    cfg, P, rcfg, rp = _pair(arch, seed=2)
    toks = _tokens(cfg, 2, 9, seed=2)
    kw = _front(cfg, 2, seed=2)
    x, aux = M.forward_train(cfg, P, torch.from_numpy(toks), **_t(kw))
    rx, raux = RM.forward_train(rcfg, rp, jnp.asarray(toks), **_j(kw))
    assert x.shape == (2, _patches(kw) + 9, cfg.d_model)
    np.testing.assert_allclose(_np(x), np.asarray(rx), **ACT)
    assert float(aux) == float(raux) == 0.0


def test_encdec_frames_of_another_length_raise():
    cfg, P, _, _ = _pair(WHISPER)
    frames = torch.zeros((1, cfg.enc_seq - 1, cfg.d_model))
    with pytest.raises(ValueError, match="enc_frames"):
        M.forward_train(cfg, P, torch.zeros((1, 3), dtype=torch.int32),
                        enc_frames=frames)
    with pytest.raises(ValueError, match="enc_frames"):
        M.forward_train(cfg, P, torch.zeros((1, 3), dtype=torch.int32))


def _assert_cache_close(got, want):
    assert type(got).__name__ == type(want).__name__
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(_np(g), np.asarray(w), **ACT)


def test_encdec_prefill_and_decode_match_reference():
    """Whisper: prefill logits, KV cache and the encoder memory in the
    cache, next position S; then three decode steps (learned positions,
    the cross-attention over the memory at Sq = 1), each step's logits
    and the cache it leaves."""
    cfg, P, rcfg, rp = _pair(WHISPER, seed=3)
    toks = _tokens(cfg, 2, 9, seed=3)
    kw = _front(cfg, 2, seed=3)
    logits, cache, pos = M.prefill(cfg, P, torch.from_numpy(toks), 16,
                                   **_t(kw))
    rlogits, rcache, rpos = RM.prefill(rcfg, rp, jnp.asarray(toks), 16,
                                       **_j(kw))
    assert pos == rpos == 9
    np.testing.assert_allclose(_np(logits), np.asarray(rlogits), **LOGITS)
    _assert_cache_close(cache.layers, rcache.layers)
    assert cache.dense_layers is None
    assert cache.enc_out["mem"].shape == (2, cfg.enc_seq, cfg.d_model)
    np.testing.assert_allclose(_np(cache.enc_out["mem"]),
                               np.asarray(rcache.enc_out["mem"]), **ACT)
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


def test_encdec_cache_zeros_matches_reference_layout():
    c = M.cache_zeros(get_reduced_config(WHISPER), 3, 20, device="cpu")
    rc = RM.cache_zeros(ref_reduced(WHISPER), 3, 20)
    assert [f.shape for f in c.layers] == [f.shape for f in rc.layers]
    assert c.dense_layers is None
    assert c.enc_out["mem"].shape == rc.enc_out["mem"].shape
    assert c.enc_out["mem"].dtype == torch.bfloat16
    assert not c.enc_out["mem"].any()


def test_encdec_engine_greedy_tokens_equal_reference_engine():
    cfg, P, rcfg, rp = _pair(WHISPER, seed=4)
    prompts = _tokens(cfg, 2, 8, seed=4)
    kw = _front(cfg, 2, seed=4)
    gen = dict(max_new_tokens=6, temperature=0.0)
    got = ServeEngine(cfg, P, max_len=32).generate(
        prompts, GenerationConfig(**gen), **kw)
    want = RefServeEngine(rcfg, rp, max_len=32).generate(
        prompts, RefGenerationConfig(**gen), **kw)
    assert got.dtype == np.int32 and got.shape == (2, 6)
    np.testing.assert_array_equal(got, want)


def test_vlm_prefill_matches_reference():
    """InternVL2: last-token logits and the KV cache over P + S
    positions equal the reference's; the next position is P + S (the
    reference returns S)."""
    cfg, P, rcfg, rp = _pair(INTERNVL, seed=5)
    toks = _tokens(cfg, 2, 7, seed=5)
    kw = _front(cfg, 2, seed=5)
    logits, cache, pos = M.prefill(cfg, P, torch.from_numpy(toks), 24,
                                   **_t(kw))
    rlogits, rcache, rpos = RM.prefill(rcfg, rp, jnp.asarray(toks), 24,
                                       **_j(kw))
    assert (pos, rpos) == (cfg.vis_seq + 7, 7)
    np.testing.assert_allclose(_np(logits), np.asarray(rlogits), **LOGITS)
    _assert_cache_close(cache.layers, rcache.layers)
    assert cache.enc_out is None and cache.dense_layers is None


def _ref_forward_logits(rcfg, rp, seq, kw):
    """The reference's teacher-forced forward: last-position logits."""
    rx, _ = RM.forward_train(rcfg, rp, jnp.asarray(seq), **_j(kw))
    return np.asarray(RL.unembed_logits(rp["embed"], rx[:, -1:],
                                        real_vocab=rcfg.vocab))


def test_vlm_decode_at_patches_plus_prompt_matches_reference():
    """Three decode steps from the port's position P + S: each step's
    logits equal the reference's ``decode_step`` at the same positions
    on its own cache, and its teacher-forced forward over the patches,
    the prompt and the tokens decoded so far."""
    cfg, P, rcfg, rp = _pair(INTERNVL, seed=6)
    toks = _tokens(cfg, 2, 7, seed=6)
    kw = _front(cfg, 2, seed=6)
    logits, cache, pos = M.prefill(cfg, P, torch.from_numpy(toks), 24,
                                   **_t(kw))
    _, rcache, _ = RM.prefill(rcfg, rp, jnp.asarray(toks), 24, **_j(kw))
    seq = toks
    nxt = np.asarray(torch.argmax(logits[:, -1], -1))[:, None].astype(
        np.int32)
    for i in range(3):
        positions = np.full((2, 1), pos + i, np.int32)
        logits, cache = M.decode_step(cfg, P, cache, torch.from_numpy(nxt),
                                      torch.from_numpy(positions))
        rlogits, rcache = RM.decode_step(rcfg, rp, rcache, jnp.asarray(nxt),
                                         jnp.asarray(positions))
        np.testing.assert_allclose(_np(logits), np.asarray(rlogits),
                                   **LOGITS)
        seq = np.concatenate([seq, nxt], axis=1)
        np.testing.assert_allclose(
            _np(logits), _ref_forward_logits(rcfg, rp, seq, kw), **LOGITS)
        nxt = np.asarray(jnp.argmax(rlogits[:, -1], -1))[:, None].astype(
            np.int32)


def test_reference_vlm_prefill_position_fault():
    """The fault of the reference the port does not copy: its prefill
    returns S for a vlm model; one decode step there differs from its
    own teacher-forced forward by more than 0.1 relative, while at
    P + S it agrees (to the fp32 logit tolerance).  The port returns
    P + S."""
    cfg, P, rcfg, rp = _pair(INTERNVL, seed=7)
    toks = _tokens(cfg, 2, 7, seed=7)
    kw = _front(cfg, 2, seed=7)
    rlogits, _, rpos = RM.prefill(rcfg, rp, jnp.asarray(toks), 24, **_j(kw))
    _, _, pos = M.prefill(cfg, P, torch.from_numpy(toks), 24, **_t(kw))
    assert rpos == 7 and pos == cfg.vis_seq + 7
    nxt = np.asarray(jnp.argmax(rlogits[:, -1], -1))[:, None].astype(
        np.int32)
    want = _ref_forward_logits(rcfg, rp, np.concatenate([toks, nxt], 1), kw)

    def decoded_at(p):
        _, rcache, _ = RM.prefill(rcfg, rp, jnp.asarray(toks), 24, **_j(kw))
        out, _ = RM.decode_step(rcfg, rp, rcache, jnp.asarray(nxt),
                                jnp.full((2, 1), p, jnp.int32))
        return np.asarray(out)

    at_s = decoded_at(rpos)
    rel = np.linalg.norm(at_s - want) / np.linalg.norm(want)
    assert rel > 0.1, rel
    np.testing.assert_allclose(decoded_at(pos), want, **LOGITS)


def test_vlm_engine_matches_reference_teacher_forcing():
    """Greedy engine tokens == the argmax of the reference's forward over
    the patches, the prompt and the tokens so far, step by step."""
    cfg, P, rcfg, rp = _pair(INTERNVL, seed=8)
    prompt = _tokens(cfg, 1, 6, seed=8)
    kw = _front(cfg, 1, seed=8)
    out = ServeEngine(cfg, P, max_len=cfg.vis_seq + 6 + 4).generate(
        prompt, GenerationConfig(max_new_tokens=4), **kw)
    seq = prompt
    for i in range(4):
        nxt = int(np.argmax(_ref_forward_logits(rcfg, rp, seq, kw)[0, -1]))
        assert nxt == int(out[0, i]), f"step {i}"
        seq = np.concatenate([seq, [[nxt]]], axis=1)


def test_engine_max_len_counts_the_patches():
    """max_len must hold P + S + max_new_tokens: one position short
    raises a ValueError naming all three."""
    cfg, P, _, _ = _pair(INTERNVL)
    prompt = _tokens(cfg, 1, 6)
    kw = _front(cfg, 1)
    engine = ServeEngine(cfg, P, max_len=cfg.vis_seq + 6 + 4 - 1)
    with pytest.raises(ValueError, match=rf"{cfg.vis_seq} patches \+ "
                       r"prompt 6 \+ 4 new tokens"):
        engine.generate(prompt, GenerationConfig(max_new_tokens=4), **kw)


@pytest.mark.parametrize("arch", ARCHS)
def test_state_dict_keys_and_shapes_follow_reference(arch):
    """One key a leaf (and a layer of each stacked run: whisper's
    ``enc_blocks`` and ``blocks``), each with the reference's shape."""
    cfg, P, _, rp = _pair(arch)
    sd = P.state_dict()
    want = convert.lm_state_dict(jax.tree.map(np.asarray, rp))
    assert sorted(sd) == sorted(want)
    assert all(sd[k].shape == want[k].shape for k in sd)
    n_leaves = len(jax.tree.leaves(rp))
    if arch == WHISPER:
        # 10 leaves an encoder block (two LayerNorms of 2, attn 4, mlp 2),
        # 16 a decoder block (ln_x and xattn beside them); 7 others: embed,
        # pos_embed, enc_pos, enc_norm's 2 and final_norm's 2
        assert len(sd) == 7 + 10 * cfg.enc_layers + 16 * cfg.n_layers
        assert n_leaves == 7 + 10 + 16
        assert sd["pos_embed.table"].shape == (cfg.max_position,
                                               cfg.d_model)
        assert sd["enc_pos.table"].shape == (cfg.enc_seq, cfg.d_model)
        assert sd["enc_blocks.1.ln1.bias"].shape == (cfg.d_model,)
        np.testing.assert_array_equal(
            sd["blocks.1.xattn.wk"].numpy(),
            np.asarray(rp["blocks"]["xattn"]["wk"][1]))
        np.testing.assert_array_equal(
            sd["enc_blocks.0.attn.wq"].numpy(),
            np.asarray(rp["enc_blocks"]["attn"]["wq"][0]))
        assert "blocks.0.ffn.gate" not in sd      # non-gated GELU
    else:
        assert len(sd) == 2 + 9 * cfg.n_layers
        assert n_leaves == 2 + 9
        assert "pos_embed.table" not in sd


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_forward_matches_reference_within_bf16_bound(arch):
    cfg, P, rcfg, rp = _pair(arch, seed=9, compute_dtype="bfloat16")
    toks = _tokens(cfg, 2, 10, seed=9)
    kw = _front(cfg, 2, seed=9)
    logits, _, _ = M.prefill(cfg, P, torch.from_numpy(toks), 24, **_t(kw))
    rlogits, _, _ = RM.prefill(rcfg, rp, jnp.asarray(toks), 24, **_j(kw))
    assert logits.dtype == torch.bfloat16
    got, want = _np(logits), np.asarray(rlogits.astype(jnp.float32))
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel <= 2 ** -6, rel


@pytest.mark.parametrize("arch", ARCHS)
def test_launch_serve_runs_reduced_on_cpu(arch, capsys):
    out = launch_serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                             "--batch", "2", "--prompt-len", "5",
                             "--max-new", "3"])
    assert out.shape == (2, 3)
    assert f"{arch} on cpu" in capsys.readouterr().out
