"""The plain versions of the port's two dense kernels (flash attention and
the fused kmeans assignment) against the reference: its jnp oracles and
its Pallas kernels in interpret mode.  These are what the port's ops run
for CPU tensors; ``tests/test_torch_cuda.py`` holds the CUDA kernels
against them on the card.

Tolerances: fp32 to 1e-5 (the reference's own flash tests hold its
kernel to its oracle at 2e-5; sums run in another order here); kmeans
labels exactly on tie-free data, distances to 8 ulps of the largest
term the distance identity cancels (``_dist_atol``)."""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the reference-only CI has no torch

import jax
import jax.numpy as jnp
from repro.kernels.flash_attention.flash_attention import \
    flash_attention_pallas
from repro.kernels.flash_attention.ref import attention_ref as ref_attention
from repro.kernels.flash_attention.ref import \
    attention_ref_chunked as ref_chunked
from repro.kernels.kmeans_assign.kmeans_assign import kmeans_assign_pallas
from repro.kernels.kmeans_assign.ref import kmeans_assign_ref as ref_assign

from repro_torch.core import kmeans as KM
from repro_torch.kernels.flash_attention import (attention_ref,
                                                 attention_ref_chunked,
                                                 flash_attention,
                                                 flash_attention_cuda)
from repro_torch.kernels.kmeans_assign import (kmeans_assign,
                                               kmeans_assign_cuda,
                                               kmeans_assign_ref)

torch.set_num_threads(1)

KA = importlib.import_module(
    "repro_torch.kernels.kmeans_assign.kmeans_assign")

TOL = dict(rtol=1e-5, atol=1e-5)


def _qkv(B, Hq, Hkv, S, D, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(dtype)
            for s in ((B, Hq, S, D), (B, Hkv, S, D), (B, Hkv, S, D))]


def _t(arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(arrays):
    return [jnp.asarray(a) for a in arrays]


# (B, Hq, Hkv, S, D, causal, window): MHA, GQA and MQA; causal, full and
# sliding-window masks; S a multiple of the Pallas kernel's 128-row tiles
FLASH_CASES = [
    (1, 2, 2, 128, 16, True, None),
    (2, 4, 2, 256, 32, True, None),
    (1, 8, 1, 256, 16, True, None),
    (2, 4, 1, 128, 32, False, None),
    (1, 4, 2, 256, 16, True, 64),
    (1, 2, 1, 256, 16, False, 100),
]


@pytest.mark.parametrize("B,Hq,Hkv,S,D,causal,window", FLASH_CASES)
def test_flash_plain_matches_reference_oracle_and_pallas(B, Hq, Hkv, S, D,
                                                         causal, window):
    arrs = _qkv(B, Hq, Hkv, S, D, seed=S + D + Hq)
    got = flash_attention(*_t(arrs), causal=causal, window=window).numpy()
    want = np.asarray(ref_attention(*_j(arrs), causal=causal, window=window))
    np.testing.assert_allclose(got, want, **TOL)
    pallas = np.asarray(flash_attention_pallas(
        *_j(arrs), causal=causal, window=window, interpret=True))
    np.testing.assert_allclose(got, pallas, **TOL)
    np.testing.assert_allclose(
        attention_ref(*_t(arrs), causal=causal, window=window).numpy(), want,
        **TOL)


@pytest.mark.parametrize("S,window", [(1536, None), (1536, 300)])
def test_flash_chunked_matches_reference_chunked(S, window):
    """Above S = 1024 the op runs the query-chunked plain version, as the
    reference's jnp path does; at S = 1536 the reference's 512-row chunks
    divide S, so its chunked oracle runs too."""
    arrs = _qkv(1, 2, 1, S, 8, seed=3)
    got = flash_attention(*_t(arrs), causal=True, window=window).numpy()
    np.testing.assert_allclose(
        got, np.asarray(ref_chunked(*_j(arrs), causal=True, window=window)),
        **TOL)
    np.testing.assert_allclose(
        got, np.asarray(ref_attention(*_j(arrs), causal=True,
                                      window=window)), **TOL)


@pytest.mark.parametrize("S", [200, 1025])
def test_flash_ragged_lengths_match_attention_ref(S):
    """Ragged lengths, against the reference's ``attention_ref`` only: the
    reference's Pallas kernel writes only the first S // 128 query tiles
    (rows 128-199 of S = 200 come out NaN in interpret mode), and its
    ``attention_ref_chunked`` raises at S = 1025 (it reshapes S into
    S // 512 equal chunks), so its own prefill fails at such prompts.
    The port masks the ragged edge and takes a shorter last chunk."""
    arrs = _qkv(1, 4, 2, S, 16, seed=S)
    got = flash_attention(*_t(arrs), causal=True).numpy()
    np.testing.assert_allclose(
        got, np.asarray(ref_attention(*_j(arrs), causal=True)), **TOL)
    np.testing.assert_allclose(
        attention_ref_chunked(*_t(arrs), causal=True).numpy(), got, **TOL)


def test_flash_gradient_matches_reference():
    """The backward recomputes through attention_ref, as the reference's
    custom_vjp does; the gradients of q, k and v match jax.grad of the
    reference's oracle."""
    arrs = _qkv(1, 4, 2, 64, 16, seed=5)
    g = np.random.default_rng(6).standard_normal((1, 4, 64, 16)).astype(
        np.float32)
    q, k, v = (t.requires_grad_() for t in _t(arrs))
    out = flash_attention(q, k, v, causal=True, window=40)
    out.backward(torch.from_numpy(g))
    want = jax.grad(lambda q, k, v: jnp.sum(ref_attention(
        q, k, v, True, 40) * jnp.asarray(g)), argnums=(0, 1, 2))(*_j(arrs))
    for got, w in zip((q.grad, k.grad, v.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), **TOL)


def test_flash_bf16_plain_matches_reference_oracle():
    """bfloat16 inputs: the plain version computes in q's dtype, as the
    reference's oracle does; bf16 keeps 8 significant bits, so the two
    frameworks' roundings agree to a few units of 2^-8."""
    arrs = _qkv(1, 4, 1, 128, 32, seed=9)
    got = flash_attention(*[t.to(torch.bfloat16) for t in _t(arrs)])
    want = ref_attention(*[a.astype(jnp.bfloat16) for a in _j(arrs)])
    np.testing.assert_allclose(got.to(torch.float32).numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=2 ** -5, atol=2 ** -5)


def test_flash_wrappers_check_operands():
    q, k, v = _t(_qkv(1, 4, 2, 16, 8))
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_cuda(q, k, v)
    with pytest.raises(ValueError, match="group"):
        flash_attention(q, k[:, :1].repeat(1, 3, 1, 1),
                        v[:, :1].repeat(1, 3, 1, 1))
    with pytest.raises(TypeError, match="dtypes"):
        flash_attention(q, k.double(), v)
    with pytest.raises(ValueError, match="shapes"):
        flash_attention(q, k[..., :4], v[..., :4])
    with pytest.raises(ValueError, match="window"):
        flash_attention(q, k, v, window=0)
    with pytest.raises(ValueError, match="devices"):
        flash_attention(q, k.to("meta"), v)


# ------------------------------------------------------------ kmeans_assign

def _blobs(n, d, kc, seed):
    """Points around kc separated centres and centroids near them: no two
    centroids are equally near any point (tie-free)."""
    rng = np.random.default_rng(seed)
    centres = 6.0 * rng.standard_normal((kc, d))
    X = centres[rng.integers(0, kc, n)] + rng.standard_normal((n, d))
    C = centres + 0.1 * rng.standard_normal((kc, d))
    return X.astype(np.float32), C.astype(np.float32)


def _dist_atol(X, C):
    """The identity ||x||^2 + ||c||^2 - 2 x.c cancels terms as large as
    max ||x||^2 + max ||c||^2, so fp32 distances agree to a few ulps of
    that: 8 x 2^-23 of it."""
    scale = float((X.astype(np.float64) ** 2).sum(1).max()
                  + (C.astype(np.float64) ** 2).sum(-1).max())
    return 8 * 2.0 ** -23 * scale


@pytest.mark.parametrize("n,d,kc", [(300, 4, 4), (257, 8, 16),
                                    (100, 3, 128)])
def test_kmeans_assign_plain_matches_reference_and_pallas(n, d, kc):
    X, C = _blobs(n, d, kc, seed=n + kc)
    lab, dist = kmeans_assign(torch.from_numpy(X), torch.from_numpy(C))
    assert lab.dtype == torch.int32 and lab.shape == (n,)
    r_lab, r_dist = ref_assign(jnp.asarray(X), jnp.asarray(C))
    p_lab, p_dist = kmeans_assign_pallas(jnp.asarray(X), jnp.asarray(C),
                                         block_m=64, interpret=True)
    for want_lab, want_dist in ((r_lab, r_dist), (p_lab, p_dist)):
        np.testing.assert_array_equal(lab.numpy(), np.asarray(want_lab))
        np.testing.assert_allclose(dist.numpy(), np.asarray(want_dist),
                                   rtol=0, atol=_dist_atol(X, C))


def test_kmeans_assign_batch_equals_each_set_alone():
    """A batch of centroid sets (R, kc, d), the port's form of the
    reference's vmapped restarts, gives each set's labels and distances."""
    X, _ = _blobs(200, 3, 5, seed=1)
    rng = np.random.default_rng(2)
    C = (4.0 * rng.standard_normal((3, 5, 3))).astype(np.float32)
    lab, dist = kmeans_assign(torch.from_numpy(X), torch.from_numpy(C))
    assert lab.shape == (3, 200)
    for r in range(3):
        r_lab, r_dist = ref_assign(jnp.asarray(X), jnp.asarray(C[r]))
        np.testing.assert_array_equal(lab[r].numpy(), np.asarray(r_lab))
        np.testing.assert_allclose(dist[r].numpy(), np.asarray(r_dist),
                                   rtol=0, atol=_dist_atol(X, C[r]))


def test_kmeans_assign_ties_go_to_the_lowest_index():
    X = torch.tensor([[0.0, 0.0], [2.0, 0.0]])
    C = torch.tensor([[1.0, 0.0], [-1.0, 0.0], [1.0, 0.0]])
    lab, dist = kmeans_assign_ref(X, C)
    assert lab.tolist() == [0, 0]
    assert dist.tolist() == [1.0, 1.0]


def test_lloyd_runs_through_the_op_on_the_cpu():
    """Stage 3's Lloyd steps use the op; on the CPU no kernel launches."""
    X, C = _blobs(150, 2, 3, seed=4)
    before = dict(KA.LAUNCHES)
    a, Cs, inertia = KM.lloyd(torch.from_numpy(X).double(),
                              torch.from_numpy(C).double()[None], iters=5)
    assert a.dtype == torch.int32 and a.shape == (1, 150)
    assert KA.LAUNCHES == before


def test_kmeans_wrappers_check_operands():
    X = torch.zeros((10, 3))
    with pytest.raises(ValueError, match="CUDA"):
        kmeans_assign_cuda(X, torch.zeros((2, 3)))
    with pytest.raises(ValueError, match="expected"):
        kmeans_assign(X, torch.zeros((2, 4)))
    with pytest.raises(TypeError, match="dtype"):
        kmeans_assign(X, torch.zeros((2, 3), dtype=torch.float64))
    with pytest.raises(TypeError, match="float32 or float64"):
        kmeans_assign(X.half(), torch.zeros((2, 3)).half())
    with pytest.raises(ValueError, match="devices|on"):
        kmeans_assign(X, torch.zeros((2, 3), device="meta"))
