"""Unified architecture config covering all assigned families:
dense / moe / ssm / hybrid (mamba+attn) / encdec (audio) / vlm.

A copy of the reference's ``repro.models.config``: the port keeps its
own config dataclasses and imports nothing of the reference.  Of the
families, the port runs ``dense`` and ``moe`` (``models/model.py``)."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert: int               # per-expert FFN hidden size
    n_shared: int = 0           # always-on shared experts (deepseek)
    every: int = 1              # MoE layer every N layers (1 = all)
    first_dense: int = 0        # leading dense layers (deepseek: 3)
    capacity_factor: float = 1.25
    router_scale: bool = True   # normalize top-k weights to sum 1


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    rope_dim: int = 64          # per-head rotary sub-dim (shared key)
    nope_dim: int = 128         # per-head non-rotary q/k sub-dim
    v_dim: int = 128            # per-head value dim


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk: int = 256


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                 # dense|moe|ssm|hybrid|encdec|vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0           # 0 -> d_model // n_heads
    # attention flavour
    rope_theta: float = 10000.0
    rope_fraction: float = 1.0  # chatglm3 rotates half the head dim ("2d")
    window: Optional[int] = None          # SWA (mixtral)
    mla: Optional[MLAConfig] = None       # deepseek
    # FFN flavour
    act: str = "silu"           # silu|gelu
    gated: bool = True          # SwiGLU / GeGLU
    moe: Optional[MoEConfig] = None
    # SSM / hybrid
    ssm: Optional[SSMConfig] = None
    hybrid_group: Tuple[str, ...] = ()    # e.g. 8-layer jamba group pattern
    # encoder-decoder (whisper) / vlm
    enc_layers: int = 0
    enc_seq: int = 1500          # encoded audio frames (stub output length)
    vis_seq: int = 256           # vision patch tokens (stub output length)
    # misc
    tie_embeddings: bool = True
    norm_eps: float = 1e-6
    norm: str = "rmsnorm"        # rmsnorm|layernorm (whisper)
    embed_scale: bool = False    # multiply embeddings by sqrt(d) (gemma)
    pos_embedding: str = "rope"  # rope|learned (whisper decoder)
    max_position: int = 32768 + 8  # learned-pos table size (whisper)
    mtp_depth: int = 0           # deepseek multi-token-prediction heads
    # capability flags for the shape grid
    sub_quadratic: bool = False  # can run long_500k decode
    has_decoder: bool = True     # encoder-only would be False
    # numerics / scaling knobs (overridable per run)
    params_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    remat: str = "full"          # full|none
    scan_layers: bool = True
    vocab_pad_to: int = 256      # pad embedding rows so vocab dim shards
                                 # over the model axis (perf: §Perf E1)

    @property
    def padded_vocab(self) -> int:
        if self.vocab_pad_to <= 1:
            return self.vocab
        return -(-self.vocab // self.vocab_pad_to) * self.vocab_pad_to

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.n_heads if self.n_heads else 0

    def n_params(self) -> int:
        """Approximate parameter count (embeddings included once)."""
        d, f, v = self.d_model, self.d_ff, self.vocab
        hd = self.resolved_head_dim

        def attn_params():
            if self.mla is not None:
                m = self.mla
                qk = d * m.q_lora_rank + m.q_lora_rank * self.n_heads * (m.nope_dim + m.rope_dim)
                kv = d * (m.kv_lora_rank + m.rope_dim) + m.kv_lora_rank * self.n_heads * (m.nope_dim + m.v_dim)
                o = self.n_heads * m.v_dim * d
                return qk + kv + o
            return d * hd * (self.n_heads + 2 * self.n_kv_heads) + self.n_heads * hd * d

        def mlp_params(ff):
            return d * ff * (3 if self.gated else 2)

        def moe_params():
            m = self.moe
            return (m.n_experts + m.n_shared) * mlp_params(m.d_expert) / mlp_params(f) * mlp_params(f) + d * m.n_experts

        def ssm_params():
            s = self.ssm
            di = s.expand * d
            conv_dim = di + 2 * s.n_groups * s.d_state
            nh = di // s.head_dim
            return (d * (2 * di + 2 * s.n_groups * s.d_state + nh)
                    + conv_dim * s.d_conv + 2 * nh + di + di * d)

        total = v * d * (1 if self.tie_embeddings else 2)
        if self.family == "ssm":
            total += self.n_layers * (ssm_params() + d)
            return int(total)
        if self.family == "hybrid":
            per_group = 0
            for kind in self.hybrid_group:
                blk = ssm_params() if kind == "m" else attn_params()
                per_group += blk + d
            # MoE every other layer in the group
            g = len(self.hybrid_group)
            n_moe = g // 2
            n_dense = g - n_moe
            per_group += n_moe * (self.moe.n_experts * mlp_params(self.moe.d_expert) + d * self.moe.n_experts)
            per_group += n_dense * mlp_params(f)
            per_group += g * d
            return int(total + (self.n_layers // g) * per_group)
        per_layer = attn_params() + 2 * d
        if self.moe is not None:
            m = self.moe
            n_moe_layers = max((self.n_layers - m.first_dense) // m.every, 0)
            n_dense_layers = self.n_layers - n_moe_layers
            per_moe = ((m.n_experts + m.n_shared) * mlp_params(m.d_expert)
                       + d * m.n_experts)
            total += n_moe_layers * (attn_params() + 2 * d + per_moe)
            total += n_dense_layers * (attn_params() + 2 * d + mlp_params(f))
        else:
            total += self.n_layers * (per_layer + mlp_params(f))
        if self.enc_layers:
            enc_per = attn_params() + mlp_params(f) + 2 * d
            dec_cross = attn_params() + d
            total += self.enc_layers * enc_per + self.n_layers * dec_cross
        return int(total)

    def n_active_params(self) -> int:
        """Active params per token (MoE: only routed top-k + shared)."""
        if self.moe is None:
            return self.n_params()
        d = self.d_model
        m = self.moe

        def mlp_params(ff):
            return d * ff * (3 if self.gated else 2)

        full = self.n_params()
        if self.family == "hybrid":
            g = len(self.hybrid_group)
            n_moe_layers = (self.n_layers // g) * (g // 2)
        else:
            n_moe_layers = max((self.n_layers - m.first_dense) // m.every, 0)
        inactive = n_moe_layers * (m.n_experts - m.top_k) * mlp_params(m.d_expert)
        return int(full - inactive)
