"""Jamba-1.5-Large (398B): Mamba+attention 1:7 interleave, MoE 16e top-2
every other layer.  [arXiv:2403.19887; hf]

NOTE (hardware adaptation): Jamba's SSM layers are Mamba-1; this
framework implements the SSD (Mamba-2) formulation for all SSM blocks —
TPU-friendlier (chunked matmul form feeds the MXU).  Recorded in
DESIGN.md §8.
"""
from repro_torch.models.config import ArchConfig, MoEConfig, SSMConfig

CONFIG = ArchConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab=65536,
    moe=MoEConfig(n_experts=16, top_k=2, d_expert=24576, every=2),
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, n_groups=1,
                  chunk=256),
    # 8-layer group, one attention layer (index 4): 1:7 attn:mamba
    hybrid_group=("m", "m", "m", "m", "a", "m", "m", "m"),
    rope_theta=10000.0,
    tie_embeddings=False,
    sub_quadratic=True,      # mamba O(1) decode state; attn KV sharded
    params_dtype="bfloat16",  # 398B: fp32 master impossible on v5e pods
)
