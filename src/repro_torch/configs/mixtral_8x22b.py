"""Mixtral-8x22B: 8 experts top-2, sliding-window attention.
[arXiv:2401.04088; hf]"""
from repro_torch.models.config import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="mixtral-8x22b",
    family="moe",
    n_layers=56,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab=32768,
    window=4096,             # SWA per the assignment
    moe=MoEConfig(n_experts=8, top_k=2, d_expert=16384, every=1),
    tie_embeddings=False,
    rope_theta=1000000.0,
    sub_quadratic=True,      # SWA bounds the decode working set
    params_dtype="bfloat16",
)
