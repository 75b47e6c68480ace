"""Granite-8B (code): llama-arch, GQA kv=8. [arXiv:2405.04324; hf]"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="granite-8b",
    family="dense",
    n_layers=36,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab=49152,
    tie_embeddings=False,
    rope_theta=10000000.0,
)
