"""InternLM2-20B: GQA kv=8. [arXiv:2403.17297; hf]"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="internlm2-20b",
    family="dense",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab=92544,
    tie_embeddings=False,
    rope_theta=1000000.0,
)
