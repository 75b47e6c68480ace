"""ChatGLM3-6B: 2d-RoPE (half head dim rotated), GQA kv=2.
[arXiv:2406.12793; hf]"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="chatglm3-6b",
    family="dense",
    n_layers=28,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    head_dim=128,
    d_ff=13696,
    vocab=65024,
    rope_fraction=0.5,       # 2d rope: rotate half the head dim
    tie_embeddings=False,
    rope_theta=10000.0,
)
