"""InternVL2-1B: InternViT STUB (input_specs provides 256 patch
embeddings) + 24L text backbone.  [arXiv:2404.16821; hf]"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-1b",
    family="vlm",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    head_dim=64,
    d_ff=4864,
    vocab=151655,
    vis_seq=256,
    tie_embeddings=True,
    rope_theta=1000000.0,
)
