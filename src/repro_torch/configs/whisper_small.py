"""Whisper-small: enc-dec, conv frontend STUB (input_specs provides
precomputed 1500-frame embeddings).  [arXiv:2212.04356]

Backbone only per the assignment: 12L encoder + 12L decoder, d=768,
12H, layernorm, non-gated GELU, learned positions (no RoPE).
long_500k is skipped (full attention; decoder max position << 500k)."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="whisper-small",
    family="encdec",
    n_layers=12,             # decoder layers
    enc_layers=12,
    enc_seq=1500,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    head_dim=64,
    d_ff=3072,
    vocab=51865,
    act="gelu",
    gated=False,
    norm="layernorm",
    norm_eps=1e-5,
    pos_embedding="learned",
    rope_fraction=0.0,       # no rotary anywhere
    max_position=32768 + 8,  # sized for the assigned decode_32k shape
    tie_embeddings=True,
)
