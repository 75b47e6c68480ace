"""DeepSeek-V3 (671B): MLA, 1 shared + 256 routed experts top-8,
3 leading dense layers.  [arXiv:2412.19437; hf]

The assignment's d_ff=2048 is the per-expert hidden size; the three
leading dense layers use the model's dense FFN width 18432.
MTP (multi-token prediction) heads are a training-objective add-on;
mtp_depth=1 is recorded but the auxiliary head is not lowered in the
dry-run step (noted in DESIGN.md)."""
from repro_torch.models.config import ArchConfig, MoEConfig, MLAConfig

CONFIG = ArchConfig(
    name="deepseek-v3-671b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,
    head_dim=128,
    d_ff=18432,              # dense layers (first 3)
    vocab=129280,
    moe=MoEConfig(n_experts=256, top_k=8, d_expert=2048, n_shared=1,
                  every=1, first_dense=3, capacity_factor=1.25),
    mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512, rope_dim=64,
                  nope_dim=128, v_dim=128),
    mtp_depth=1,
    tie_embeddings=False,
    rope_theta=10000.0,
    params_dtype="bfloat16",
)
