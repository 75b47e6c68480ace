"""Architecture registry: one module per assigned arch, copied from the
reference's ``repro.configs`` (plain data; the port keeps its own).

get_config(arch_id)          -> full ArchConfig (dry-run / production)
get_reduced_config(arch_id)  -> tiny same-family config (CPU smoke tests)
"""
from __future__ import annotations

import dataclasses
import importlib

ARCH_IDS = [
    "jamba-1.5-large-398b",
    "gemma-2b",
    "internlm2-20b",
    "granite-8b",
    "chatglm3-6b",
    "whisper-small",
    "deepseek-v3-671b",
    "mixtral-8x22b",
    "mamba2-780m",
    "internvl2-1b",
]

_MODULES = {a: "repro_torch.configs."
            + a.replace("-", "_").replace(".", "_") for a in ARCH_IDS}


def get_config(arch_id: str):
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    return importlib.import_module(_MODULES[arch_id]).CONFIG


def get_reduced_config(arch_id: str):
    """Tiny same-family config: same code paths, laptop-size shapes."""
    from repro_torch.models.config import MoEConfig, MLAConfig, SSMConfig

    cfg = get_config(arch_id)
    kw = dict(
        d_model=64,
        n_heads=4 if cfg.n_heads else 0,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads else 0,
        head_dim=16 if cfg.n_heads else 0,
        d_ff=128 if cfg.d_ff else 0,
        vocab=512,
        max_position=256,
        params_dtype="float32",
        compute_dtype="float32",
        remat="none",
    )
    if cfg.family == "hybrid":
        kw["n_layers"] = len(cfg.hybrid_group)
    elif cfg.family == "moe" and cfg.moe.first_dense:
        kw["n_layers"] = 3
    else:
        kw["n_layers"] = 2
    if cfg.moe is not None:
        kw["moe"] = MoEConfig(
            n_experts=min(cfg.moe.n_experts, 4), top_k=min(cfg.moe.top_k, 2),
            d_expert=64, n_shared=min(cfg.moe.n_shared, 1),
            every=cfg.moe.every,
            first_dense=1 if cfg.moe.first_dense else 0,
            capacity_factor=cfg.moe.capacity_factor)
    if cfg.mla is not None:
        kw["mla"] = MLAConfig(q_lora_rank=32, kv_lora_rank=16,
                              rope_dim=8, nope_dim=16, v_dim=16)
    if cfg.ssm is not None:
        kw["ssm"] = SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=16,
                              n_groups=1, chunk=32)
    if cfg.enc_layers:
        kw["enc_layers"] = 2
        kw["enc_seq"] = 16
    if cfg.family == "vlm":
        kw["vis_seq"] = 8
    return dataclasses.replace(cfg, **kw)
