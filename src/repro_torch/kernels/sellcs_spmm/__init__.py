from repro_torch.kernels.sellcs_spmm.sellcs_spmm import (
    APPLY_LAUNCHES_BY_K,
    LAUNCHES,
    LAUNCHES_BY_SHAPE,
    block_order,
    build,
    lanes,
    launch_plan,
    reset_launch_counts,
    sellcs_plap_apply,
    sellcs_plap_apply_plain,
    sellcs_plap_apply_ref,
    sellcs_plap_hvp,
    sellcs_plap_hvp_plain,
    sellcs_plap_hvp_ref,
    sellcs_spmm,
    sellcs_spmm_plain,
    sellcs_spmm_ref,
    start_build,
)

__all__ = [
    "LAUNCHES", "LAUNCHES_BY_SHAPE", "APPLY_LAUNCHES_BY_K", "build", "start_build",
    "reset_launch_counts",
    "launch_plan", "lanes", "block_order",
    "sellcs_spmm", "sellcs_plap_apply", "sellcs_plap_hvp",
    "sellcs_spmm_plain", "sellcs_plap_apply_plain", "sellcs_plap_hvp_plain",
    "sellcs_spmm_ref", "sellcs_plap_apply_ref", "sellcs_plap_hvp_ref",
]
