from repro_torch.kernels.sellcs_spmm.sellcs_spmm import (
    LAUNCHES,
    build,
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
)

__all__ = [
    "LAUNCHES", "build", "reset_launch_counts",
    "sellcs_spmm", "sellcs_plap_apply", "sellcs_plap_hvp",
    "sellcs_spmm_plain", "sellcs_plap_apply_plain", "sellcs_plap_hvp_plain",
    "sellcs_spmm_ref", "sellcs_plap_apply_ref", "sellcs_plap_hvp_ref",
]
