from repro_torch.kernels.plap_edge.plap_edge import (
    LAUNCHES,
    build,
    plap_apply,
    plap_apply_plain,
    plap_apply_ref,
    plap_hvp,
    plap_hvp_edge_ref,
    plap_hvp_plain,
    reset_launch_counts,
    start_build,
)

__all__ = ["LAUNCHES", "build", "start_build", "reset_launch_counts",
           "plap_apply", "plap_hvp", "plap_apply_plain", "plap_hvp_plain",
           "plap_apply_ref", "plap_hvp_edge_ref"]
