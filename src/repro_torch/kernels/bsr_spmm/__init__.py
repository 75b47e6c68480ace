from repro_torch.kernels.bsr_spmm.bsr_spmm import (
    LAUNCHES,
    LAUNCHES_BY_WIDTH,
    build,
    bsr_spmm,
    bsr_spmm_plain,
    bsr_spmm_ref,
    reset_launch_counts,
    spmm_windows,
    start_build,
)

__all__ = ["LAUNCHES", "LAUNCHES_BY_WIDTH", "build", "start_build",
           "reset_launch_counts", "bsr_spmm", "bsr_spmm_plain",
           "bsr_spmm_ref", "spmm_windows"]
