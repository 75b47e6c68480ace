from repro_torch.kernels.bsr_spmm.bsr_spmm import (
    LAUNCHES,
    build,
    bsr_spmm,
    bsr_spmm_plain,
    bsr_spmm_ref,
    reset_launch_counts,
    start_build,
)

__all__ = ["LAUNCHES", "build", "start_build", "reset_launch_counts",
           "bsr_spmm", "bsr_spmm_plain", "bsr_spmm_ref"]
