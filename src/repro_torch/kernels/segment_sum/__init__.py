from repro_torch.kernels.segment_sum.segment_sum import (
    LAUNCHES,
    build,
    csr_pointers,
    reset_launch_counts,
    segment_pointers,
    segment_sum,
    segment_sum_plain,
    start_build,
)

__all__ = ["LAUNCHES", "build", "start_build", "reset_launch_counts",
           "segment_sum", "segment_sum_plain", "segment_pointers",
           "csr_pointers"]
