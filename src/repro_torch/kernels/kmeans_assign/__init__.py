from repro_torch.kernels.kmeans_assign.kmeans_assign import (
    LAUNCHES,
    build,
    kmeans_assign_cuda,
    kmeans_assign_planned,
    kmeans_assign_tiled_cuda,
    launch_plan,
    reset_launch_counts,
    start_build,
)
from repro_torch.kernels.kmeans_assign.ops import kmeans_assign
from repro_torch.kernels.kmeans_assign.ref import (kmeans_assign_ref,
                                                   pairwise_sqdist)

__all__ = ["LAUNCHES", "build", "start_build", "reset_launch_counts",
           "kmeans_assign", "kmeans_assign_cuda", "kmeans_assign_tiled_cuda",
           "kmeans_assign_planned", "launch_plan", "kmeans_assign_ref",
           "pairwise_sqdist"]
