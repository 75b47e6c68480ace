"""grblas — the GraphBLAS-style algebraic layer of the port (containers,
semirings, the descriptor-driven ``mxm`` API and its backends, and the
distributed SpMM of ``dist``)."""
from repro_torch.grblas.semiring import (
    EdgeSemiring,
    PairEdgeSemiring,
    Semiring,
    boolean_ring,
    fast_paths,
    max_times_ring,
    min_plus_ring,
    plap_edge_semiring,
    plap_hvp_edge_semiring,
    reals_ring,
    register_ring_fast_paths,
)
from repro_torch.grblas.containers import (SELLCS_AUTO_THRESHOLD,
                                           SellKernelLayout, SparseMatrix)
from repro_torch.grblas.api import (
    BackendUnavailableError,
    Descriptor,
    available_backends,
    capable_desc,
    mxm,
    mxv,
    vxm,
)
from repro_torch.grblas.backends import register_backend, registered_backends
from repro_torch.grblas.dist import (
    HALO_FALLBACK_FRAC,
    RowPartitionedMatrix,
    device_mesh,
    init_distributed,
    make_row_partition,
    shard_mxm,
)
from repro_torch.grblas.ops import apply, e_wise_apply, reduce as grb_reduce

__all__ = [
    "Semiring", "EdgeSemiring", "PairEdgeSemiring", "reals_ring",
    "min_plus_ring", "max_times_ring", "boolean_ring",
    "plap_edge_semiring", "plap_hvp_edge_semiring",
    "register_ring_fast_paths", "fast_paths",
    "SparseMatrix", "SellKernelLayout", "SELLCS_AUTO_THRESHOLD",
    "Descriptor", "BackendUnavailableError", "mxm", "mxv", "vxm",
    "available_backends", "capable_desc", "register_backend",
    "registered_backends", "e_wise_apply", "apply", "grb_reduce",
    "HALO_FALLBACK_FRAC", "RowPartitionedMatrix", "device_mesh",
    "init_distributed", "make_row_partition", "shard_mxm",
]
