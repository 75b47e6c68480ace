"""Multilevel coarsening + hierarchical p-spectral solve (port of
``repro.multilevel``): heavy-edge matching and Galerkin coarse graphs
(``coarsen``), the V-cycle that solves on the coarsest graph and
refines back up (``vcycle``)."""
from repro_torch.multilevel.coarsen import (
    CoarsenInfo,
    Hierarchy,
    Level,
    auto_sparsify_cap,
    build_hierarchy,
    coarsen_graph,
    heavy_edge_matching,
    patch_hierarchy,
    prolongator_from_aggregates,
)
from repro_torch.multilevel.vcycle import (MultilevelConfig,
                                           multilevel_cluster, refine_cluster)

__all__ = [
    "CoarsenInfo", "Hierarchy", "Level", "auto_sparsify_cap",
    "build_hierarchy", "coarsen_graph", "heavy_edge_matching",
    "patch_hierarchy", "prolongator_from_aggregates", "MultilevelConfig",
    "multilevel_cluster", "refine_cluster",
]
