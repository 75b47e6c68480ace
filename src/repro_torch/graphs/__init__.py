"""Graphs: generators of the paper's test families, bandwidth-reducing
orderings, Matrix Market I/O, input validation and connected components,
and partitioning (numpy/scipy copies of ``repro.graphs``, building port
``SparseMatrix`` objects)."""
from repro_torch.graphs.generators import (
    delaunay_graph,
    gaussian_blobs_knn,
    grid_graph,
    ring_of_cliques,
    sbm_graph,
    sbm_graph_sparse,
)
from repro_torch.graphs.mmio import read_matrix_market, write_matrix_market
from repro_torch.graphs.partition import (cut_edges, partition,
                                          partition_for_mesh)
from repro_torch.graphs.reorder import (bandwidth, degree_ordering,
                                        rcm_ordering, reorder)
from repro_torch.graphs.validate import (
    Components,
    GraphValidationError,
    ValidateConfig,
    allocate_k,
    cluster_components,
    connected_components,
    isolated_vertices,
    quick_check,
    validate_graph,
)

__all__ = ["bandwidth", "degree_ordering", "rcm_ordering", "reorder",
           "delaunay_graph", "grid_graph", "ring_of_cliques", "sbm_graph",
           "sbm_graph_sparse", "gaussian_blobs_knn",
           "read_matrix_market", "write_matrix_market",
           "partition", "partition_for_mesh", "cut_edges",
           "Components", "GraphValidationError", "ValidateConfig",
           "allocate_k", "cluster_components", "connected_components",
           "isolated_vertices", "quick_check", "validate_graph"]
