"""Graph generators of the paper's test families (numpy/scipy copy of
``repro.graphs.generators``)."""
from repro_torch.graphs.generators import (
    delaunay_graph,
    gaussian_blobs_knn,
    grid_graph,
    ring_of_cliques,
    sbm_graph,
    sbm_graph_sparse,
)

__all__ = ["delaunay_graph", "grid_graph", "ring_of_cliques", "sbm_graph",
           "sbm_graph_sparse", "gaussian_blobs_knn"]
