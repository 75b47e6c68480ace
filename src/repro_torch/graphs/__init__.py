"""Graph generators of the paper's test families and bandwidth-reducing
orderings (numpy/scipy copies of ``repro.graphs.generators`` and
``repro.graphs.reorder``)."""
from repro_torch.graphs.generators import (
    delaunay_graph,
    gaussian_blobs_knn,
    grid_graph,
    ring_of_cliques,
    sbm_graph,
    sbm_graph_sparse,
)
from repro_torch.graphs.reorder import (bandwidth, degree_ordering,
                                        rcm_ordering, reorder)

__all__ = ["bandwidth", "degree_ordering", "rcm_ordering", "reorder",
           "delaunay_graph", "grid_graph", "ring_of_cliques", "sbm_graph",
           "sbm_graph_sparse", "gaussian_blobs_knn"]
