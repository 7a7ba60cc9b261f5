"""Host facet-graph construction, format conversion, coarsening, patching
and the conv's host tables."""

from facet_graph_convolution_torch.graph.adjacency import (  # noqa: F401
    face_adjacency_klist,
    vertex_adjacency_klist,
    vertex_ring_adjacency,
)
from facet_graph_convolution_torch.graph.convert import (  # noqa: F401
    klist_to_coo,
    klist_to_coo_normal_weighted,
    coo_to_klist,
    dedupe_klist,
    transpose_adjacency,
    invert_permutation,
    klist_degrees,
)
from facet_graph_convolution_torch.graph.coarsen import (  # noqa: F401
    coarsen_graph,
    graclus_levels,
    binary_tree_permutation,
    permute_adjacency,
    permute_data,
)
from facet_graph_convolution_torch.graph.patching import (  # noqa: F401
    grow_graph_patch,
    grow_graph_patch_masked,
    grow_mesh_patch,
)
