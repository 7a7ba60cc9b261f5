"""Device ops: the facet conv and its kernels, pooling, normalization, the
vertex solvers."""

from facet_graph_convolution_torch.ops.gather import (  # noqa: F401
    gather_neighbors,
    gather_slot_major,
)
from facet_graph_convolution_torch.ops.conv import (  # noqa: F401
    FacetConvVariant,
    init_facet_conv,
    facet_conv,
    facet_conv_gather,
    init_facet_conv_pos_assignment,
    facet_conv_pos_assignment,
    init_facet_conv_only_pos_assignment,
    facet_conv_only_pos_assignment,
    init_linear,
    linear,
    assignment_weights,
    rotation_to_axis,
)
from facet_graph_convolution_torch.ops.pooling import (  # noqa: F401
    tree_pool,
    tree_unpool,
)
from facet_graph_convolution_torch.ops.normalization import (  # noqa: F401
    normalize_tensor,
    dot_last,
    lrelu,
    moments_norm,
    face_normals_device,
)
from facet_graph_convolution_torch.ops.vertex_update import (  # noqa: F401
    update_positions_edges,
    update_positions_depth,
    update_positions_multiscale,
    face_centers_pyramid,
)

# Entry points of the JAX package's TPU layouts, which the port does not
# have: ``facet_conv`` runs the hand-written kernels over the slot-major
# tables, and ``tree_pool`` / ``tree_unpool`` take row-major [N, C] signals.
JAX_ONLY = ("facet_conv_pallas", "facet_conv_nminor", "tree_pool_nminor",
            "tree_unpool_nminor")
