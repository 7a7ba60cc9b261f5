"""Host mesh geometry: the port's copies of OBJ I/O, mesh math, point sets
and the classical filters."""

from facet_graph_convolution_torch.geometry.mesh_math import (  # noqa: F401
    normalize_rows,
    compute_face_normals,
    compute_vertex_normals,
    triangle_barycenters,
    triangle_areas,
    average_edge_length,
    edge_map,
    face_adjacency_edges,
    border_faces,
    vertex_faces,
)
from facet_graph_convolution_torch.geometry.obj_io import (  # noqa: F401
    load_obj,
    load_off_pc,
    load_coff_pc,
    write_obj,
    write_xyz,
    write_coff,
    colored_mesh,
    heatmap_mesh,
    heatmap_colors,
    normals_to_colors,
)
from facet_graph_convolution_torch.geometry.pointset import (  # noqa: F401
    bounding_box,
    bounding_box_diagonal,
    normalize_point_sets,
    point_set_slice,
    dense_point_cloud,
    random_rotation_matrix,
)
from facet_graph_convolution_torch.geometry.filters import (  # noqa: F401
    bilateral_filter_normals,
    fnd_descriptors,
    face_assignment,
    face_curvature_stats,
    filter_flipped_faces,
    graph_distance,
    faces_debug_mesh,
    kmeans,
)
