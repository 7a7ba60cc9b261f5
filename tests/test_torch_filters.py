"""The port's host copies (``geometry/filters.py``, the geometry helpers of
``mesh_math``, ``pointset`` and ``obj_io``, ``graph/adjacency.py::
vertex_ring_adjacency``, ``graph/patching.py::grow_graph_patch``,
``data/synthetic.py::box`` and ``cylinder_on_plate``) against the JAX
package's. Both are NumPy (and SciPy), so every output is held bit for bit,
written files byte for byte."""

import numpy as np
import pytest

from facet_graph_convolution_tpu.data import synthetic as jax_synthetic
from facet_graph_convolution_tpu.geometry import filters as jax_filters
from facet_graph_convolution_tpu.geometry import mesh_math as jax_mesh_math
from facet_graph_convolution_tpu.geometry import obj_io as jax_obj_io
from facet_graph_convolution_tpu.geometry import pointset as jax_pointset
from facet_graph_convolution_tpu.graph.adjacency import (
    vertex_ring_adjacency as jax_vertex_ring_adjacency,
)
from facet_graph_convolution_tpu.graph.patching import grow_graph_patch as jax_grow_graph_patch
from facet_graph_convolution_torch.data import synthetic
from facet_graph_convolution_torch.geometry import filters, mesh_math, obj_io, pointset
from facet_graph_convolution_torch.graph.adjacency import (
    face_adjacency_klist,
    vertex_ring_adjacency,
)
from facet_graph_convolution_torch.graph.patching import grow_graph_patch


def _equal(a, b):
    if isinstance(a, tuple):
        assert isinstance(b, tuple) and len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    else:
        assert np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def mesh():
    v, f = synthetic.icosphere(2)
    noisy = synthetic.add_vertex_noise(v, f, 0.2, np.random.default_rng(0))
    normals = mesh_math.compute_face_normals(noisy, f)
    centers = mesh_math.triangle_barycenters(noisy, f, normalize=False)
    areas = mesh_math.triangle_areas(noisy, f)
    return noisy, f, normals, centers, areas, face_adjacency_klist(f, 23)


def test_bilateral_filter_and_fnd_match_jax(mesh):
    _, _, normals, centers, areas, _ = mesh
    for sigma_r in (0.5, -1):
        _equal(filters.bilateral_filter_normals(centers, normals, areas, 0.2, sigma_r),
               jax_filters.bilateral_filter_normals(centers, normals, areas, 0.2, sigma_r))
    _equal(filters.fnd_descriptors(centers, normals, areas, [0.1, 0.2], [0.3, -1]),
           jax_filters.fnd_descriptors(centers, normals, areas, [0.1, 0.2], [0.3, -1]))


def test_curvature_flipped_faces_and_debug_mesh_match_jax(mesh):
    _, _, normals, centers, _, adj = mesh
    _equal(filters.face_curvature_stats(centers, normals, adj),
           jax_filters.face_curvature_stats(centers, normals, adj))
    flipped = normals.copy()
    flipped[[3, 40]] *= -1
    _equal(filters.filter_flipped_faces(flipped, adj),
           jax_filters.filter_flipped_faces(flipped, adj))
    _equal(filters.faces_debug_mesh(adj, centers, normals),
           jax_filters.faces_debug_mesh(adj, centers, normals))
    for dst in (0, 7, 150):
        assert filters.graph_distance(adj, 0, dst) == jax_filters.graph_distance(adj, 0, dst)


def test_kmeans_and_face_assignment_match_jax(mesh):
    noisy, f, _, centers, _, _ = mesh
    ours = filters.kmeans(centers, 4, iternum=20, repeats=3, rng=np.random.default_rng(5))
    theirs = jax_filters.kmeans(centers, 4, iternum=20, repeats=3, rng=np.random.default_rng(5))
    _equal(ours, theirs)
    v, f2 = synthetic.icosphere(3)
    _equal(filters.face_assignment(noisy, f, v, f2, 3),
           jax_filters.face_assignment(noisy, f, v, f2, 3))


@pytest.mark.parametrize("shape", ["icosphere", "open box"])
def test_mesh_math_helpers_match_jax(shape):
    if shape == "icosphere":
        v, f = synthetic.icosphere(2)
    else:
        v, f = synthetic.chamfered_box(6)
        f = f[f[:, 0] != 0]
    _equal(mesh_math.border_faces(f), jax_mesh_math.border_faces(f))
    for normalize in (False, True):
        _equal(mesh_math.triangle_areas(v, f, normalize),
               jax_mesh_math.triangle_areas(v, f, normalize))
    _equal(mesh_math.face_adjacency_edges(f), jax_mesh_math.face_adjacency_edges(f))
    assert (mesh_math.border_faces(f).sum() > 0) == (shape == "open box")


def test_pointset_helpers_match_jax(mesh):
    noisy, f = mesh[:2]
    for res in (1, 2, 4):
        _equal(pointset.dense_point_cloud(noisy, f, res),
               jax_pointset.dense_point_cloud(noisy, f, res))
    _equal(pointset.random_rotation_matrix(rng=np.random.default_rng(3)),
           jax_pointset.random_rotation_matrix(rng=np.random.default_rng(3)))
    nums = np.asarray([0.2, 0.7, 0.4])
    rot = pointset.random_rotation_matrix(0.5, randnums=nums)
    _equal(rot, jax_pointset.random_rotation_matrix(0.5, randnums=nums))
    np.testing.assert_allclose(rot @ rot.T, np.eye(3), atol=1e-12)


def test_heatmaps_and_point_files_match_jax(mesh, tmp_path):
    noisy, f, normals = mesh[:3]
    heat = np.linspace(-0.2, 1.2, f.shape[0])
    _equal(obj_io.heatmap_colors(heat), jax_obj_io.heatmap_colors(heat))
    _equal(obj_io.heatmap_mesh(noisy, f, heat), jax_obj_io.heatmap_mesh(noisy, f, heat))
    colored = np.concatenate([noisy, obj_io.normals_to_colors(
        mesh_math.compute_vertex_normals(noisy, f))], axis=1)
    for name, ours, theirs, data in (
            ("pts.xyz", obj_io.write_xyz, jax_obj_io.write_xyz, noisy),
            ("pts.coff", obj_io.write_coff, jax_obj_io.write_coff, colored)):
        ours(data, str(tmp_path / ("port_" + name)))
        theirs(data, str(tmp_path / ("jax_" + name)))
        assert (tmp_path / ("port_" + name)).read_bytes() == (
            tmp_path / ("jax_" + name)).read_bytes()
    coff = str(tmp_path / "port_pts.coff")
    _equal(obj_io.load_coff_pc(coff), jax_obj_io.load_coff_pc(coff))
    off = tmp_path / "pts.off"
    off.write_text("OFF\n%d 0 0\n" % noisy.shape[0]
                   + "".join("%f %f %f\n" % tuple(p) for p in noisy))
    _equal(obj_io.load_off_pc(str(off)), jax_obj_io.load_off_pc(str(off)))
    with pytest.raises(ValueError, match="OFF header"):
        obj_io.load_off_pc(coff)


def test_ring_adjacency_and_patch_growth_match_jax(mesh):
    noisy, f, _, _, _, adj = mesh
    for k in (4, 8):
        _equal(vertex_ring_adjacency(noisy, f, k), jax_vertex_ring_adjacency(noisy, f, k))
    for size, seed in ((50, 0), (200, 17), (10**6, 3)):
        ours = grow_graph_patch(adj, size, seed)
        theirs = jax_grow_graph_patch(adj, size, seed)
        assert ours[0].shape == theirs[0].shape
        _equal(ours[0].astype(np.int64), theirs[0].astype(np.int64))
        _equal(ours[1].astype(np.int64), theirs[1].astype(np.int64))


@pytest.mark.parametrize("shape", ["box", "cylinder_on_plate"])
def test_synthetic_shapes_match_jax(shape):
    kwargs = {"box": [{}, {"nx": 3, "ny": 5, "nz": 2, "size": (2.0, 1.0, 0.5)}],
              "cylinder_on_plate": [{}, {"n_theta": 16, "n_h": 2, "n_r": 2}]}[shape]
    for kw in kwargs:
        v, f = getattr(synthetic, shape)(**kw)
        _equal((v, f), getattr(jax_synthetic, shape)(**kw))
        # watertight: every edge has two faces
        e_map, _ = mesh_math.edge_map(f)
        assert (e_map[:, 3] >= 0).all()
