"""The port's host copies against the JAX package's NumPy paths.

``FGC_DISABLE_NATIVE=1`` forces both packages onto their NumPy paths
(their C++ fast paths coarsen to other patches for the same seed; the
native builds are held to each other in tests/test_torch_native.py).
Integer tables must match exactly, floats to 1e-6.
"""

import contextlib

import numpy as np
import pytest

from facet_graph_convolution_tpu.data.dataset import InferenceMesh as JaxInferenceMesh
from facet_graph_convolution_tpu.data.synthetic import add_vertex_noise as jax_noise
from facet_graph_convolution_tpu.data.synthetic import icosphere as jax_icosphere
from facet_graph_convolution_tpu.geometry import load_obj as jax_load_obj
from facet_graph_convolution_tpu.geometry.mesh_math import edge_map as jax_edge_map
from facet_graph_convolution_tpu.graph.adjacency import (
    face_adjacency_klist as jax_face_adjacency_klist,
)
from facet_graph_convolution_tpu.graph.convert import dedupe_klist as jax_dedupe
from facet_graph_convolution_tpu.graph.convert import split_self_klist as jax_split
from facet_graph_convolution_tpu.ops.pallas_conv import (
    slot_major_arrays as jax_slot_major_arrays,
)
from facet_graph_convolution_torch.data.dataset import InferenceMesh
from facet_graph_convolution_torch.data.synthetic import add_vertex_noise, icosphere
from facet_graph_convolution_torch.geometry.mesh_math import edge_map
from facet_graph_convolution_torch.geometry.obj_io import load_obj, write_obj
from facet_graph_convolution_torch.graph.adjacency import face_adjacency_klist
from facet_graph_convolution_torch.graph.convert import (
    dedupe_klist,
    slot_major_arrays,
    split_self_klist,
)
from tests.conftest import make_cube


@pytest.fixture
def numpy_paths(monkeypatch):
    monkeypatch.setenv("FGC_DISABLE_NATIVE", "1")


def _noisy_sphere(subdiv, seed=0):
    v, f = icosphere(subdiv)
    return add_vertex_noise(v, f, 0.2, np.random.default_rng(seed)), f


def test_synthetic_meshes_match():
    v, f = icosphere(3)
    jv, jf = jax_icosphere(3)
    np.testing.assert_array_equal(f, jf)
    np.testing.assert_array_equal(v, jv)
    np.testing.assert_array_equal(
        add_vertex_noise(v, f, 0.2, np.random.default_rng(1)),
        jax_noise(jv, jf, 0.2, np.random.default_rng(1)))


@pytest.mark.parametrize("k", [23, 8])
@pytest.mark.parametrize("mesh", ["cube", "sphere"])
def test_face_adjacency_klist_matches(numpy_paths, mesh, k):
    # k=8 drops connections (warns) on both sides
    faces = make_cube()[1] if mesh == "cube" else icosphere(2)[1]
    with pytest.warns(UserWarning) if k == 8 else contextlib.nullcontext():
        ours, dropped = face_adjacency_klist(faces, k, return_dropped=True)
    with pytest.warns(UserWarning) if k == 8 else contextlib.nullcontext():
        ref, ref_dropped = jax_face_adjacency_klist(faces, k, return_dropped=True)
    np.testing.assert_array_equal(ours, ref)
    assert dropped == ref_dropped


@pytest.mark.parametrize("max_edges", [20, 4])
def test_edge_map_matches(max_edges):
    faces = icosphere(2)[1]
    e, ve = edge_map(faces, max_edges=max_edges)
    je, jve = jax_edge_map(faces, max_edges=max_edges)
    np.testing.assert_array_equal(e, je)
    np.testing.assert_array_equal(ve, jve)


def test_klist_tables_match(numpy_paths, rng):
    # random K-lists with duplicates, self-only rows and pads, N = 61 and a
    # larger N that slot_major_arrays pads to a multiple of 256
    for n in (61, 300):
        adj = np.zeros((n, 9), np.int32)
        adj[:, 0] = np.arange(n) + 1
        for i in range(n):
            deg = int(rng.integers(0, 8))
            adj[i, 1:1 + deg] = rng.choice(n, size=deg, replace=True) + 1
        a_u, mult = dedupe_klist(adj)
        ja_u, jmult = jax_dedupe(adj)
        np.testing.assert_array_equal(a_u, ja_u)
        np.testing.assert_array_equal(mult, jmult)
        split = split_self_klist(a_u, mult)
        jsplit = jax_split(ja_u, jmult)
        for ours, ref in zip(split, jsplit):
            np.testing.assert_array_equal(ours, ref)
        for ours, ref in zip(slot_major_arrays(*split), jax_slot_major_arrays(*jsplit)):
            assert ours.dtype == ref.dtype
            np.testing.assert_array_equal(ours, ref)


def test_obj_round_trip_matches(numpy_paths, tmp_path):
    v, f = _noisy_sphere(2)
    path = str(tmp_path / "sphere.obj")
    write_obj(v, f, path)
    ours = load_obj(path)
    ref = jax_load_obj(path)
    for a, b in zip(ours, ref):
        assert a.dtype == b.dtype
        np.testing.assert_allclose(a, b, atol=1e-6)


def test_inference_mesh_patches_match(numpy_paths):
    """A small max_patch_size splits the mesh into several masked BFS
    patches; the same seed gives the same patches on both sides."""
    v, f = _noisy_sphere(3)
    kw = dict(max_patch_size=500, min_patch_size=600, coarsening_steps=2,
              coarsening_levels=3, k_faces=23, seed=0)
    ours = InferenceMesh(**kw)
    ours.add_mesh(v, f)
    ref = JaxInferenceMesh(**kw)
    ref.add_mesh(v, f)
    assert len(ours.patches) >= 2
    assert len(ours.patches) == len(ref.patches)
    for name in ("edge_map", "v_e_map", "vertices", "faces", "normals"):
        np.testing.assert_array_equal(getattr(ours, name), getattr(ref, name))
    for p, q in zip(ours.patches, ref.patches):
        assert p.num_real == q.num_real
        np.testing.assert_array_equal(p.inputs, q.inputs)
        np.testing.assert_array_equal(p.patch_indices, q.patch_indices)
        np.testing.assert_array_equal(p.perm_inv, q.perm_inv)
        assert len(p.adjs) == len(q.adjs) == 3
        for a, b in zip(p.adjs, q.adjs):
            np.testing.assert_array_equal(a, b)
