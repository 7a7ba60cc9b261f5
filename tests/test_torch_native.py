"""The port's C++ host library (``facet_graph_convolution_torch/csrc/
graphlib.cpp`` through ``graph/native.py``) against the JAX package's
(``native/graphlib.cpp``), on the inputs of tests/test_native.py.

The four native functions must give the JAX package's native outputs bit
for bit, and the port's native-built ``InferenceMesh`` and vertex
``TrainingSet`` the JAX package's native builds for the same seed: integer
tables exactly, floats within 1e-6. With ``FGC_DISABLE_NATIVE=1`` both
packages take their NumPy paths, which coarsen differently (the inverse node
weights in float32; ``graph/native.py`` says where). Skipped only where
``g++`` is missing.
"""

import shutil
import warnings

import numpy as np
import pytest
import scipy.sparse

from facet_graph_convolution_tpu.data.dataset import InferenceMesh as JaxInferenceMesh
from facet_graph_convolution_tpu.data.dataset import TrainingSet as JaxTrainingSet
from facet_graph_convolution_tpu.graph import native as jax_native
from facet_graph_convolution_torch.data.dataset import InferenceMesh, TrainingSet
from facet_graph_convolution_torch.data.synthetic import add_vertex_noise, icosphere
from facet_graph_convolution_torch.geometry.mesh_math import (
    compute_face_normals,
    triangle_barycenters,
)
from facet_graph_convolution_torch.geometry.obj_io import load_obj
from facet_graph_convolution_torch.graph import native
from facet_graph_convolution_torch.graph.adjacency import face_adjacency_klist
from facet_graph_convolution_torch.graph.convert import klist_to_coo_normal_weighted
from tests.conftest import make_icosphere

pytestmark = pytest.mark.skipif(shutil.which("g++") is None, reason="g++ not installed")

PATCH_FIELDS = ("inputs", "num_real", "gt_normals", "patch_indices", "perm_inv", "vertices",
                "gt_vertices", "faces", "v_faces", "v_old_idx", "f_old_idx")
QUIRKY_OBJ = "\n".join([
    "# a comment",
    "v 0.0 0.0 0.0",
    "v 1.0 0.0 0.0 0.5",
    "v 1.0 1.0 0.0",
    "v 0.0 1.0 0.25",
    "v 0.5 0.5 1.0",
    "vn 0.0 0.0 1.0",
    "vt 0.5 0.5",
    "g group1",
    "f 1/1/1 2/2/1 3/3/1",
    "f 1 3 4 5",
    "",
    "f 2//1 3//1 5//1",
]) + "\n"


@pytest.fixture(autouse=True)
def native_paths(monkeypatch):
    monkeypatch.delenv("FGC_DISABLE_NATIVE", raising=False)


def test_library_builds_into_csrc_build():
    assert native.available()
    assert native.LIBRARY.endswith("facet_graph_convolution_torch/csrc/build/libgraph.so")
    assert native.GXX_FLAGS == ["-O3", "-march=native", "-shared", "-fPIC", "-std=c++17"]


def test_match_one_level_matches_jax_native():
    v, f = make_icosphere(2)
    adj = face_adjacency_klist(f, 23)
    coo = klist_to_coo_normal_weighted(adj, triangle_barycenters(v, f),
                                       compute_face_normals(v, f))
    idx_row, idx_col, val = scipy.sparse.find(coo)
    perm = np.argsort(idx_row, kind="stable")
    rr, cc, vv = idx_row[perm].astype(np.int64), idx_col[perm].astype(np.int64), val[perm]
    n = coo.shape[0]
    weights = np.asarray(coo.sum(axis=0)).squeeze()
    rid = np.random.default_rng(0).permutation(n)
    ours = native.match_one_level_native(rr, cc, vv, rid, weights, n)
    ref = jax_native.match_one_level_native(rr, cc, vv, rid, weights, n)
    np.testing.assert_array_equal(ours[0], ref[0])
    assert ours[1] == ref[1]


def test_grow_patch_matches_jax_native():
    v, f = make_icosphere(2)
    adj = face_adjacency_klist(f, 23)
    n = adj.shape[0]
    mask = np.zeros(n, dtype=np.int8)
    mask[: n // 3] = 1
    for args in ((120, n - 1, mask, 50), (120, 0, None, 50), (30, n // 2, mask, 200)):
        ours = native.grow_patch_native(adj, *args)
        ref = jax_native.grow_patch_native(adj, *args)
        np.testing.assert_array_equal(ours[0], ref[0])
        np.testing.assert_array_equal(ours[1], ref[1])
        assert ours[2] == ref[2]


@pytest.mark.parametrize("case", ["sphere-23", "sphere-7", "soup-23", "soup-9"])
def test_face_adjacency_matches_jax_native(case):
    """Including which connections drop past K (k = 7 and 9)."""
    name, k = case.split("-")
    if name == "sphere":
        faces = make_icosphere(2)[1]
    else:
        fr = np.random.default_rng(0).integers(0, 40, size=(200, 3))
        faces = fr[(fr[:, 0] != fr[:, 1]) & (fr[:, 1] != fr[:, 2]) & (fr[:, 0] != fr[:, 2])]
    faces = np.asarray(faces, dtype=np.int64)
    ours = native.face_adjacency_native(faces, int(faces.max()) + 1, int(k))
    ref = jax_native.face_adjacency_native(faces, int(faces.max()) + 1, int(k))
    np.testing.assert_array_equal(ours[0], ref[0])
    assert ours[1] == ref[1]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        hooked, dropped = face_adjacency_klist(faces, int(k), return_dropped=True)
    np.testing.assert_array_equal(hooked, ref[0])
    assert dropped == ref[1]


def test_obj_parser_matches_jax_native(tmp_path, monkeypatch):
    """The quirky file of tests/test_native.py (comments, vn/vt lines, a
    quad, texture/normal tokens, a 4th vertex coordinate), and
    ``load_obj``'s native path against its NumPy loop."""
    p = tmp_path / "mesh.obj"
    p.write_text(QUIRKY_OBJ)
    verts, tris = native.parse_obj_native(str(p))
    ref_verts, ref_tris = jax_native.parse_obj_native(str(p))
    np.testing.assert_array_equal(verts, ref_verts)
    np.testing.assert_array_equal(tris, ref_tris)
    assert tris.shape == (4, 3)
    v_nat, f_nat, n_nat = load_obj(str(p))
    monkeypatch.setenv("FGC_DISABLE_NATIVE", "1")
    v_py, f_py, n_py = load_obj(str(p))
    np.testing.assert_array_equal(v_nat, v_py)
    np.testing.assert_array_equal(f_nat, f_py)
    assert f_nat.dtype == f_py.dtype
    np.testing.assert_allclose(n_nat, n_py, atol=1e-6)


@pytest.mark.parametrize("text", ["v 0 0 0\nv 1 2",                               # truncated
                                  "v 0 0 0\nv 1 0 0\nv 0 1 0\nf -1 -2 -3\n",      # relative
                                  "v 0 0\n1 2 3\nv 1 0 0\nv 0 1 0\nf 1 2 3\n"],   # short line
                         ids=["truncated", "relative", "short-vertex-line"])
def test_obj_parser_refuses_what_jax_native_refuses(tmp_path, text):
    p = tmp_path / "bad.obj"
    p.write_text(text)
    for parse in (native.parse_obj_native, jax_native.parse_obj_native):
        with pytest.raises(OSError):
            parse(str(p))


def _assert_patches_equal(ours, ref):
    assert len(ours.patches) == len(ref.patches)
    for a, b in zip(ours.patches, ref.patches):
        assert len(a.adjs) == len(b.adjs)
        for x, y in zip(a.adjs, b.adjs):
            np.testing.assert_array_equal(x, y)
        for name in PATCH_FIELDS:
            x, y = getattr(a, name), getattr(b, name)
            if y is None:
                assert x is None, name
            elif np.issubdtype(np.asarray(y).dtype, np.floating):
                np.testing.assert_allclose(x, y, atol=1e-6, err_msg=name)
            else:
                np.testing.assert_array_equal(x, y, err_msg=name)


def test_inference_mesh_matches_jax_native_build():
    v, f = icosphere(3)
    noisy = add_vertex_noise(v, f, 0.3, np.random.default_rng(5))
    meshes = []
    for cls in (InferenceMesh, JaxInferenceMesh):
        mesh = cls(max_patch_size=700, min_patch_size=800, coarsening_steps=2,
                   coarsening_levels=3, k_faces=23, seed=0)
        mesh.add_mesh(noisy, f)
        meshes.append(mesh)
    assert len(meshes[0].patches) >= 2
    _assert_patches_equal(*meshes)
    for name in ("edge_map", "v_e_map", "faces"):
        np.testing.assert_array_equal(getattr(meshes[0], name), getattr(meshes[1], name))
    np.testing.assert_allclose(meshes[0].normals, meshes[1].normals, atol=1e-6)


def test_vertex_training_set_matches_jax_native_build():
    v, f = icosphere(2)
    rng = np.random.default_rng(1)
    noisy = add_vertex_noise(v, f, 0.2, rng)
    sets = []
    for cls in (TrainingSet, JaxTrainingSet):
        ds = cls(max_patch_size=200, coarsening_steps=2, coarsening_levels=3, k_faces=23,
                 seed=0)
        ds.add_mesh_with_vertices(noisy, f, gt_vertices=v)
        sets.append(ds)
    assert len(sets[0].patches) >= 2
    _assert_patches_equal(*sets)


def test_disable_switch_puts_both_packages_on_numpy(monkeypatch):
    """``FGC_DISABLE_NATIVE=1`` (the JAX package's switch): neither library
    is used, and both packages build the NumPy pyramid, which differs from
    the native one for the same seed (3,680 / 920 / 230 nodes natively and
    3,664 / 916 / 229 in NumPy on patch 0 of this mesh)."""
    v, f = icosphere(4)
    noisy = add_vertex_noise(v, f, 0.2, np.random.default_rng(0))

    def build(cls):
        mesh = cls(max_patch_size=3000, coarsening_steps=2, coarsening_levels=3, k_faces=23,
                   seed=0)
        mesh.add_mesh(noisy, f)
        return mesh

    native_mesh = build(InferenceMesh)
    monkeypatch.setenv("FGC_DISABLE_NATIVE", "1")
    assert not native.available()
    with pytest.raises(ImportError):
        jax_native._load()
    ours, ref = build(InferenceMesh), build(JaxInferenceMesh)
    _assert_patches_equal(ours, ref)
    assert [a.shape[0] for a in native_mesh.patches[0].adjs] == [3680, 920, 230]
    assert [a.shape[0] for a in ours.patches[0].adjs] == [3664, 916, 229]
