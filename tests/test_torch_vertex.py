"""The port's vertex pipeline against the JAX package: host patches, solver
tables, the zero-ignoring tree pool (K4's plain twin), face-centre pyramid,
both multi-scale solvers, the three-head forward, ``infer_with_vertices``
and ``cli.infer --include_vertices``.

Small widths (channels 8/16/32, M = 4, fc 32), solver schedule (8, 4, 4);
inputs from numpy seeds. ``FGC_DISABLE_NATIVE=1`` keeps both packages on
their NumPy host paths, as tests/test_torch_host.py does; the JAX kernels
run in interpret mode. Tolerances: host tables exact, host floats 1e-6; the
pool bit for bit (atol 0); the solvers atol 2e-5 + rtol 1e-4 (the bar of
tests/test_ops.py, 80 iterations of float32 sums in another order); each
normalized head atol 1e-4; served normals atol 1e-4 and points atol 1e-5 in
the patches' frame (bounding-box diagonal 1).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import facet_graph_convolution_tpu.ops.pallas_conv as pallas_conv
from facet_graph_convolution_tpu.config import default_config as jax_default_config
from facet_graph_convolution_tpu.data.dataset import InferenceMesh as JaxInferenceMesh
from facet_graph_convolution_tpu.geometry.mesh_math import compute_face_normals
from facet_graph_convolution_tpu.geometry.mesh_math import vertex_faces as jax_vertex_faces
from facet_graph_convolution_tpu.inference.driver import (
    infer_with_vertices as jax_infer_with_vertices,
)
from facet_graph_convolution_tpu.models.unet import init_unet as jax_init_unet
from facet_graph_convolution_tpu.models.unet import unet_apply_pallas
from facet_graph_convolution_tpu.ops.normalization import (
    normalize_tensor as jax_normalize_tensor,
)
from facet_graph_convolution_tpu.ops.pallas_kernels import (
    tree_pool_ignore_zeros as jax_tree_pool_ignore_zeros,
)
from facet_graph_convolution_tpu.ops.pooling import tree_pool as jax_tree_pool
from facet_graph_convolution_tpu.ops.vertex_update import (
    build_solver_tables as jax_build_solver_tables,
)
from facet_graph_convolution_tpu.ops.vertex_update import (
    face_centers_pyramid as jax_face_centers_pyramid,
)
from facet_graph_convolution_tpu.ops.vertex_update import (
    update_positions_multiscale as jax_update_positions_multiscale,
)
from facet_graph_convolution_tpu.ops.vertex_update import (
    update_positions_multiscale_operator as jax_update_positions_multiscale_operator,
)
from facet_graph_convolution_tpu.training.trainer import _graph_arrays
from facet_graph_convolution_torch import params as params_io
from facet_graph_convolution_torch.cli import infer as cli_infer
from facet_graph_convolution_torch.config import default_config
from facet_graph_convolution_torch.data.dataset import InferenceMesh
from facet_graph_convolution_torch.data.synthetic import add_vertex_noise, icosphere
from facet_graph_convolution_torch.geometry.mesh_math import vertex_faces
from facet_graph_convolution_torch.geometry.obj_io import load_obj, write_obj
from facet_graph_convolution_torch.inference.driver import infer_with_vertices
from facet_graph_convolution_torch.models.unet import graph_tensors, init_unet, unet_apply
from facet_graph_convolution_torch.ops.normalization import normalize_tensor
from facet_graph_convolution_torch.ops.pooling import tree_pool
from facet_graph_convolution_torch.ops.tree_pool_kernel import (
    tree_pool_ignore_zeros,
    tree_pool_ignore_zeros_plain,
)
from facet_graph_convolution_torch.ops.vertex_update import (
    build_solver_tables,
    face_centers_pyramid,
    update_positions_multiscale,
    update_positions_multiscale_operator,
)
from tests.conftest import make_cube

SMALL = dict(channels=(8, 16, 32), num_filters=4, fc_channels=32)
MODEL = {"channels": SMALL["channels"], "num_filters": 4, "fc_channels": 32}
SCHEDULE = (8, 4, 4)
SOLVER_TOL = dict(atol=2e-5, rtol=1e-4)
PATCH_FIELDS = ("inputs", "num_real", "gt_normals", "patch_indices", "perm_inv", "vertices",
                "gt_vertices", "faces", "v_faces", "v_old_idx", "f_old_idx")
SEVEN_FILES = ("_denoised.obj", "_d_mid.obj", "_d_coarse.obj", "_fine_normals_s.obj",
               "_original_normals.obj", "_mid_normals_s.obj", "_coarse_normals_s.obj")


@pytest.fixture
def numpy_paths(monkeypatch):
    monkeypatch.setenv("FGC_DISABLE_NATIVE", "1")


def _assert_field_equal(name, ours, ref):
    if ref is None:
        assert ours is None, name
        return
    ours, ref = np.asarray(ours), np.asarray(ref)
    assert ours.shape == ref.shape, name
    if np.issubdtype(ref.dtype, np.floating):
        np.testing.assert_allclose(ours, ref, atol=1e-6, err_msg=name)
    else:
        np.testing.assert_array_equal(ours, ref, err_msg=name)


# --- host: patches and solver tables ---------------------------------------

@pytest.mark.parametrize("with_gt", [False, True])
def test_add_mesh_with_vertices_matches_jax(numpy_paths, with_gt):
    """A mesh split into several patches (grow_mesh_patch, vertex_faces,
    normalize_point_sets and, with a GT, point_set_slice) gives the same
    patches for the same seed."""
    v, f = icosphere(3)
    noisy = add_vertex_noise(v, f, 0.2, np.random.default_rng(3))
    kw = dict(max_patch_size=500, coarsening_steps=2, coarsening_levels=3, k_faces=23,
              k_vertices=25, seed=1)
    ours, ref = InferenceMesh(**kw), JaxInferenceMesh(**kw)
    gt = v if with_gt else None
    ours.add_mesh_with_vertices(noisy, f, gt)
    ref.add_mesh_with_vertices(noisy, f, gt)
    assert len(ours.patches) >= 2 and len(ours.patches) == len(ref.patches)
    assert (ours.num_vertices, ours.num_faces) == (ref.num_vertices, ref.num_faces)
    for name in ("vertices", "faces", "normals"):
        _assert_field_equal(name, getattr(ours, name), getattr(ref, name))
    for p, q in zip(ours.patches, ref.patches):
        for name in PATCH_FIELDS:
            _assert_field_equal(name, getattr(p, name), getattr(q, name))
        assert len(p.adjs) == len(q.adjs) == 3
        for a, b in zip(p.adjs, q.adjs):
            np.testing.assert_array_equal(a, b)
        assert (p.faces[:, 0] == -1).sum() == p.num_nodes - p.num_real   # the fakes
    # the patches' vertices are in the frame of the bounding-box diagonal
    diag = np.linalg.norm(noisy.max(axis=0) - noisy.min(axis=0))
    if not with_gt:
        np.testing.assert_allclose(ours.patches[0].vertices,
                                   noisy[ours.patches[0].v_old_idx] / diag, atol=1e-6)


def test_vertex_faces_matches_jax():
    """Fake faces (−1) are skipped; a vertex with more than k_v faces keeps
    its first k_v, in face order."""
    _, f = icosphere(2)
    faces = np.concatenate([f, -np.ones((7, 3), f.dtype)])[np.random.default_rng(0).permutation(
        f.shape[0] + 7)]
    for k_v in (25, 4):
        np.testing.assert_array_equal(vertex_faces(faces, k_v, 0),
                                      jax_vertex_faces(faces, k_v, 0))


def _cube16():
    v, f = make_cube()
    return v, np.concatenate([f, -np.ones((4, 3), np.int32)], axis=0)   # pad to 16


@pytest.mark.parametrize("with_faces", [False, True])
def test_build_solver_tables_matches_jax(numpy_paths, with_faces):
    # the cube padded to 16 faces, and a coarsened icosphere patch
    v, faces16 = _cube16()
    cases = [(jax_vertex_faces(faces16, 25, 8), [16, 4, 1], 8, faces16)]
    mesh = JaxInferenceMesh(max_patch_size=20000, coarsening_steps=2, coarsening_levels=3,
                            k_faces=23, seed=0)
    v2, f2 = icosphere(2)
    mesh.add_mesh_with_vertices(add_vertex_noise(v2, f2, 0.2, np.random.default_rng(0)), f2)
    p = mesh.patches[0]
    cases.append((p.v_faces, [a.shape[0] for a in p.adjs], p.vertices.shape[0], p.faces))
    for v_f, per_level, num_v, faces in cases:
        ours = build_solver_tables(v_f, per_level, num_v, 2, faces=faces if with_faces else None)
        ref = jax_build_solver_tables(v_f, per_level, num_v, 2,
                                      faces=faces if with_faces else None)
        assert len(ours) == len(ref) == 3
        for scale_ours, scale_ref in zip(ours, ref):
            assert len(scale_ours) == len(scale_ref) == (6 if with_faces else 3)
            for a, b in zip(scale_ours, scale_ref):
                b = np.asarray(b)
                assert a.numpy().dtype == b.dtype
                np.testing.assert_array_equal(a.numpy(), b)


# --- the zero-ignoring tree pool (K4's plain twin) -------------------------

def _pool_input(rng, n, c):
    """Rows with zeros, all-zero rows and groups, −0.0 rows and a row of
    single zero channels."""
    x = rng.normal(size=(n, c)).astype(np.float32)
    x[rng.random(n) < 0.3] = 0.0                 # fake nodes
    x[8:16] = 0.0                                # all-zero groups
    x[1] = -0.0                                  # −0.0 counts as zero
    x[5, 0] = -0.0
    x[17] = [0.0] * (c - 1) + [-0.0]
    x[20, :] = 0.0
    x[21, 0] = 0.0                               # one zero channel: not a zero row
    return x


@pytest.mark.parametrize("steps", [1, 2, 3])
@pytest.mark.parametrize("c", [3, 40])
def test_tree_pool_ignore_zeros_matches_jax(c, steps):
    x = _pool_input(np.random.default_rng(steps), 256, c)
    ref = np.asarray(jax_tree_pool(jnp.asarray(x), steps, "avg_ignore_zeros"))
    for out in (tree_pool(torch.as_tensor(x), steps, "avg_ignore_zeros"),
                tree_pool_ignore_zeros_plain(torch.as_tensor(x), steps),
                tree_pool_ignore_zeros(torch.as_tensor(x), steps)):
        assert out.shape == (256 >> steps, c)
        np.testing.assert_array_equal(out.numpy(), ref)
        # the signs of zeros too: bit for bit
        np.testing.assert_array_equal(np.signbit(out.numpy()), np.signbit(ref))


@pytest.mark.parametrize("c", [3, 130])
def test_tree_pool_ignore_zeros_matches_pallas_kernel(c):
    """The TPU kernel (two fused rounds) in interpret mode, bit for bit."""
    x = _pool_input(np.random.default_rng(c), 512, c)
    ref = np.asarray(jax_tree_pool_ignore_zeros(jnp.asarray(x), interpret=True))
    out = tree_pool_ignore_zeros_plain(torch.as_tensor(x), 2).numpy()
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(np.signbit(out), np.signbit(ref))


@pytest.mark.parametrize("mode", ["max", "avg"])
def test_tree_pool_modes_match_jax(mode):
    x = np.random.default_rng(0).normal(size=(64, 5)).astype(np.float32)
    np.testing.assert_allclose(tree_pool(torch.as_tensor(x), 2, mode).numpy(),
                               np.asarray(jax_tree_pool(jnp.asarray(x), 2, mode)), atol=1e-7)


def test_tree_pool_ignore_zeros_refuses_what_it_does_not_take():
    x = torch.zeros(12, 3)
    with pytest.raises(ValueError, match="multiple"):
        tree_pool_ignore_zeros(x, 3)
    with pytest.raises(ValueError, match="shape"):
        tree_pool_ignore_zeros(torch.zeros(12), 2)
    with pytest.raises(ValueError, match="no kernel"):
        tree_pool_ignore_zeros(torch.zeros(12, 3, device="meta"), 2)
    with pytest.raises(ValueError, match="unknown pool mode"):
        tree_pool(x, 2, "median")
    # a NaN row is not a zero row
    y = torch.tensor([[float("nan")], [0.0], [1.0], [0.0]])
    out = tree_pool_ignore_zeros(y, 1)
    assert torch.isnan(out[0]).all() and out[1].item() == 1.0


# --- face centres and the two solvers --------------------------------------

def test_face_centers_pyramid_matches_jax(rng):
    v, faces16 = _cube16()
    x = (v + rng.normal(scale=0.05, size=v.shape)).astype(np.float32)
    for levels in (1, 2, 3):
        ours = face_centers_pyramid(torch.as_tensor(x), torch.as_tensor(faces16), 2, levels)
        ref = jax_face_centers_pyramid(jnp.asarray(x), jnp.asarray(faces16), 2, levels)
        assert len(ours) == len(ref) == levels
        for a, b in zip(ours, ref):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)
    np.testing.assert_array_equal(ours[0][12:].numpy(), 0.0)   # fake faces


def _cube_solver_case(rng):
    """The cube case of tests/test_ops.py: noisy normals padded to 16 faces,
    their pooled mid and coarse levels, noisy vertices."""
    v, faces16 = _cube16()
    gt_n = compute_face_normals(v, faces16[:12])
    n_padded = np.concatenate([gt_n, np.zeros((4, 3), np.float32)], axis=0)
    n_padded += rng.normal(scale=0.05, size=n_padded.shape).astype(np.float32)
    n_padded[12:] = 0.0
    n_mid = np.array(jax_tree_pool(jnp.asarray(n_padded), 2, "avg_ignore_zeros"))
    n_coarse = np.array(jax_tree_pool(jnp.asarray(n_mid), 2, "avg_ignore_zeros"))
    v_f = jax_vertex_faces(faces16, 25, 8)
    noisy = (v + rng.normal(scale=0.05, size=v.shape)).astype(np.float32)
    return noisy, [n_padded, n_mid, n_coarse], faces16, v_f


def _run_solver(side, solver, case, face_tables, schedule=(40, 20, 20)):
    noisy, normals, faces16, v_f = case
    kw = dict(coarsening_steps=2, iter_nums=schedule)
    if side == "jax":
        args = (jnp.asarray(noisy), [jnp.asarray(n) for n in normals], jnp.asarray(faces16),
                jnp.asarray(v_f))
        if solver == "naive":
            out, dx = jax_update_positions_multiscale(*args, checkpoint=False, **kw)
        else:
            tables = jax_build_solver_tables(v_f, [16, 4, 1], 8, 2,
                                             faces=faces16 if face_tables else None)
            out, dx = jax_update_positions_multiscale_operator(*args, tables, checkpoint=False,
                                                               **kw)
        return np.asarray(out), [np.asarray(d) for d in dx]
    args = (torch.as_tensor(noisy), [torch.as_tensor(n) for n in normals],
            torch.as_tensor(faces16), torch.as_tensor(v_f))
    if solver == "naive":
        out, dx = update_positions_multiscale(*args, **kw)
    else:
        tables = build_solver_tables(v_f, [16, 4, 1], 8, 2, faces=faces16 if face_tables else None)
        out, dx = update_positions_multiscale_operator(*args, tables, **kw)
    return out.numpy(), [d.numpy() for d in dx]


@pytest.mark.parametrize("solver,face_tables", [("naive", False), ("operator", False),
                                                ("operator", True)])
def test_multiscale_solver_matches_jax(rng, solver, face_tables):
    case = _cube_solver_case(rng)
    out, dx = _run_solver("torch", solver, case, face_tables)
    out_j, dx_j = _run_solver("jax", solver, case, face_tables)
    assert np.abs(out - case[0]).max() > 1e-3          # the solver moved
    np.testing.assert_allclose(out, out_j, **SOLVER_TOL)
    assert len(dx) == len(dx_j) == 3
    for a, b in zip(dx, dx_j):
        np.testing.assert_allclose(a, b, **SOLVER_TOL)


@pytest.mark.parametrize("solver", ["naive", "operator"])
def test_multiscale_solver_keeps_pads_inert(rng, solver):
    """The −1 pads of v_faces floor-divide to −1 at every scale and read the
    zero normal row (truncating division would map them to face 0): 15 more
    pad columns change nothing, and the result still matches JAX."""
    case = _cube_solver_case(rng)
    padded = (*case[:3], np.concatenate([case[3], -np.ones((8, 15), case[3].dtype)], axis=1))
    out, dx = _run_solver("torch", solver, case, True)
    out_p, dx_p = _run_solver("torch", solver, padded, True)
    np.testing.assert_allclose(out_p, out, atol=1e-6)
    out_j, _ = _run_solver("jax", solver, padded, True)
    np.testing.assert_allclose(out_p, out_j, **SOLVER_TOL)


def test_naive_solver_pools_only_the_levels_it_reads(rng, monkeypatch):
    """Only the pyramid levels the current scale reads are pooled: 2 pools a
    coarse iteration, 1 a mid one, none a fine one."""
    import facet_graph_convolution_torch.ops.tree_pool_kernel as k4

    calls = []
    monkeypatch.setattr(k4, "tree_pool_ignore_zeros",
                        lambda x, steps: calls.append(steps) or k4.tree_pool_ignore_zeros_plain(
                            x, steps))
    _run_solver("torch", "naive", _cube_solver_case(rng), False, schedule=(5, 3, 2))
    assert len(calls) == 2 * 5 + 1 * 3 and set(calls) == {2}


# --- the three-head forward --------------------------------------------------

def test_multi_scale_forward_matches_jax(numpy_paths, monkeypatch):
    orig = pallas_conv.facet_conv_pallas
    monkeypatch.setattr(pallas_conv, "facet_conv_pallas",
                        lambda *a, **kw: orig(*a, **{**kw, "interpret": True}))
    mesh = JaxInferenceMesh(max_patch_size=20000, coarsening_steps=2, coarsening_levels=3,
                            k_faces=23, seed=0)
    v, f = icosphere(3)
    mesh.add_mesh_with_vertices(add_vertex_noise(v, f, 0.2, np.random.default_rng(1)), f)
    patch = mesh.patches[0]
    jparams = jax_init_unet(jax.random.PRNGKey(4), multi_scale=True, **SMALL)
    adjs, adj_ts, mults = _graph_arrays(patch.adjs, pallas=True)
    ref = unet_apply_pallas(jparams, jnp.asarray(patch.inputs), adjs, adj_ts,
                            [mm["pallas_rows"] for mm in mults], coarsening_steps=2,
                            multi_scale=True)
    params = params_io.params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    t_adjs, t_rows = graph_tensors(patch.adjs, "cpu")
    heads = unet_apply(params, torch.as_tensor(patch.inputs), t_adjs, t_rows,
                       coarsening_steps=2, multi_scale=True)
    assert len(heads) == 3
    for head, ref_head, adj in zip(heads, ref, patch.adjs):
        assert head.shape == (adj.shape[0], 3)
        np.testing.assert_allclose(normalize_tensor(head).numpy(),
                                   np.asarray(jax_normalize_tensor(ref_head)), atol=1e-4)


def test_multi_scale_needs_three_levels():
    params = init_unet(0, device="cpu", multi_scale=True, **SMALL)
    adjs, rows = graph_tensors([np.array([[1, 2], [2, 1]], np.int32)], "cpu")
    with pytest.raises(ValueError, match="3-level"):
        unet_apply(params, torch.zeros(2, 6), adjs, rows, multi_scale=True)


# --- serving -----------------------------------------------------------------

@pytest.fixture(scope="module")
def served_mesh():
    os.environ["FGC_DISABLE_NATIVE"] = "1"
    try:
        v, f = icosphere(3)
        mesh = JaxInferenceMesh(max_patch_size=700, coarsening_steps=2, coarsening_levels=3,
                                k_faces=23, seed=0)
        mesh.add_mesh_with_vertices(add_vertex_noise(v, f, 0.3, np.random.default_rng(5)), f)
    finally:
        del os.environ["FGC_DISABLE_NATIVE"]
    assert len(mesh.patches) >= 2
    jparams = jax_init_unet(jax.random.PRNGKey(2), multi_scale=True, **SMALL)
    params = params_io.params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    return mesh, jparams, params


def _cfgs(solver):
    ev = {"ms_solver_iterations": SCHEDULE, "vertex_solver": solver}
    return (jax_default_config().replace(model=MODEL, eval=ev),
            default_config().replace(model=MODEL, eval=ev))


@pytest.mark.parametrize("solver", ["operator", "naive"])
def test_infer_with_vertices_matches_jax(served_mesh, solver):
    mesh, jparams, params = served_mesh
    jcfg, cfg = _cfgs(solver)
    ref = jax_infer_with_vertices(mesh, jcfg, params=jparams)
    out = infer_with_vertices(mesh, cfg, params=params, device="cpu")
    assert out.keys() == ref.keys()
    for key in ("fine_normals", "mid_normals", "coarse_normals"):
        assert out[key].shape == (mesh.num_faces, 3)
        np.testing.assert_allclose(out[key], ref[key], atol=1e-4, err_msg=key)
    for key in ("points", "points_mid", "points_coarse"):
        assert out[key].shape == (mesh.num_vertices, 3) and np.isfinite(out[key]).all()
        np.testing.assert_allclose(out[key], ref[key], atol=1e-5, err_msg=key)
    # the served points are in the patches' frame (the noisy input's
    # bounding-box diagonal scaled to 1), not the input's (diagonal > 3)
    assert np.linalg.norm(mesh.vertices.max(axis=0) - mesh.vertices.min(axis=0)) > 3
    assert np.linalg.norm(out["points"].max(axis=0) - out["points"].min(axis=0)) < 1
    assert np.abs(out["points"] - out["points_coarse"]).max() > 1e-4   # the solver moved


def test_infer_with_vertices_needs_a_card_unless_cpu(served_mesh, monkeypatch):
    mesh, _, params = served_mesh
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        infer_with_vertices(mesh, default_config(), params=params)
    with pytest.raises(ValueError, match="head layers"):
        infer_with_vertices(mesh, default_config(), params=init_unet(0, device="cpu", **SMALL),
                            device="cpu")


def _serve_cli(tmp_path, params, extra=()):
    v, f = icosphere(2)
    in_dir, net_dir, out_dir = tmp_path / "in", tmp_path / "nets", tmp_path / "out"
    in_dir.mkdir()
    write_obj(add_vertex_noise(v, f, 0.2, np.random.default_rng(0)), f,
              str(in_dir / "sphere_n2.obj"))
    params_io.save(params, params_io.checkpoint_path(str(net_dir), "net"))
    cli_infer.main(["--device", "cpu", "--input_dir", str(in_dir), "--network_path",
                    str(net_dir), "--results_path", str(out_dir), *extra])
    return v, f, out_dir


def test_cli_infer_include_vertices_writes_seven_files(tmp_path):
    """--include_vertices serves the vertex pipeline: the JAX package's seven
    files (before, the flag was ignored and the normals pipeline ran)."""
    v, f, out_dir = _serve_cli(tmp_path, init_unet(0, device="cpu", multi_scale=True, **SMALL),
                               ["--include_vertices"])
    assert sorted(os.listdir(out_dir)) == sorted("sphere_n2" + s for s in SEVEN_FILES)
    for name in ("_denoised.obj", "_d_mid.obj", "_d_coarse.obj"):
        out_v, out_f, _ = load_obj(str(out_dir / ("sphere_n2" + name)))
        assert out_v.shape == v.shape and np.isfinite(out_v).all()
        np.testing.assert_array_equal(out_f.astype(np.int64), f.astype(np.int64))


def test_cli_infer_include_vertices_needs_multi_scale_heads(tmp_path):
    with pytest.raises(ValueError, match="head layers"):
        _serve_cli(tmp_path, init_unet(0, device="cpu", **SMALL), ["--include_vertices"])
