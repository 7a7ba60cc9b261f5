"""The port's sharded multi-scale vertex serving and K4's backward against the
JAX package, on the CPU.

- K4's backward (``ops/tree_pool_kernel.py``): the plain backward against
  ``jax.grad`` of JAX ``tree_pool(mode="avg_ignore_zeros")`` at 2 and 4
  rounds, on zero rows, zero groups and -0.0 rows; the autograd Function
  on CPU tensors against autograd through the plain pool; the wrapper's
  refusals. (The CUDA kernel against the plain backward is in
  tests/test_torch_cuda.py.)
- ``parallel/vertex_halo.py::sharded_update_positions_multiscale`` at D =
  1, 2 and 4 gloo ranks (``tests/torch_halo_ranks.py``) against JAX's on
  as many virtual devices, and at D = 1 against the port's flat
  ``update_positions_multiscale``; the operands of both sharded solvers
  against JAX's, array for array.
- ``inference/sharded.py::infer_with_vertices_sharded`` at D = 1, 2 and 4
  against JAX's, every key.
- The driver ``parallel/vertex_train.py::train_with_vertices_sharded`` at D
  = 2 (its steps are held to JAX's in
  tests/test_torch_sharded_vertex_train.py): the validation column, the CSV
  of rank 0 alone, checkpoints every ``min(save_every, 500)`` and a resume
  that continues the step count, and the NaN abort (no final checkpoint).

One noisy ``icosphere(2)`` patch built with vertices; channels 8/16/32,
M = 4, fc 32; schedules (10, 5, 5) and (8, 4, 4). Tolerances: the
backward exactly (its cotangents are halved and summed, exact in
float32); the solver atol 1e-4 (JAX's
``test_sharded_multiscale_solver_matches_single_device``), serving atol
2e-4 (``test_sharded_with_vertices_inference_matches``).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facet_graph_convolution_tpu.config import default_config as jax_default_config
from facet_graph_convolution_tpu.data.dataset import TrainingSet as JaxTrainingSet
from facet_graph_convolution_tpu.inference.sharded import (
    infer_with_vertices_sharded as jax_infer_with_vertices_sharded,
)
from facet_graph_convolution_tpu.models.unet import init_unet as jax_init_unet
from facet_graph_convolution_tpu.ops.pooling import tree_pool as jax_tree_pool
from facet_graph_convolution_tpu.parallel import vertex_halo as jax_vertex_halo
from facet_graph_convolution_tpu.parallel.mesh import make_mesh as jax_make_mesh
from facet_graph_convolution_torch.config import default_config
from facet_graph_convolution_torch.data.dataset import InferenceMesh
from facet_graph_convolution_torch.inference.sharded import infer_with_vertices_sharded
from facet_graph_convolution_torch.ops import tree_pool_kernel as k4
from facet_graph_convolution_torch.ops.vertex_update import update_positions_multiscale
from facet_graph_convolution_torch.params import params_from_jax
from facet_graph_convolution_torch.parallel import vertex_halo
from facet_graph_convolution_torch.parallel.mesh import GraphGroup
from tests.conftest import make_icosphere
from tests.torch_halo_ranks import run_ranks

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")

WIDTHS = {"channels": (8, 16, 32), "num_filters": 4, "fc_channels": 32}
CPU = GraphGroup(0, 1, torch.device("cpu"))
ITERS = (10, 5, 5)


def _pool_input(rng, n, c):
    x = rng.normal(size=(n, c)).astype(np.float32)
    x[rng.random(n) < 0.3] = 0.0
    x[16:32] = 0.0           # a whole group of 16 at zero
    x[1] = -0.0
    x[5, :] = 0.0
    x[5, -1] = -0.0
    return x


@pytest.mark.parametrize("steps", [2, 4])
@pytest.mark.parametrize("c", [3, 5])
def test_pool_backward_matches_jax_grad(steps, c):
    rng = np.random.default_rng(steps * 10 + c)
    x = _pool_input(rng, 16 * 24, c)
    dy = rng.normal(size=(x.shape[0] >> steps, c)).astype(np.float32)
    _, vjp = jax.vjp(lambda a: jax_tree_pool(a, steps, "avg_ignore_zeros"), jnp.asarray(x))
    want = np.asarray(vjp(jnp.asarray(dy))[0])
    got = k4.tree_pool_ignore_zeros_bwd_plain(torch.as_tensor(x), torch.as_tensor(dy), steps)
    np.testing.assert_array_equal(got.numpy(), want)
    # the wrapper takes the plain backward on CPU tensors
    np.testing.assert_array_equal(
        k4.tree_pool_ignore_zeros_bwd(torch.as_tensor(x), torch.as_tensor(dy), steps).numpy(),
        want)


@pytest.mark.parametrize("steps", [1, 2, 4])
def test_pool_function_on_cpu_matches_autograd_through_plain(steps):
    rng = np.random.default_rng(steps)
    x = torch.as_tensor(_pool_input(rng, 16 * 8, 3))
    dy = torch.as_tensor(rng.normal(size=(x.shape[0] >> steps, 3)).astype(np.float32))
    a, b = x.clone().requires_grad_(), x.clone().requires_grad_()
    out = k4.TreePoolIgnoreZeros.apply(a, steps)
    assert torch.equal(out, k4.tree_pool_ignore_zeros_plain(x, steps))
    out.backward(dy)
    k4.tree_pool_ignore_zeros_plain(b, steps).backward(dy)
    assert torch.equal(a.grad, b.grad)
    before = (k4.tree_pool_ignore_zeros.launches, k4.tree_pool_ignore_zeros_bwd.launches)
    c = x.clone().requires_grad_()
    k4.tree_pool_ignore_zeros(c, steps).backward(dy)
    assert torch.equal(c.grad, b.grad)
    # no kernel on the CPU: the counts stay
    assert (k4.tree_pool_ignore_zeros.launches, k4.tree_pool_ignore_zeros_bwd.launches) == before


def test_pool_backward_refuses_what_it_does_not_take():
    x = torch.zeros(16, 3)
    with pytest.raises(ValueError, match="dy"):
        k4.tree_pool_ignore_zeros_bwd(x, torch.zeros(3, 3), 2)
    with pytest.raises(ValueError, match="multiple"):
        k4.tree_pool_ignore_zeros_bwd(x, torch.zeros(1, 3), 5)
    with pytest.raises(ValueError, match="no kernel"):
        k4.tree_pool_ignore_zeros_bwd(x.to("meta"), torch.zeros(4, 3, device="meta"), 2)


@pytest.fixture(scope="module")
def patch():
    v, f = make_icosphere(2)
    noisy = (v + np.random.default_rng(3).normal(scale=0.03, size=v.shape)).astype(np.float32)
    ds = JaxTrainingSet(max_patch_size=10**9, coarsening_steps=2, coarsening_levels=3,
                        k_faces=23, seed=0)
    ds.add_mesh_with_vertices(noisy, f, gt_vertices=v)
    return ds.patches[0]


def _solver_args(patch):
    n0 = patch.gt_normals
    n1 = np.asarray(jax_tree_pool(jnp.asarray(n0), 2, "avg_ignore_zeros"))
    n2 = np.asarray(jax_tree_pool(jnp.asarray(n1), 2, "avg_ignore_zeros"))
    return (patch.vertices, [n0, n1, n2], patch.faces, patch.v_faces)


@pytest.mark.parametrize("shards", [1, 2, 4])
def test_sharded_multiscale_solver_matches_jax(patch, shards, tmp_path):
    """Points and per-scale displacements against JAX's sharded solver on as
    many devices, and at D = 1 against the port's flat solver."""
    args = _solver_args(patch)
    if shards == 1:
        got = vertex_halo.sharded_update_positions_multiscale(*args, group=CPU, iter_nums=ITERS)
        ref, ref_dx = update_positions_multiscale(
            torch.as_tensor(args[0]), [torch.as_tensor(n) for n in args[1]],
            torch.as_tensor(args[2]), torch.as_tensor(args[3]), iter_nums=ITERS)
        np.testing.assert_allclose(got[0], ref.numpy(), atol=1e-4)
        for a, b in zip(got[1], ref_dx):
            np.testing.assert_allclose(a, b.numpy(), atol=1e-4)
    else:
        out = run_ranks("multiscale", shards, {"args": args, "iters": ITERS}, str(tmp_path))
        for other in out[1:]:
            np.testing.assert_array_equal(other[0], out[0][0])
        got = out[0]
    want, want_dx = jax_vertex_halo.sharded_update_positions_multiscale(
        *args, jax_make_mesh((1, shards), ("data", "graph")), iter_nums=ITERS)
    np.testing.assert_allclose(got[0], want, atol=1e-4)
    for a, b in zip(got[1], want_dx):
        np.testing.assert_allclose(a, b, atol=1e-4)


def _padded_solver_inputs(patch, shards):
    f_pad = (-patch.faces.shape[0]) % (shards * 16)
    faces = np.concatenate([patch.faces, np.full((f_pad, 3), -1, patch.faces.dtype)])
    v_pad = (-patch.vertices.shape[0]) % shards
    v_faces = np.concatenate([patch.v_faces,
                              np.full((v_pad, patch.v_faces.shape[1]), -1, patch.v_faces.dtype)])
    return faces, v_faces, patch.vertices.shape[0] + v_pad, [faces.shape[0] // 4 ** s
                                                             for s in range(3)]


@pytest.mark.parametrize("shards", [2, 4])
def test_solver_operands_equal_jax(patch, shards):
    """Both solvers' host operands, array for array."""
    faces, v_faces, v, counts = _padded_solver_inputs(patch, shards)
    got = vertex_halo.prepare_multiscale_solver(counts, faces, v_faces, v, shards)
    want = jax_vertex_halo.prepare_multiscale_solver(counts, faces, v_faces, v, shards)
    pairs = [(got.fv, want.fv_local, want.fv_send, want.fv_recv, want.fv_offsets)]
    pairs += list(zip(got.vf, want.vf_locals, want.vf_sends, want.vf_recvs, want.vf_offsets))
    np.testing.assert_array_equal(got.lmbd.reshape(shards, -1, 1), np.asarray(want.lmbd))
    got_op = vertex_halo.prepare_multiscale_solver_operator(counts, faces, v_faces, v, shards)
    want_op = jax_vertex_halo.prepare_multiscale_solver_operator(counts, faces, v_faces, v,
                                                                  shards)
    pairs += list(zip(got_op.vfu, want_op.vfu_locals, want_op.vfu_sends, want_op.vfu_recvs,
                      want_op.vfu_offsets))
    pairs += list(zip(got_op.fc, want_op.fc_locals, want_op.fc_sends, want_op.fc_recvs,
                      want_op.fc_offsets))
    for part, local, send, recv, offsets in pairs:
        assert part.offsets == offsets
        np.testing.assert_array_equal(part.local_idx, np.asarray(local))
        np.testing.assert_array_equal(part.send_idx, np.asarray(send))
        np.testing.assert_array_equal(part.recv_mask, np.asarray(recv))
    for a, b in zip(got_op.vfu_mults, want_op.vfu_mults):
        np.testing.assert_array_equal(a.reshape(shards, -1, a.shape[1]), np.asarray(b))
    for a, b in zip(got_op.fc_weights, want_op.fc_weights):
        np.testing.assert_array_equal(a.reshape(shards, -1, a.shape[1]), np.asarray(b))


@pytest.fixture(scope="module")
def vertex_mesh():
    v, f = make_icosphere(2)
    noisy = (v + np.random.default_rng(3).normal(scale=0.02, size=v.shape)).astype(np.float32)
    m = InferenceMesh(max_patch_size=10**9, coarsening_steps=2, coarsening_levels=3,
                      k_faces=23, seed=0)
    m.add_mesh_with_vertices(noisy, f)
    return m


@pytest.mark.parametrize("shards", [1, 2, 4])
def test_infer_with_vertices_sharded_matches_jax(vertex_mesh, shards, tmp_path):
    schedule = {"ms_solver_iterations": (8, 4, 4)}
    cfg = default_config().replace(model=WIDTHS, eval=schedule)
    jcfg = jax_default_config().replace(model=WIDTHS, eval=schedule)
    params = jax.tree.map(np.asarray, jax_init_unet(jax.random.PRNGKey(0), in_channels=6,
                                                    multi_scale=True, **WIDTHS))
    if shards == 1:
        got = infer_with_vertices_sharded(vertex_mesh, cfg, params_from_jax(params, "cpu"),
                                          group=CPU)
    else:
        out = run_ranks("infer_vertices", shards,
                        {"mesh": vertex_mesh, "cfg": cfg, "params": params}, str(tmp_path))
        for other in out[1:]:
            for key in out[0]:
                np.testing.assert_array_equal(other[key], out[0][key])
        got = out[0]
    want = jax_infer_with_vertices_sharded(
        vertex_mesh, jcfg, params, device_mesh=jax_make_mesh((1, shards), ("data", "graph")))
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].shape == want[key].shape, key
        np.testing.assert_allclose(got[key], want[key], atol=2e-4, err_msg=key)


def test_train_with_vertices_sharded_driver(tmp_path):
    """``train_with_vertices_sharded(device="cpu")`` at D = 2, operator
    solver, schedule (4, 2, 2), 64 chamfer samples."""
    v, f = make_icosphere(2)
    rng = np.random.default_rng(3)
    ds = JaxTrainingSet(max_patch_size=10**9, coarsening_steps=2, coarsening_levels=3,
                        k_faces=23, seed=0)
    for noise in (0.02, 0.01):
        ds.add_mesh_with_vertices((v + rng.normal(scale=noise, size=v.shape)).astype(np.float32),
                                  f, gt_vertices=v)
    cfg = default_config().replace(
        model=WIDTHS, eval={"ms_solver_iterations": (4, 2, 2)},
        train={"chamfer_samples": 64, "save_every": 4, "valid_every": 4,
               "network_path": str(tmp_path / "net"), "net_name": "vshard"})
    runs = [{"num_iterations": 6, "checkpoint": True, "log_every": 3, "validate": True},
            {"num_iterations": 2, "checkpoint": True, "log_every": 1},
            {"num_iterations": 3, "checkpoint": True, "log_every": 1, "nan_inputs": True,
             "cfg": {"train": {"network_path": str(tmp_path / "nan")}}}]
    out = run_ranks("vertex_driver", 2, {"cfg": cfg, "patch": ds.patches[0],
                                         "valid": ds.patches[1], "runs": runs},
                    str(tmp_path / "ranks"))
    first, resumed, nan = out[0]
    assert first["step"] == 6 and resumed["step"] == 8
    assert np.isfinite(first["losses"]).all() and first["losses"].shape == (6,)
    np.testing.assert_array_equal(out[1][0]["losses"], first["losses"])
    assert sorted(os.listdir(tmp_path / "net" / "vshard")) == [
        "params.pt", "step_4.pt", "step_6.pt", "step_8.pt"]
    hist = np.loadtxt(tmp_path / "net" / "vshard.csv", delimiter=",")
    assert hist.shape == (2 + 2, 2)                   # rank 0's rows only
    assert np.isfinite(hist[:2]).all() and np.isnan(hist[2:, 1]).all()
    assert nan["losses"].shape == (1,) and not np.isfinite(nan["losses"][0])
    assert not [f for f in os.listdir(tmp_path / "nan" / "vshard") if f.startswith("step_")]
