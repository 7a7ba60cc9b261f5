"""The port's sharded serving path and launcher against the JAX package's,
on the CPU: the vertex-partitioned edge solver
(``parallel/vertex_halo.py::sharded_update_positions_edges``),
``inference/sharded.py::infer_normals_sharded`` and
``python -m facet_graph_convolution_torch.parallel.launch``.

The port's ranks are gloo processes (``tests/torch_halo_ranks.py``); the
JAX side runs on the suite's virtual CPU devices. One noisy
``icosphere(3)`` whole-mesh ``InferenceMesh`` (the port's; the JAX
functions read its arrays); channels 8/16/32, M = 4, fc 32; 10 solver
iterations. Tolerance 1e-4 (JAX's
``test_sharded_whole_mesh_inference_matches_patched``).
"""

import json
import os
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from facet_graph_convolution_tpu.config import default_config as jax_default_config
from facet_graph_convolution_tpu.inference.sharded import (
    infer_normals_sharded as jax_infer_normals_sharded,
)
from facet_graph_convolution_tpu.models.unet import init_unet as jax_init_unet
from facet_graph_convolution_tpu.parallel import halo as jax_halo
from facet_graph_convolution_tpu.parallel.mesh import make_mesh as jax_make_mesh
from facet_graph_convolution_tpu.parallel.vertex_halo import (
    sharded_update_positions_edges as jax_sharded_solver,
)
from facet_graph_convolution_torch.config import default_config
from facet_graph_convolution_torch.data.dataset import InferenceMesh
from facet_graph_convolution_torch.inference.driver import infer_normals
from facet_graph_convolution_torch.inference.sharded import infer_normals_sharded
from facet_graph_convolution_torch.ops.vertex_update import update_positions_edges
from facet_graph_convolution_torch.params import params_from_jax
from facet_graph_convolution_torch.parallel.mesh import GraphGroup
from facet_graph_convolution_torch.parallel.vertex_halo import sharded_update_positions_edges
from tests.conftest import make_icosphere
from tests.torch_halo_ranks import REPO, run_ranks

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")

WIDTHS = {"channels": (8, 16, 32), "num_filters": 4, "fc_channels": 32}
CPU = GraphGroup(0, 1, torch.device("cpu"))
SOLVERS = [{}, {"lmbd": "degree", "adaptive_tol": 1e-3}, {"trust": 2.0}]


@pytest.fixture(scope="module")
def mesh():
    v, f = make_icosphere(3)
    noisy = (v + np.random.default_rng(3).normal(scale=0.02, size=v.shape)).astype(np.float32)
    m = InferenceMesh(max_patch_size=10**9, coarsening_steps=2, coarsening_levels=3,
                      k_faces=23, seed=0)
    m.add_mesh(noisy, f)
    return m


@pytest.fixture(scope="module")
def params():
    p = jax_init_unet(jax.random.PRNGKey(0), in_channels=6, **WIDTHS)
    return jax.tree.map(np.asarray, p)


def _normals(mesh):
    rng = np.random.default_rng(5)
    n = rng.normal(size=(mesh.faces.shape[0], 3)).astype(np.float32)
    return n / np.linalg.norm(n, axis=1, keepdims=True)


def _solver_args(mesh):
    return (mesh.vertices, _normals(mesh), mesh.edge_map, mesh.v_e_map)


@pytest.mark.parametrize("shards", [1, 2, 4])
def test_sharded_solver_matches_jax(mesh, shards, tmp_path):
    """Three solver settings (reference λ; per-vertex λ with the adaptive
    stop; the trust cap) against JAX's sharded solver on as many devices,
    and at D = 1 against the port's single-device solver."""
    args = _solver_args(mesh)
    kwargs = [dict(kw, iter_num=10) for kw in SOLVERS]
    if shards == 1:
        got = [sharded_update_positions_edges(*args, group=CPU, **kw) for kw in kwargs]
        for kw, out in zip(kwargs, got):
            ref, _ = update_positions_edges(*(torch.as_tensor(a) for a in args), **kw)
            np.testing.assert_allclose(out, ref.numpy(), atol=1e-4)
    else:
        out = run_ranks("solver", shards, {"args": args, "kwargs": kwargs}, str(tmp_path))
        for other in out[1:]:
            np.testing.assert_array_equal(other, out[0])
        got = out[0]
    dev_mesh = jax_make_mesh((1, shards), ("data", "graph"))
    for kw, out in zip(kwargs, got):
        want = jax_sharded_solver(*args, dev_mesh, **kw)
        np.testing.assert_allclose(out, want, atol=1e-4)


def _cfgs():
    return (default_config().replace(model=WIDTHS, eval={"solver_iterations": 10}),
            jax_default_config().replace(model=WIDTHS, eval={"solver_iterations": 10}))


@pytest.mark.parametrize("shards", [1, 2, 4])
def test_infer_normals_sharded_matches_jax(mesh, params, shards, monkeypatch, tmp_path):
    """The whole mesh served at once: normals and vertices against JAX's
    ``infer_normals_sharded`` on as many devices, and at D = 1 against the
    port's ``infer_normals`` of the same one-patch mesh."""
    monkeypatch.setattr(jax_halo, "WINDOWED_MIN_NODES", 10**9)
    cfg, jcfg = _cfgs()
    if shards == 1:
        pts, normals = infer_normals_sharded(mesh, cfg, params_from_jax(params, "cpu"),
                                             group=CPU, solver_iterations=10)
        ref_pts, ref_normals = infer_normals(mesh, cfg, params_from_jax(params, "cpu"),
                                             solver_iterations=10, device="cpu")
        np.testing.assert_allclose(normals, ref_normals, atol=1e-4)
        np.testing.assert_allclose(pts, ref_pts, atol=1e-4)
    else:
        out = run_ranks("infer", shards, {"mesh": mesh, "cfg": cfg, "params": params,
                                          "iterations": 10}, str(tmp_path))
        for other in out[1:]:
            np.testing.assert_array_equal(other[1], out[0][1])
        pts, normals = out[0]
    want_pts, want_normals = jax_infer_normals_sharded(
        mesh, jcfg, params, device_mesh=jax_make_mesh((1, shards), ("data", "graph")),
        solver_iterations=10)
    np.testing.assert_allclose(normals, want_normals, atol=1e-4)
    np.testing.assert_allclose(pts, want_pts, atol=1e-4)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_launcher_two_processes():
    """The launcher's ``train`` in two CPU processes joined through
    ``--coordinator``: both exit 0 and report the same losses (the ranks
    stay in lockstep), and training makes progress."""
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="2", PYTHONPATH=REPO)
    procs = [subprocess.Popen(
        [sys.executable, "-m", "facet_graph_convolution_torch.parallel.launch",
         "--coordinator", f"127.0.0.1:{port}", "--num_processes", "2", "--process_id", str(r),
         "--device", "cpu", "train", "--iterations", "12", "--subdiv", "3"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        assert p.returncode == 0, err[-2000:]
        outs.append(json.loads([ln for ln in out.splitlines() if ln.startswith("{")][-1]))
    assert [o["process"] for o in outs] == [0, 1]
    assert outs[0]["first_loss"] == outs[1]["first_loss"]
    assert outs[0]["value"] == outs[1]["value"]
    assert outs[0]["value"] < outs[0]["first_loss"]
