"""The port's inference path against the JAX package's ``infer_normals``,
and the guards of the port (no JAX, no quiet CPU fallback).

One ``InferenceMesh`` built by the JAX host code (two overlapping patches)
and one set of parameters go to both ``infer_normals``. The JAX side runs its
default node-minor forward, the port its kernel configuration on the CPU
(the plain K1); both compute the same network.

Tolerances, float32: predicted normals atol 1e-4 (the forward's tolerance);
refined vertices atol 1e-5 × the mesh's bounding-box diagonal, under the
reference's fixed schedule and under the adaptive default, where both sides
must also stop at the same iteration.
"""

import ast
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facet_graph_convolution_tpu.config import default_config as jax_default_config
from facet_graph_convolution_tpu.data.dataset import InferenceMesh as JaxInferenceMesh
from facet_graph_convolution_tpu.inference.driver import infer_normals as jax_infer_normals
from facet_graph_convolution_tpu.models.unet import init_unet as jax_init_unet
from facet_graph_convolution_tpu.ops.vertex_update import (
    update_positions_edges as jax_update_positions_edges,
)
from facet_graph_convolution_torch import params as params_io
from facet_graph_convolution_torch.cli import infer as cli_infer
from facet_graph_convolution_torch.config import default_config
from facet_graph_convolution_torch.data.synthetic import add_vertex_noise, icosphere
from facet_graph_convolution_torch.geometry.obj_io import load_obj, write_obj
from facet_graph_convolution_torch.inference.driver import infer_normals, solve_vertices
from facet_graph_convolution_torch.models.unet import init_unet
from facet_graph_convolution_torch.ops.vertex_update import update_positions_edges

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(channels=(8, 16, 32), num_filters=4, fc_channels=32)
REFERENCE_SOLVER = dict(solver_lambda="reference", solver_adaptive_tol=0.0, solver_trust=0.0)


@pytest.fixture(scope="module")
def case():
    v, f = icosphere(3)
    noisy = add_vertex_noise(v, f, 0.3, np.random.default_rng(5))
    mesh = JaxInferenceMesh(max_patch_size=700, min_patch_size=800, coarsening_steps=2,
                            coarsening_levels=3, k_faces=23, seed=0)
    mesh.add_mesh(noisy, f)
    assert len(mesh.patches) == 2
    jparams = jax_init_unet(jax.random.PRNGKey(2), **SMALL)
    params = params_io.params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    scale = float(np.linalg.norm(noisy.max(axis=0) - noisy.min(axis=0)))
    return mesh, jparams, params, scale


def _cfgs(**eval_updates):
    model = {"channels": SMALL["channels"], "num_filters": 4, "fc_channels": 32}
    jcfg = jax_default_config().replace(model=model, eval=eval_updates)
    cfg = default_config().replace(model=model, eval=eval_updates)
    return jcfg, cfg


def test_infer_normals_reference_solver_matches_jax(case):
    mesh, jparams, params, scale = case
    jcfg, cfg = _cfgs(**REFERENCE_SOLVER)
    pts_j, n_j = jax_infer_normals(mesh, jcfg, params=jparams)
    pts, n = infer_normals(mesh, cfg, params=params, device="cpu")
    assert np.isfinite(pts).all()
    np.testing.assert_allclose(n, n_j, atol=1e-4)
    np.testing.assert_allclose(pts, pts_j, atol=1e-5 * scale)
    assert np.abs(pts - mesh.vertices).max() > 1e-3 * scale     # the solver moved


def test_infer_normals_adaptive_solver_matches_jax(case):
    """Defaults: degree step, plateau stop, trust cap. The JAX while_loop
    exposes no count, so its stop is located by rerunning its fixed schedule:
    JAX's adaptive result equals its fixed run of the port's count, and not
    one iteration more or fewer."""
    mesh, jparams, params, scale = case
    jcfg, cfg = _cfgs()
    pts_j, n_j = jax_infer_normals(mesh, jcfg, params=jparams)
    pts, n = infer_normals(mesh, cfg, params=params, device="cpu")
    np.testing.assert_allclose(n, n_j, atol=1e-4)
    np.testing.assert_allclose(pts, pts_j, atol=1e-5 * scale)

    _, iters = solve_vertices(mesh, cfg, n, torch.device("cpu"))
    assert 0 < iters < cfg.eval.solver_iterations

    def jax_fixed(count):
        return np.asarray(jax_update_positions_edges(
            jnp.asarray(mesh.vertices), jnp.asarray(n_j), jnp.asarray(mesh.edge_map),
            jnp.asarray(mesh.v_e_map), iter_num=count, lmbd="degree", checkpoint=False,
            trust=jcfg.eval.solver_trust))

    np.testing.assert_allclose(jax_fixed(iters), pts_j, atol=1e-6 * scale)
    for other in (iters - 1, iters + 1):
        assert np.abs(jax_fixed(other) - pts_j).max() > 1e-5 * scale


def test_adaptive_solver_refuses_grad():
    v, f = icosphere(1)
    from facet_graph_convolution_torch.geometry.mesh_math import compute_face_normals, edge_map

    e, ve = edge_map(f, max_edges=20)
    x = torch.as_tensor(v).requires_grad_()
    normals = torch.as_tensor(compute_face_normals(v, f))
    with pytest.raises(RuntimeError, match="inference-only"):
        update_positions_edges(x, normals, torch.as_tensor(e), torch.as_tensor(ve),
                               adaptive_tol=0.01)
    y, iters = update_positions_edges(x, normals, torch.as_tensor(e), torch.as_tensor(ve),
                                      iter_num=3)
    assert iters == 3 and y.requires_grad


def test_cli_infer_writes_denoised(tmp_path):
    v, f = icosphere(2)
    in_dir, net_dir, out_dir = tmp_path / "in", tmp_path / "nets", tmp_path / "out"
    in_dir.mkdir()
    write_obj(add_vertex_noise(v, f, 0.2, np.random.default_rng(0)), f,
              str(in_dir / "sphere_n2.obj"))
    params_io.save(init_unet(0, device="cpu", **SMALL),
                   params_io.checkpoint_path(str(net_dir), "net"))
    cli_infer.main(["--device", "cpu", "--input_dir", str(in_dir),
                    "--network_path", str(net_dir), "--results_path", str(out_dir)])
    out_v, out_f, _ = load_obj(str(out_dir / "sphere_n2_denoised.obj"))
    assert out_v.shape == v.shape and np.isfinite(out_v).all()
    np.testing.assert_array_equal(out_f.astype(np.int64), f.astype(np.int64))
    assert (out_dir / "sphere_n2_inferred_normals.obj").is_file()


def _imported_roots(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module.split(".")[0]


# the evaluation slice's modules, each of which the import check must reach
EVALUATION_MODULES = (
    "evaluation.metrics", "evaluation.driver", "evaluation.parity", "evaluation.tf_checkpoint",
    "cli.metrics", "cli.parity", "cli.wang", "geometry.filters", "utils.guards",
    "utils.profiling")


def test_port_imports_no_jax():
    """No import statement of the port or of chip_smoke.py names jax or the
    JAX package; and every module of the port, imported in a fresh
    interpreter, loads neither."""
    files = [os.path.join(REPO, "chip_smoke.py")] + [
        os.path.join(d, n) for d, _, names in os.walk(
            os.path.join(REPO, "facet_graph_convolution_torch")) for n in names
        if n.endswith(".py")]
    for path in files:
        bad = {"jax", "jaxlib", "facet_graph_convolution_tpu"} & set(_imported_roots(path))
        assert not bad, (path, bad)
    code = (
        "import importlib, pkgutil, sys\n"
        "import facet_graph_convolution_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = [k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib',"
        " 'facet_graph_convolution_tpu')]\n"
        "assert not bad, bad\n"
        f"missing = [m for m in {EVALUATION_MODULES!r} if p.__name__ + '.' + m not in sys.modules]\n"
        "assert not missing, missing\n"
        "print('clean', len([k for k in sys.modules if k.startswith(p.__name__)]))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("clean")


def test_entry_points_need_a_card_unless_cpu(case, monkeypatch, tmp_path):
    mesh, _, params, _ = case
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        infer_normals(mesh, default_config(), params=params)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli_infer.main(["--input_dir", str(tmp_path)])


def test_chip_smoke_fails_without_a_card():
    """chip_smoke.py exits non-zero and prints no result line on a machine
    without a card."""
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, capture_output=True,
                         text=True, timeout=300, env=env)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
