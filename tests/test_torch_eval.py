"""The port's evaluation (``evaluation/metrics.py``, ``evaluation/driver.py``,
``cli/metrics.py``), its NaN guards (``utils/guards.py``) and
two device helpers (``ops/vertex_update.py::update_positions_depth``,
``ops/normalization.py::face_normals_device``) against the JAX package's.

Tolerances: the metrics and ``compute_metrics`` are NumPy and SciPy in both
packages, so they agree bit for bit (the CSV and heatmap OBJ bytes too);
``update_positions_depth`` atol 1e-5 (20 float32 iterations, sums in
another order), ``face_normals_device`` atol 1e-6 (one cross product and a
normalization, float32).
"""

import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.io
import torch

from facet_graph_convolution_tpu.config import default_config as jax_default_config
from facet_graph_convolution_tpu.evaluation import metrics as jax_metrics
from facet_graph_convolution_tpu.evaluation.driver import compute_metrics as jax_compute_metrics
from facet_graph_convolution_tpu.ops.normalization import (
    face_normals_device as jax_face_normals_device,
)
from facet_graph_convolution_tpu.ops.vertex_update import (
    update_positions_depth as jax_update_positions_depth,
)
from facet_graph_convolution_tpu.utils import guards as jax_guards
from facet_graph_convolution_torch.cli import metrics as cli_metrics
from facet_graph_convolution_torch.config import default_config
from facet_graph_convolution_torch.data.synthetic import (
    add_vertex_noise,
    chamfered_box,
    icosphere,
)
from facet_graph_convolution_torch.evaluation import metrics
from facet_graph_convolution_torch.evaluation.driver import compute_metrics
from facet_graph_convolution_torch.geometry.mesh_math import compute_face_normals, edge_map
from facet_graph_convolution_torch.geometry.obj_io import write_obj
from facet_graph_convolution_torch.ops.normalization import face_normals_device
from facet_graph_convolution_torch.ops.vertex_update import update_positions_depth
from facet_graph_convolution_torch.utils import assert_finite_tree, has_nonfinite


@pytest.fixture(scope="module")
def noisy_sphere():
    v, f = icosphere(3)
    noisy = add_vertex_noise(v, f, 0.2, np.random.default_rng(0))
    return v, noisy, f


def test_angular_metrics_match_jax(noisy_sphere):
    v, noisy, f = noisy_sphere
    pred, gt = compute_face_normals(noisy, f), compute_face_normals(v, f)
    gt[::7] = 0.0                       # fake faces, left out of the stats
    np.testing.assert_array_equal(metrics.angular_error(pred, gt),
                                  jax_metrics.angular_error(pred, gt))
    assert metrics.angular_error_stats(pred, gt) == jax_metrics.angular_error_stats(pred, gt)


@pytest.mark.parametrize("accuracy_only", [False, True])
def test_hausdorff_matches_jax(noisy_sphere, accuracy_only):
    from facet_graph_convolution_torch.geometry.pointset import dense_point_cloud

    v, noisy, f = noisy_sphere
    assert metrics.one_sided_hausdorff(noisy, v) == jax_metrics.one_sided_hausdorff(noisy, v)
    d0, d1 = dense_point_cloud(noisy, f, res=2), dense_point_cloud(v, f, res=2)
    assert metrics.hausdorff_oversampled(noisy, v, d0, d1, accuracy_only) == (
        jax_metrics.hausdorff_oversampled(noisy, v, d0, d1, accuracy_only))


def _results_tree(root):
    """test/original GT meshes (one closed, one with borders) and their
    ``_n1`` / ``_n2`` denoised results."""
    rng = np.random.default_rng(1)
    gt_dir = root / "Data" / "Synthetic" / "test" / "original"
    results = root / "Results"
    gt_dir.mkdir(parents=True)
    results.mkdir()
    sphere = icosphere(2)
    v, f = chamfered_box(6)
    keep = f[:, 0] != 0                 # cut faces out: a mesh with borders
    shapes = {"sphere": sphere, "open_box": (v, f[keep])}
    for name, (v, f) in shapes.items():
        write_obj(v, f, str(gt_dir / f"{name}.obj"))
        for i, level in enumerate(("_n1", "_n2"), start=1):
            write_obj(add_vertex_noise(v, f, 0.1 * i, rng), f,
                      str(results / f"{name}{level}_denoised.obj"))


def test_compute_metrics_writes_the_jax_bytes(tmp_path):
    _results_tree(tmp_path / "a")
    shutil.copytree(tmp_path / "a", tmp_path / "b")
    runs = []
    for sub, run, config in (("a", jax_compute_metrics, jax_default_config),
                             ("b", compute_metrics, default_config)):
        base = str(tmp_path / sub) + "/"
        run(config(base).replace(eval={"results_path": base + "Results/"}))
        runs.append(tmp_path / sub / "Results")
    a, b = runs
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b))
    assert sum(n.endswith("_heatmap.obj") for n in names) == 4
    for name in names:
        if name.endswith(".mat"):
            ma, mb = scipy.io.loadmat(str(a / name)), scipy.io.loadmat(str(b / name))
            keys = sorted(k for k in ma if not k.startswith("__"))
            assert keys == sorted(k for k in mb if not k.startswith("__")) and len(keys) == 4
            for k in keys:
                np.testing.assert_array_equal(ma[k], mb[k])
        else:
            assert (a / name).read_bytes() == (b / name).read_bytes(), name
    rows = (b / "results_heat.csv").read_text().strip().splitlines()
    assert len(rows) == 4
    border_means = [float(r.split()[8]) for r in rows if r.startswith("open_box")]
    assert all(m > 0 for m in border_means)

    # a second run skips the results whose heatmaps exist
    compute_metrics(default_config(str(tmp_path / "b") + "/").replace(
        eval={"results_path": str(b) + "/"}))
    assert len((b / "results_heat.csv").read_text().strip().splitlines()) == 4


def test_cli_metrics(tmp_path):
    _results_tree(tmp_path)
    cli_metrics.main(["--base_path", str(tmp_path) + "/",
                      "--results_path", str(tmp_path / "Results")])
    rows = (tmp_path / "Results" / "results_heat.csv").read_text().strip().splitlines()
    assert [r.split()[0] for r in rows] == [
        "open_box_n1_denoised.obj", "open_box_n2_denoised.obj",
        "sphere_n1_denoised.obj", "sphere_n2_denoised.obj"]
    for r in rows:
        assert 0.0 < float(r.split()[3]) < 90.0


def test_update_positions_depth_matches_jax(noisy_sphere):
    v, noisy, f = noisy_sphere
    e_map, v_e_map = edge_map(f)
    fn = compute_face_normals(v, f)
    depth = np.asarray([0.3, -0.2, 0.9], np.float32)
    depth /= np.linalg.norm(depth)
    jx, jd = jax_update_positions_depth(jnp.asarray(noisy), jnp.asarray(fn), jnp.asarray(e_map),
                                        jnp.asarray(v_e_map), jnp.asarray(depth))
    x, d = update_positions_depth(torch.as_tensor(noisy), torch.as_tensor(fn),
                                  torch.as_tensor(e_map), torch.as_tensor(v_e_map),
                                  torch.as_tensor(depth))
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), atol=1e-5, rtol=0)
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), atol=1e-5, rtol=0)
    # the displacement lies along the depth direction
    np.testing.assert_allclose(np.cross(d.numpy(), depth), 0.0, atol=1e-6)
    assert float(np.abs(d.numpy()).max()) > 1e-4


def test_face_normals_device_matches_jax(noisy_sphere):
    _, noisy, f = noisy_sphere
    want = np.asarray(jax_face_normals_device(jnp.asarray(noisy), jnp.asarray(f)))
    got = face_normals_device(torch.as_tensor(noisy), torch.as_tensor(f))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("bad", [None, float("nan"), float("inf")])
def test_guards_match_jax(bad):
    tree = {"conv1": {"w": np.ones((3, 2), np.float32), "b": np.zeros(2, np.float32)},
            "steps": np.arange(3)}
    if bad is not None:
        tree["conv1"]["w"][1, 1] = bad
    ours = {"conv1": {k: torch.as_tensor(a) for k, a in tree["conv1"].items()},
            "steps": [torch.as_tensor(tree["steps"])]}
    want = bool(jax_guards.has_nonfinite(
        {"conv1": {k: jnp.asarray(a) for k, a in tree["conv1"].items()}}))
    assert bool(has_nonfinite(ours)) == want == (bad is not None)
    if bad is None:
        assert_finite_tree(ours)
    else:
        with pytest.raises(FloatingPointError, match="params"):
            assert_finite_tree(ours, "params")
    assert not bool(has_nonfinite({"ints": torch.arange(3)}))
