"""The port's multi-mesh sharded training (``parallel/halo.py::
prepare_sharded_mesh_bank`` and ``train_normals_sharded_multi``) against the
JAX package's, on the CPU.

Three whole-mesh patches, two of one topology (``icosphere(3)`` at two
noise draws) and a torus 40 × 16, noise 0.2 of the mean edge length
(``tests/test_large_mesh.py``'s ``_patchset``); channels 8/16/32, M = 4,
fc 32; 512 loss faces. JAX's windowed convs stay off
(``WINDOWED_MIN_NODES`` raised; the port has none).

- The bank at D = 2 and 4: every mesh's partition equal to JAX's array for
  array after the geometry merge, each rank's input and GT blocks, and
  every mesh's tables of one shape (the port's form of JAX's one compiled
  step for every mesh).
- A step on each mesh at D = 2 (gloo ranks, ``tests/torch_halo_ranks.py``)
  from the same parameters, rotation and loss mask against JAX's step
  (``step.raw`` with the mesh's operands, ``optax.sgd(1.0)``: the update
  is −g): loss rtol 1e-4, gradients within 3e-4 × max(1, the gradient's
  largest magnitude) (``tests/test_torch_halo.py``'s bars, relative where
  the gradients reach ~10²).
- ``train_normals_sharded_multi(device="cpu")`` at D = 2 for 60 steps
  (JAX's ``test_multi_mesh_sharded_training_single_compile``): finite
  losses, the last 20 below the first 20 on average, the ranks in
  lockstep, checkpoints and the CSV.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from facet_graph_convolution_tpu.config import default_config as jax_default_config
from facet_graph_convolution_tpu.data.dataset import TrainingSet as JaxTrainingSet
from facet_graph_convolution_tpu.data.synthetic import add_vertex_noise, torus
from facet_graph_convolution_tpu.models.augment import random_rotation as jax_random_rotation
from facet_graph_convolution_tpu.models.unet import init_unet as jax_init_unet
from facet_graph_convolution_tpu.parallel import halo as jax_halo
from facet_graph_convolution_tpu.parallel.mesh import make_mesh as jax_make_mesh
from facet_graph_convolution_tpu.training.trainer import TrainState as JaxTrainState
from facet_graph_convolution_torch.config import default_config
from facet_graph_convolution_torch.parallel import halo
from facet_graph_convolution_torch.parallel.mesh import GraphGroup
from tests.conftest import make_icosphere
from tests.torch_halo_ranks import run_ranks

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")

WIDTHS = {"channels": (8, 16, 32), "num_filters": 4, "fc_channels": 32}


@pytest.fixture(scope="module")
def patches():
    rng = np.random.default_rng(0)
    ds = JaxTrainingSet(max_patch_size=10**9, coarsening_steps=2, coarsening_levels=3,
                        k_faces=23, seed=0)
    v, f = make_icosphere(3)
    for shape in ((v, f), (v, f), torus(nu=40, nv=16)):
        ds.add_mesh(add_vertex_noise(*shape, 0.2, rng), shape[1], gt_vertices=shape[0])
    return ds.patches


@pytest.fixture
def no_windows(monkeypatch):
    monkeypatch.setattr(jax_halo, "WINDOWED_MIN_NODES", 10**9)


def _cfgs(**train):
    tr = {"loss_samples": 512, **train}
    return (default_config().replace(model=WIDTHS, train=tr),
            jax_default_config().replace(model=WIDTHS, train=tr))


@pytest.mark.parametrize("shards", [2, 4])
def test_mesh_bank_equals_jax(patches, shards, no_windows):
    cfg, jcfg = _cfgs()
    mesh = jax_make_mesh((1, shards), ("data", "graph"))
    jparts, jxs, jgts, jn, _ = jax_halo.prepare_sharded_mesh_bank(jcfg, patches, mesh)
    shapes = None
    for rank in range(shards):
        group = GraphGroup(rank, shards, torch.device("cpu"))
        parts, xs, gts, n = halo.prepare_sharded_mesh_bank(cfg, patches, group)
        assert n == jn
        for m, (a, b) in enumerate(zip(parts, jparts)):
            for la, lb in zip(a.levels, b.levels):
                assert (la.offsets, la.halo_size, la.cross_halo) == (
                    lb.offsets, lb.halo_size, lb.cross_halo), m
                for name in ("local_adj", "local_adj_t", "lane_adj", "lane_adj_t", "send_idx",
                             "recv_mask", "mult", "self_mult", "cross_send", "cross_mask"):
                    x, y = getattr(la, name), getattr(lb, name)
                    if y is None:
                        assert x is None, name
                    else:
                        np.testing.assert_array_equal(x, y, err_msg=f"mesh {m} {name}")
            block = n // shards
            np.testing.assert_array_equal(xs[m].numpy(),
                                          np.asarray(jxs[m])[rank * block:(rank + 1) * block])
            np.testing.assert_array_equal(gts[m].numpy(),
                                          np.asarray(jgts[m])[rank * block:(rank + 1) * block])
            got = halo.table_shapes(halo.partition_operands(a, rank, "cpu"))
            shapes = shapes or got
            assert got == shapes, (rank, m)


def test_multi_mesh_steps_match_jax(patches, no_windows, tmp_path):
    shards = 2
    cfg, jcfg = _cfgs(network_path=str(tmp_path / "net"), net_name="multinet", save_every=30)
    params = jax.tree.map(np.asarray, jax_init_unet(jax.random.PRNGKey(0), in_channels=6,
                                                    **WIDTHS))
    key = jax.random.PRNGKey(4)
    rng = np.random.default_rng(7)
    mesh = jax_make_mesh((1, shards), ("data", "graph"))
    jparts, jxs, jgts, n, stage = jax_halo.prepare_sharded_mesh_bank(jcfg, patches, mesh)
    masks = []
    for _ in patches:
        mask = np.zeros(n, np.float32)
        mask[rng.integers(0, n, 512)] = 1.0
        masks.append(mask)
    runs = [{"num_iterations": 60, "log_every": 20, "checkpoint": True}]
    out = run_ranks("multi", shards, {"cfg": cfg, "patches": patches, "params": params,
                                      "rot": np.asarray(jax_random_rotation(key)),
                                      "masks": masks, "runs": runs}, str(tmp_path / "ranks"))
    for other in out[1:]:
        np.testing.assert_array_equal(other["runs"][0]["losses"], out[0]["runs"][0]["losses"])
    got = out[0]
    assert got["nodes"] == n
    tx = optax.sgd(1.0)
    p0 = jax.tree.map(jnp.asarray, params)
    step = jax_halo.make_sharded_train_step(tx, jcfg, jparts[0], mesh)
    for m, part in enumerate(jparts):
        ops = jax_halo.make_sharded_train_step(tx, jcfg, part, mesh).operands
        with mesh:
            state, loss = step.raw(JaxTrainState(p0, tx.init(p0), 0), jxs[m], jgts[m],
                                   stage(masks[m]), key, ops)
        np.testing.assert_allclose(got["steps"][m]["loss"], float(loss), rtol=1e-4)
        for layer in params:
            for name in params[layer]:
                g = np.asarray(p0[layer][name]) - np.asarray(state.params[layer][name])
                err = np.abs(got["steps"][m]["grads"][layer][name] - g).max()
                assert err <= 3e-4 * max(np.abs(g).max(), 1.0), (m, layer, name, err)
        assert got["steps"][m]["shapes"] == got["steps"][0]["shapes"]
    run = got["runs"][0]
    assert run["step"] == 60 and np.isfinite(run["losses"]).all()
    assert np.mean(run["losses"][-20:]) < np.mean(run["losses"][:20])
    assert sorted(os.listdir(tmp_path / "net" / "multinet")) == ["params.pt", "step_30.pt",
                                                                 "step_60.pt"]
    assert np.loadtxt(tmp_path / "net" / "multinet.csv", delimiter=",").shape == (3, 2)
