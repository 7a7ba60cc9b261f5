"""The port's sharded end-to-end vertex training
(``parallel/vertex_train.py``) against the JAX package's, on the CPU.

The port's ranks are gloo processes (``tests/torch_halo_ranks.py``); the
JAX side runs on the suite's virtual CPU devices. One noisy
``icosphere(2)`` patch built with vertices; channels 8/16/32, M = 4, fc
32; solver schedule (8, 4, 4); 64 chamfer samples a side. Both solver
bodies (``cfg.eval.vertex_solver``: ``"operator"``, ``"naive"``) at D = 1,
2 and 4, each from the same parameters, on JAX's draws: the sample indices
given to both, and the rotation JAX's step draws from its key
(``random_rotation(split(key)[0])``) given to the port.

JAX's gradients come from its step run with ``optax.sgd(1.0)`` (the update
is −g). JAX's sharded vertex gradient is D times the gradient of its loss:
every device computes the whole loss, inside ``shard_map`` the gradient of
a replicated parameter is summed over the devices, and the step's
``pmean`` returns that sum (Adam's update hides the scale). The port's is
the loss's gradient at every D, so it is held to JAX's divided by D; at D =
1 the two are the same function (ROADMAP queue 3).

Tolerances: the first step's loss and the eval loss rtol 1e-4; the
gradients within 3e-4 of each gradient's largest magnitude (the chamfer's
×1000 puts them at ~10², the backward runs through 16 solver iterations
and 8 convs summed in another order); the parameters after the port's
Adam step atol 3e-4 against optax's first Adam update of JAX's gradients
where |g| > 1e-6 (``tests/test_torch_halo.py``'s bar; below it float32
noise in g sets Adam's update, and both stay within lr of the start);
every rank the same bits.
The driver, ``train_with_vertices_sharded``, is tested in
tests/test_torch_sharded_vertex.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from facet_graph_convolution_tpu.config import default_config as jax_default_config
from facet_graph_convolution_tpu.data.dataset import TrainingSet as JaxTrainingSet
from facet_graph_convolution_tpu.models.augment import random_rotation as jax_random_rotation
from facet_graph_convolution_tpu.models.unet import init_unet as jax_init_unet
from facet_graph_convolution_tpu.parallel.mesh import make_mesh as jax_make_mesh
from facet_graph_convolution_tpu.parallel.vertex_train import (
    make_sharded_vertex_train_step as jax_make_sharded_vertex_train_step,
)
from facet_graph_convolution_tpu.parallel.vertex_train import (
    prepare_vertex_training as jax_prepare_vertex_training,
)
from facet_graph_convolution_tpu.training.trainer import TrainState as JaxTrainState
from facet_graph_convolution_torch.config import default_config
from facet_graph_convolution_torch.parallel.mesh import GraphGroup
from tests.conftest import make_icosphere
from tests.torch_halo_ranks import job_vertex_train, run_ranks

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")

WIDTHS = {"channels": (8, 16, 32), "num_filters": 4, "fc_channels": 32}
CPU = GraphGroup(0, 1, torch.device("cpu"))
SAMPLES = 64


@pytest.fixture(scope="module")
def vertex_set():
    v, f = make_icosphere(2)
    rng = np.random.default_rng(3)
    ds = JaxTrainingSet(max_patch_size=10**9, coarsening_steps=2, coarsening_levels=3,
                        k_faces=23, seed=0)
    for noise in (0.02, 0.01):
        noisy = (v + rng.normal(scale=noise, size=v.shape)).astype(np.float32)
        ds.add_mesh_with_vertices(noisy, f, gt_vertices=v)
    return ds.patches


@pytest.fixture(scope="module")
def params():
    p = jax_init_unet(jax.random.PRNGKey(0), in_channels=6, multi_scale=True, **WIDTHS)
    return jax.tree.map(np.asarray, p)


def _cfgs(solver, **train):
    ev = {"ms_solver_iterations": (8, 4, 4), "vertex_solver": solver}
    tr = {"chamfer_samples": SAMPLES, **train}
    return (default_config().replace(model=WIDTHS, eval=ev, train=tr),
            jax_default_config().replace(model=WIDTHS, eval=ev, train=tr))


def _jax_step(jcfg, params, patch, shards, idx0, idx1, key):
    """JAX's sharded step with SGD at rate 1: its loss, its gradients (the
    parameters' change, negated) and its eval loss of ``params``."""
    mesh = jax_make_mesh((1, shards), ("data", "graph"))
    arrays, part, ops = jax_prepare_vertex_training(patch, jcfg, shards)
    tx = optax.sgd(1.0)
    p0 = jax.tree.map(jnp.asarray, params)
    step = jax_make_sharded_vertex_train_step(tx, jcfg, part, ops, mesh)
    with mesh:
        state, loss = step(JaxTrainState(p0, tx.init(p0), 0), arrays, jnp.asarray(idx0),
                           jnp.asarray(idx1), key)
        evaluated = step.eval(p0, arrays, jnp.asarray(idx0), jnp.asarray(idx1))
    grads = jax.tree.map(lambda a, b: np.asarray(a) - np.asarray(b), p0, state.params)
    return float(loss), grads, float(evaluated)


def _assert_adam_step(got, params, grads, lr=1e-3, eps=1e-8):
    """The parameters after one Adam step against optax's first update of
    ``grads`` (its bias-corrected moments are g and g²: p − lr·g/(|g| +
    eps)), atol 3e-4, where |g| > 1e-6; below, the update is set by float32
    noise in g, and both lie within lr of the start."""
    for layer, leaves in grads.items():
        for name, g in leaves.items():
            p0, p1 = params[layer][name], got[layer][name]
            want = p0 - lr * g / (np.abs(g) + eps)
            live = np.abs(g) > 1e-6
            np.testing.assert_allclose(p1[live], want[live], atol=3e-4,
                                       err_msg=f"{layer}.{name}")
            assert np.abs(p1 - p0).max() <= lr * (1 + 1e-3), (layer, name)


@pytest.mark.parametrize("shards", [1, 2, 4])
@pytest.mark.parametrize("solver", ["operator", "naive"])
def test_sharded_vertex_step_matches_jax(vertex_set, params, solver, shards, tmp_path):
    patch = vertex_set[0]
    cfg, jcfg = _cfgs(solver)
    rng = np.random.default_rng(11)
    idx0 = rng.integers(0, patch.vertices.shape[0], SAMPLES)
    idx1 = rng.integers(0, patch.gt_vertices.shape[0], SAMPLES)
    key = jax.random.PRNGKey(5)
    rot = np.asarray(jax_random_rotation(jax.random.split(key)[0]))
    payload = {"patch": patch, "cfgs": {solver: cfg}, "params": params, "idx0": idx0,
               "idx1": idx1, "rot": rot}
    out = ([job_vertex_train(payload, CPU)] if shards == 1
           else run_ranks("vertex_train", shards, payload, str(tmp_path)))
    got = out[0][solver]
    for other in out[1:]:
        assert other[solver]["loss"] == got["loss"]
        for layer in got["params"]:
            for name in got["params"][layer]:
                np.testing.assert_array_equal(other[solver]["params"][layer][name],
                                              got["params"][layer][name])
    want_loss, want_grads, want_eval = _jax_step(jcfg, params, patch, shards, idx0, idx1, key)
    want_grads = jax.tree.map(lambda g: g / shards, want_grads)
    np.testing.assert_allclose(got["loss"], want_loss, rtol=1e-4)
    np.testing.assert_allclose(got["eval"], want_eval, rtol=1e-4)
    for layer in want_grads:
        for name, g in want_grads[layer].items():
            err = np.abs(got["grads"][layer][name] - g).max()
            assert err <= 3e-4 * max(np.abs(g).max(), 1e-6), (layer, name, err)
    _assert_adam_step(got["params"], params, want_grads)
