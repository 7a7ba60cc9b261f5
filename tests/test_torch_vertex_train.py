"""The port's vertex training against the JAX package, on the CPU: the
chamfer losses, the multi-scale solvers' gradients, one vertex train step
and its eval, the vertex ``.npz`` sets, ``train_with_vertices`` and the CLIs
``preprocess``/``train``/``infer --include_vertices``.

Small widths (channels 4/8/16, M = 2, fc 16), solver schedule (8, 4, 4), 32
chamfer samples, an icosphere(1) patch (80 faces padded to 96, 42 vertices)
as in tests/test_vertex_training.py; inputs from numpy seeds. The K1/K2
wrappers run their plain versions on CPU tensors. The JAX side runs its
vertex step as ``train_with_vertices`` builds it (``_graph_arrays`` lane
tables, no Pallas kernel on that path).

Tolerances: the chamfer losses' values rtol 1e-6 and gradients atol 1e-5 +
rtol 1e-6 (float32 sums in another order; the ×1000 makes the gradients
~10², where a float32 ulp is ~1e-5); the solvers' points atol 2e-5 + rtol 1e-4
(the bar of tests/test_torch_vertex.py) and their gradients atol 1e-4 on
each gradient scaled to max 1; a train step's loss rtol 1e-6 (it is ~300:
the chamfer ×1000), its gradients atol 1e-4 scaled to max 1 (the backward
through the solver's 16 iterations and 8 convs), and the parameters after
an Adam update fed the same gradients atol 1e-7, as
tests/test_torch_train.py holds the normals step.
"""

import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facet_graph_convolution_tpu.config import default_config as jax_default_config
from facet_graph_convolution_tpu.data.dataset import TrainingSet as JaxTrainingSet
from facet_graph_convolution_tpu.data.dataset import load_dataset as jax_load_dataset
from facet_graph_convolution_tpu.data.dataset import save_dataset as jax_save_dataset
from facet_graph_convolution_tpu.models import losses as jax_losses
from facet_graph_convolution_tpu.models.augment import random_rotation as jax_random_rotation
from facet_graph_convolution_tpu.ops.vertex_update import (
    build_solver_tables as jax_build_solver_tables,
)
from facet_graph_convolution_tpu.ops.vertex_update import (
    update_positions_multiscale as jax_update_positions_multiscale,
)
from facet_graph_convolution_tpu.ops.vertex_update import (
    update_positions_multiscale_operator as jax_update_positions_multiscale_operator,
)
from facet_graph_convolution_tpu.training.trainer import _graph_arrays, _solver_tables
from facet_graph_convolution_tpu.training.trainer import (
    create_train_state as jax_create_train_state,
)
from facet_graph_convolution_tpu.training.trainer import (
    make_vertex_train_step as jax_make_vertex_train_step,
)
from facet_graph_convolution_torch import params as params_io
from facet_graph_convolution_torch.cli import infer as cli_infer
from facet_graph_convolution_torch.cli import preprocess as cli_preprocess
from facet_graph_convolution_torch.cli import train as cli_train
from facet_graph_convolution_torch.config import default_config
from facet_graph_convolution_torch.data.dataset import TrainingSet, load_dataset, save_dataset
from facet_graph_convolution_torch.data.synthetic import add_vertex_noise, icosphere
from facet_graph_convolution_torch.geometry.obj_io import write_obj
from facet_graph_convolution_torch.inference.driver import MULTI_SCALE_HEADS
from facet_graph_convolution_torch.models import losses
from facet_graph_convolution_torch.ops.vertex_update import (
    build_solver_tables,
    update_positions_multiscale,
    update_positions_multiscale_operator,
)
from facet_graph_convolution_torch.training import trainer
from facet_graph_convolution_torch.training.checkpoint import CheckpointManager
from facet_graph_convolution_torch.training.trainer import (
    adam_update,
    create_train_state,
    make_vertex_train_step,
    train_with_vertices,
    vertex_loss,
    vertex_patch_tensors,
)
from tests.conftest import make_icosphere

MODEL = {"channels": (4, 8, 16), "num_filters": 2, "fc_channels": 16}
SCHEDULE = (8, 4, 4)
SAMPLES = 32
TRAIN = {"chamfer_samples": SAMPLES, "learning_rate": 1e-3, "seed": 0}
SOLVER_TOL = dict(atol=2e-5, rtol=1e-4)
GRAD_ATOL = 1e-4
PATCH_FIELDS = ("inputs", "num_real", "gt_normals", "patch_indices", "perm_inv", "vertices",
                "gt_vertices", "faces", "v_faces", "v_old_idx", "f_old_idx")
SEVEN_FILES = ("_denoised.obj", "_d_mid.obj", "_d_coarse.obj", "_fine_normals_s.obj",
               "_original_normals.obj", "_mid_normals_s.obj", "_coarse_normals_s.obj")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small tensors: one intra-op thread, so that parallel test workers do
    not oversubscribe the CPU."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _noisy_sphere(cls, seed=0):
    v, f = make_icosphere(1)      # 80 faces: the chamfer matrices stay tiny
    noisy = (v + np.random.default_rng(5).normal(scale=0.02, size=v.shape)).astype(np.float32)
    ds = cls(max_patch_size=20000, coarsening_steps=2, coarsening_levels=3, k_faces=23,
             seed=seed)
    ds.add_mesh_with_vertices(noisy, f, gt_vertices=v)
    return ds


@pytest.fixture(scope="module")
def vertex_patch():
    """One vertex patch with GT vertices and normals (JAX host code)."""
    patch = _noisy_sphere(JaxTrainingSet).patches[0]
    assert patch.gt_vertices is not None and patch.gt_normals is not None
    return patch


def _flat(tree):
    return [(f"{layer}.{name}", tree[layer][name])
            for layer in sorted(tree) for name in sorted(tree[layer])]


def _cfgs(solver="operator", rotation_invariance=False):
    kw = dict(model={**MODEL, "rotation_invariance": rotation_invariance}, train=TRAIN,
              eval={"ms_solver_iterations": SCHEDULE, "vertex_solver": solver})
    return jax_default_config().replace(**kw), default_config().replace(**kw)


# ---------------------------------------------------------------------------
# the chamfer losses
# ---------------------------------------------------------------------------

def _point_sets():
    """p0 [40, 3] and p1 [30, 3] spread over ±4 (some nearest distances past
    the accuracy threshold of 5), with p0[2] at the origin equidistant (0.5)
    from p1[7], p1[8] and p1[9], a tie of three minima, and p1[3] on p0[5]
    (a coincident pair, distance 0)."""
    rng = np.random.default_rng(11)
    p0 = rng.uniform(-4, 4, size=(40, 3)).astype(np.float32)
    p1 = rng.uniform(-4, 4, size=(30, 3)).astype(np.float32)
    p0[:, 0] += np.where(np.arange(40) % 2, 6.0, 0.0).astype(np.float32)   # far points
    p1 = p1 + np.sign(p1) * 1.0                                            # none near 0
    p0[2] = 0.0
    p1[7], p1[8], p1[9] = (0.5, 0, 0), (0, 0.5, 0), (0, 0, -0.5)
    p1[3] = p0[5]
    return p0, p1


class _TorchIdx:
    """The port's losses with the sample indices as tensors."""

    @staticmethod
    def full_chamfer_loss(a, b, i0, i1):
        return losses.full_chamfer_loss(a, b, torch.as_tensor(i0).long(),
                                        torch.as_tensor(i1).long())

    @staticmethod
    def accuracy_loss(a, b, i0):
        return losses.accuracy_loss(a, b, torch.as_tensor(i0).long())

    sampled_accuracy_loss = staticmethod(losses.sampled_accuracy_loss)


class _JaxIdx:
    @staticmethod
    def full_chamfer_loss(a, b, i0, i1):
        return jax_losses.full_chamfer_loss(a, b, jnp.asarray(i0), jnp.asarray(i1))

    @staticmethod
    def accuracy_loss(a, b, i0):
        return jax_losses.accuracy_loss(a, b, jnp.asarray(i0))

    sampled_accuracy_loss = staticmethod(jax_losses.sampled_accuracy_loss)


# each loss as fn(module, p0, p1), the module _TorchIdx or _JaxIdx above
_LOSSES = {
    "full_chamfer": lambda m, a, b: m.full_chamfer_loss(a, b, IDX0, IDX1),
    "accuracy": lambda m, a, b: m.accuracy_loss(a, b, IDX0),
    "sampled_accuracy": lambda m, a, b: m.sampled_accuracy_loss(a, b),
}
# samples with a repeat, the tied point and both ends of the coincident pair
IDX0 = np.array([2, 5, 0, 7, 2, 13, 38, 21], np.int32)
IDX1 = np.array([3, 7, 8, 9, 0, 29, 3], np.int32)


@pytest.mark.parametrize("name", sorted(_LOSSES))
def test_chamfer_losses_match_jax(name):
    """Values and gradients with respect to both point sets against JAX's;
    a tie of minima splits the gradient evenly (``torch.amin``), and a
    coincident pair gives a finite zero gradient (``sqrt(d² + 1e-20)``)."""
    fn = _LOSSES[name]
    p0, p1 = _point_sets()
    j_val, (j_g0, j_g1) = jax.value_and_grad(
        lambda a, b: fn(_JaxIdx, a, b), argnums=(0, 1))(jnp.asarray(p0), jnp.asarray(p1))
    t0, t1 = torch.tensor(p0, requires_grad=True), torch.tensor(p1, requires_grad=True)
    val = fn(_TorchIdx, t0, t1)
    val.backward()
    np.testing.assert_allclose(float(val.detach()), float(j_val), rtol=1e-6)
    for g, jg in ((t0.grad, j_g0), (t1.grad, j_g1)):
        assert torch.isfinite(g).all()
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), atol=1e-5, rtol=1e-6)
    if name == "sampled_accuracy":
        # p0[2]'s precision term is tied three ways: each minimum gets a third
        np.testing.assert_allclose(np.linalg.norm(t1.grad[7:10].numpy(), axis=1),
                                   np.linalg.norm(np.asarray(j_g1)[7:10], axis=1), rtol=1e-6)


def test_chamfer_minimum_splits_ties_and_survives_coincident_points():
    """The two traps of the port: the gradient of a tied minimum reaches
    every tied point in equal parts (``torch.min(dim)`` would give all of it
    to one), and a coincident pair has a zero, not NaN, gradient."""
    a = torch.zeros(1, 3, requires_grad=True)
    b = torch.tensor([[0.5, 0, 0], [0, 0.5, 0], [0, 0, 0.5]], requires_grad=True)
    losses.sampled_accuracy_loss(a, b).backward()
    # precision: 1/3 of 1000 to each tied point; completeness: 1000/3 each
    np.testing.assert_allclose(b.grad.norm(dim=1).numpy(), [1000 / 3 + 1000 / 3] * 3, rtol=1e-6)
    same = torch.ones(2, 3, requires_grad=True)
    losses.sampled_accuracy_loss(same, same.detach().clone()).backward()
    assert torch.equal(same.grad, torch.zeros_like(same))


def test_nan_distance_reaches_the_loss():
    """A NaN point gives a NaN loss in both packages: the threshold is
    written ``where(dist > thr, 0, dist)``, so a NaN distance is not mapped
    to 0 and the training loop's NaN abort fires."""
    p0, p1 = _point_sets()
    p0[2] = np.nan
    for name, fn in _LOSSES.items():
        ours = float(fn(_TorchIdx, torch.as_tensor(p0), torch.as_tensor(p1)))
        ref = float(fn(_JaxIdx, jnp.asarray(p0), jnp.asarray(p1)))
        assert math.isnan(ours) and math.isnan(ref), name


# ---------------------------------------------------------------------------
# the solvers under autograd
# ---------------------------------------------------------------------------

def _solver_case(patch):
    """The patch's vertices, three levels of random unit normals (the heads'
    shapes), a random cotangent for the solved points."""
    rng = np.random.default_rng(7)
    normals = []
    for n in (patch.num_nodes, patch.num_nodes // 4, patch.num_nodes // 16):
        nrm = rng.normal(size=(n, 3)).astype(np.float32)
        normals.append(nrm / np.linalg.norm(nrm, axis=1, keepdims=True))
    r = rng.normal(size=patch.vertices.shape).astype(np.float32)
    return patch.vertices, normals, r


def _port_solve(patch, solver, x, normals, checkpoint=False):
    args = (x, normals, torch.as_tensor(patch.faces), torch.as_tensor(patch.v_faces))
    kw = dict(coarsening_steps=2, iter_nums=SCHEDULE)
    if solver == "naive":
        return update_positions_multiscale(*args, **kw)[0]
    tables = build_solver_tables(patch.v_faces, [a.shape[0] for a in patch.adjs],
                                 patch.vertices.shape[0], 2, faces=patch.faces)
    return update_positions_multiscale_operator(*args, tables, checkpoint=checkpoint, **kw)[0]


@pytest.mark.parametrize("solver", ["operator", "naive"])
def test_solver_gradients_match_jax(vertex_patch, solver):
    """⟨solved points, r⟩'s gradients with respect to the start points and
    the three normal levels against jax.grad of the JAX solver
    (checkpoint=False; the operator form over face tables, as training
    builds them)."""
    x, normals, r = _solver_case(vertex_patch)
    p = vertex_patch
    faces, v_faces = jnp.asarray(p.faces), jnp.asarray(p.v_faces)

    def jsolve(xx, n0, n1, n2):
        kw = dict(coarsening_steps=2, iter_nums=SCHEDULE, checkpoint=False)
        if solver == "naive":
            out = jax_update_positions_multiscale(xx, [n0, n1, n2], faces, v_faces, **kw)[0]
        else:
            tables = jax_build_solver_tables(p.v_faces, [a.shape[0] for a in p.adjs],
                                             p.vertices.shape[0], 2, faces=p.faces)
            out = jax_update_positions_multiscale_operator(xx, [n0, n1, n2], faces, v_faces,
                                                           tables, **kw)[0]
        return jnp.sum(out * r), out

    (_, out_j), grads_j = jax.value_and_grad(jsolve, argnums=(0, 1, 2, 3), has_aux=True)(
        jnp.asarray(x), *map(jnp.asarray, normals))
    leaves = [torch.tensor(a, requires_grad=True) for a in (x, *normals)]
    out = _port_solve(p, solver, leaves[0], leaves[1:])
    grads = torch.autograd.grad((out * torch.as_tensor(r)).sum(), leaves)
    assert np.abs(out.detach().numpy() - x).max() > 1e-3              # the solver moved
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j), **SOLVER_TOL)
    for name, g, jg in zip(("x", "n0", "n1", "n2"), grads, grads_j):
        jg = np.asarray(jg)
        scale = max(float(np.abs(jg).max()), 1e-30)
        assert scale > 1e-3, name                                     # a gradient reached it
        np.testing.assert_allclose(g.numpy() / scale, jg / scale, atol=GRAD_ATOL, err_msg=name)


def test_operator_checkpoint_gives_the_same_gradients(vertex_patch):
    """checkpoint=True (cfg.eval.solver_remat) recomputes each iteration in
    the backward: the same values and gradients, bit for bit."""
    x, normals, r = _solver_case(vertex_patch)
    results = []
    for checkpoint in (False, True):
        leaves = [torch.tensor(a, requires_grad=True) for a in (x, *normals)]
        out = _port_solve(vertex_patch, "operator", leaves[0], leaves[1:], checkpoint)
        grads = torch.autograd.grad((out * torch.as_tensor(r)).sum(), leaves)
        results.append((out.detach(), grads))
    (out_a, g_a), (out_b, g_b) = results
    assert torch.equal(out_a, out_b)
    for a, b in zip(g_a, g_b):
        assert torch.equal(a, b)


def _graph_nodes(t):
    seen, stack, names = set(), [t.grad_fn], []
    while stack:
        node = stack.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        names.append(type(node).__name__)
        stack.extend(fn for fn, _ in node.next_functions)
    return names


def test_operator_backward_is_scatter_free(vertex_patch):
    """Every gather of the operator solver goes through its transpose map
    (the tables' adjT_t and fadjT_t): the autograd graph holds the
    scatter-free gather's nodes and no index_select, index_add or scatter
    backward."""
    x, normals, _ = _solver_case(vertex_patch)
    leaves = [torch.tensor(a, requires_grad=True) for a in (x, *normals)]
    names = _graph_nodes(_port_solve(vertex_patch, "operator", leaves[0], leaves[1:]))
    gathers = [n for n in names if n == "_GatherLaneBackward"]
    # per scale: the normals once, then x and t every iteration
    assert len(gathers) == sum(1 + 2 * i for i in SCHEDULE)
    assert not [n for n in names if "Index" in n or "Scatter" in n], sorted(set(names))


# ---------------------------------------------------------------------------
# one vertex train step and its eval against JAX
# ---------------------------------------------------------------------------

def _jax_args(jcfg, patch, solver):
    """The JAX step's arguments as train_with_vertices builds them."""
    adjs, adj_ts, mults = _graph_arrays(patch.adjs)
    return ((jnp.asarray(patch.inputs), adjs, jnp.asarray(patch.vertices),
             jnp.asarray(patch.gt_vertices), jnp.asarray(patch.faces),
             jnp.asarray(patch.v_faces), jnp.asarray(patch.gt_normals)),
            (adj_ts, mults, _solver_tables(jcfg, patch) if solver == "operator" else None))


def _jax_draws(key, patch):
    """The rotation and samples of the JAX step's key, drawn as
    trainer.py:868-874 draws them, as torch tensors."""
    rot_key, s0_key, s1_key = jax.random.split(key, 3)
    rot = jax_random_rotation(rot_key)
    idx0 = jax.random.randint(s0_key, (SAMPLES,), 0, patch.vertices.shape[0])
    idx1 = jax.random.randint(s1_key, (SAMPLES,), 0, patch.gt_vertices.shape[0])
    return tuple(torch.tensor(np.asarray(a)) for a in (rot, idx0, idx1))


# each solver with each variant, each pairing with both normals weights
STEP_CASES = [("operator", False, 0.0), ("operator", True, 0.5), ("naive", False, 0.5),
              ("naive", True, 0.0)]


@pytest.mark.parametrize("solver,rotation_invariance,normals_weight", STEP_CASES)
def test_vertex_train_step_matches_jax(vertex_patch, solver, rotation_invariance,
                                       normals_weight):
    """One step of JAX's make_vertex_train_step (key 7) against the port:
    the loss and the gradients of ``vertex_loss`` with the JAX key's
    rotation and samples injected, against jax.value_and_grad of the JAX
    step's ``eval`` (its ``_loss``); the port's own step with the same
    draws reports the same loss; and after the port's Adam is fed JAX's
    gradients, its parameters equal those of the JAX step."""
    jcfg, cfg = _cfgs(solver, rotation_invariance)
    jstate, tx = jax_create_train_state(jax.random.PRNGKey(0), jcfg, multi_scale=True)
    assert ("v" in jstate.params["conv1"]) != rotation_invariance
    jstep = jax_make_vertex_train_step(tx, jcfg, normals_weight=normals_weight)
    args, extra = _jax_args(jcfg, vertex_patch, solver)
    key = jax.random.PRNGKey(7)
    j_loss, j_grads = jax.value_and_grad(jstep.eval)(jstate.params, *args, key, *extra)
    j_next, j_step_loss = jstep(jstate, *args, key, *extra)
    assert float(j_step_loss) == pytest.approx(float(j_loss), rel=1e-6)

    params = params_io.params_from_jax(jax.tree.map(np.asarray, jstate.params), device="cpu")
    state = create_train_state(cfg, device="cpu", params=params, multi_scale=True)
    tensors = vertex_patch_tensors(cfg, vertex_patch, "cpu")
    assert (tensors.tables is None) == (solver == "naive")
    draws = _jax_draws(key, vertex_patch)
    leaves = [t for _, t in _flat(state.params)]
    loss = vertex_loss(state.params, cfg, tensors, *draws, normals_weight=normals_weight)
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss.detach()), float(j_loss), rtol=1e-6)
    for (name, jg), g in zip(_flat(jax.tree.map(np.asarray, j_grads)), grads, strict=True):
        scale = max(float(np.abs(jg).max()), 1e-30)
        np.testing.assert_allclose(g.numpy() / scale, jg / scale, atol=GRAD_ATOL, err_msg=name)

    probe = create_train_state(cfg, device="cpu", params=state.params, multi_scale=True)
    probe, step_loss = make_vertex_train_step(cfg, normals_weight)(probe, tensors, *draws)
    assert probe.step == 1 and float(step_loss) == float(loss.detach())
    assert all(t.grad is not None for _, t in _flat(probe.params))

    for leaf, (_, jg) in zip(leaves, _flat(jax.tree.map(np.asarray, j_grads))):
        leaf.grad = torch.tensor(jg)
    adam_update(state)
    for (name, jp), t in zip(_flat(jax.tree.map(np.asarray, j_next.params)), leaves):
        np.testing.assert_allclose(t.detach().numpy(), jp, atol=1e-7, err_msg=name)


def test_vertex_eval_matches_jax_eval_without_a_backward(vertex_patch):
    """``step.eval`` against the JAX step's ``eval`` (normals weight 0.5, the
    same draws): the same loss, computed without a graph, and no parameter
    gets a gradient."""
    jcfg, cfg = _cfgs()
    jstate, tx = jax_create_train_state(jax.random.PRNGKey(1), jcfg, multi_scale=True)
    jstep = jax_make_vertex_train_step(tx, jcfg, normals_weight=0.5)
    args, extra = _jax_args(jcfg, vertex_patch, "operator")
    key = jax.random.PRNGKey(3)
    j_loss = float(jstep.eval(jstate.params, *args, key, *extra))
    state = create_train_state(cfg, device="cpu", multi_scale=True, params=params_io.params_from_jax(
        jax.tree.map(np.asarray, jstate.params), device="cpu"))
    step = make_vertex_train_step(cfg, normals_weight=0.5)
    loss = step.eval(state.params, vertex_patch_tensors(cfg, vertex_patch, "cpu"),
                     *_jax_draws(key, vertex_patch))
    assert loss.grad_fn is None and not loss.requires_grad
    assert all(t.grad is None for _, t in _flat(state.params))
    np.testing.assert_allclose(float(loss), j_loss, rtol=1e-6)
    assert state.step == 0


def test_vertex_step_draws_from_its_generator(vertex_patch):
    """Without injected draws the step takes the rotation and both sample
    sets from its generator: two steps from the same seed and parameters
    report the same loss."""
    _, cfg = _cfgs()
    tensors = vertex_patch_tensors(cfg, vertex_patch, "cpu")
    reported = []
    for _ in range(2):
        state = create_train_state(cfg, device="cpu", multi_scale=True)
        step = make_vertex_train_step(cfg, generator=torch.Generator().manual_seed(4))
        state, loss = step(state, tensors)
        assert state.step == 1 and math.isfinite(float(loss))
        reported.append(float(loss))
    assert reported[0] == reported[1]


# ---------------------------------------------------------------------------
# the vertex sets on disk
# ---------------------------------------------------------------------------

def test_vertex_npz_is_read_by_both_packages(tmp_path, monkeypatch):
    """A vertex set written by either package is read by the other with every
    patch field (both on their NumPy coarsening paths), and the port builds
    the same patches as the JAX package for the same seed."""
    monkeypatch.setenv("FGC_DISABLE_NATIVE", "1")
    v, f = icosphere(2)
    noisy = add_vertex_noise(v, f, 0.2, np.random.default_rng(1))
    sets = []
    for cls in (TrainingSet, JaxTrainingSet):
        ds = cls(max_patch_size=200, coarsening_steps=2, coarsening_levels=3, k_faces=23,
                 k_vertices=25, seed=0)
        ds.add_mesh_with_vertices(noisy, f, gt_vertices=v)
        sets.append(ds)
    assert len(sets[0].patches) == len(sets[1].patches) > 1
    save_dataset(sets[0], str(tmp_path / "port.npz"))
    jax_save_dataset(sets[1], str(tmp_path / "jax.npz"))
    for ds in (jax_load_dataset(str(tmp_path / "port.npz")),
               load_dataset(str(tmp_path / "jax.npz")), load_dataset(str(tmp_path / "port.npz"))):
        assert len(ds.patches) == len(sets[1].patches)
        for p, q in zip(ds.patches, sets[1].patches):
            for name in PATCH_FIELDS:
                a, b = getattr(p, name), getattr(q, name)
                assert a is not None and b is not None, name
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=name)
            for a, b in zip(p.adjs, q.adjs, strict=True):
                np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# train_with_vertices
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def port_vertex_set():
    return _noisy_sphere(TrainingSet)


def _train_cfg(tmp_path, solver, **train):
    _, cfg = _cfgs(solver)
    return cfg.replace(train={**TRAIN, "network_path": str(tmp_path) + "/", "save_every": 5,
                              "valid_every": 4, **train})


@pytest.mark.parametrize("solver", ["operator", "naive"])
def test_train_with_vertices_end_to_end(port_vertex_set, tmp_path, solver, capsys):
    """12 steps on the CPU: a history row a step, finite and not exploding
    (the JAX test's contract), the CSV, checkpoints at 5 and 10 and the final
    12 with the three heads in params.pt, a validation sweep every 4 steps;
    then a resumed run continues from 12."""
    cfg = _train_cfg(tmp_path, solver)
    state, hist = train_with_vertices(cfg, port_vertex_set, valid_set=port_vertex_set,
                                      num_iterations=12, device="cpu")
    assert hist.shape == (12, 2) and np.isfinite(hist[:, 0]).all()
    assert hist[-1, 0] < 5 * hist[0, 0]
    assert np.isfinite(hist[:, 1]).all()                       # a sweep at step 0
    assert capsys.readouterr().out.count("validation loss") == 3   # steps 0, 4, 8
    rows = np.loadtxt(os.path.join(cfg.train.network_path, "net.csv"), delimiter=",")
    np.testing.assert_allclose(rows, hist)
    mgr = CheckpointManager(cfg.train.network_path, cfg.train.net_name)
    assert mgr.steps() == [5, 10, 12] and state.step == 12
    served = params_io.load(params_io.checkpoint_path(cfg.train.network_path, "net"), "cpu")
    assert set(MULTI_SCALE_HEADS) <= set(served)
    for (name, t), (_, s) in zip(_flat(state.params), _flat(served)):
        assert torch.equal(t.detach(), s), name

    more, hist2 = train_with_vertices(cfg, port_vertex_set, num_iterations=3, device="cpu")
    assert more.step == 15 and mgr.latest_step() == 15 and hist2.shape == (3, 2)
    assert np.isnan(hist2[:, 1]).all()                         # no validation set


def test_train_with_vertices_nan_abort_keeps_no_poisoned_state(port_vertex_set, tmp_path,
                                                              monkeypatch):
    """A NaN loss at step 7 stops the run at once: the checkpoint of step 5
    stays the latest, no final save, and the served params.pt is finite."""
    cfg = _train_cfg(tmp_path, "operator")
    calls = []
    loss_fn = trainer.vertex_loss

    def poisoned(*args, **kwargs):
        calls.append(1)
        loss = loss_fn(*args, **kwargs)
        return loss * math.nan if len(calls) > 7 else loss

    monkeypatch.setattr(trainer, "vertex_loss", poisoned)
    state, hist = train_with_vertices(cfg, port_vertex_set, num_iterations=20, device="cpu")
    assert len(calls) == 8 and hist.shape == (8, 2) and math.isnan(hist[-1, 0])
    mgr = CheckpointManager(cfg.train.network_path, cfg.train.net_name)
    assert mgr.steps() == [5]
    restored, step = mgr.restore(create_train_state(cfg, device="cpu", multi_scale=True))
    assert step == 5 and all(torch.isfinite(t).all() for _, t in _flat(restored.params))
    served = params_io.load(params_io.checkpoint_path(cfg.train.network_path, "net"), "cpu")
    assert all(torch.isfinite(t).all() for _, t in _flat(served))


def test_train_with_vertices_refusals(port_vertex_set, tmp_path, monkeypatch):
    cfg = _train_cfg(tmp_path, "operator")
    with pytest.raises(ValueError, match="vertex_solver"):
        train_with_vertices(cfg.replace(eval={"vertex_solver": "pyramid"}), port_vertex_set,
                            num_iterations=1, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_with_vertices(cfg, port_vertex_set, num_iterations=1)


# ---------------------------------------------------------------------------
# the CLIs: preprocess → train → infer, --include_vertices, on the CPU
# ---------------------------------------------------------------------------

def test_cli_preprocess_train_infer_include_vertices(tmp_path, capsys):
    """cli.preprocess --include_vertices writes the WithVertices sets,
    cli.train --include_vertices trains the full-width multi-scale network
    through the solver on them (reading the validation set), and
    cli.infer --include_vertices serves its params.pt: the seven files."""
    base = tmp_path / "run"
    train_dir = base / "Data" / "Synthetic" / "train"
    for sub in ("noisy", "original", "valid"):
        (train_dir / sub).mkdir(parents=True)
    v, f = icosphere(2)
    write_obj(add_vertex_noise(v, f, 0.2, np.random.default_rng(0)), f,
              str(train_dir / "noisy" / "sphere_n1.obj"))
    write_obj(v, f, str(train_dir / "original" / "sphere.obj"))
    write_obj(add_vertex_noise(v, f, 0.2, np.random.default_rng(1)), f,
              str(train_dir / "valid" / "sphere_n2.obj"))
    common = ["--base_path", str(base), "--network_path", str(tmp_path / "nets"),
              "--include_vertices"]
    cli_preprocess.main(common)
    for name in ("trainingSetWithVertices.npz", "validSetWithVertices.npz"):
        ds = load_dataset(str(base / "Preprocessed_Data" / name))
        assert ds.patches and all(p.gt_vertices is not None for p in ds.patches)
    assert not (base / "Preprocessed_Data" / "trainingSet.npz").exists()

    cli_train.main(common + ["--device", "cpu", "--num_iterations", "2"])
    assert CheckpointManager(str(tmp_path / "nets"), "net").steps() == [2]
    rows = np.loadtxt(str(tmp_path / "nets" / "net.csv"), delimiter=",", ndmin=2)
    assert rows.shape == (2, 2) and np.isfinite(rows).all()
    assert "validation loss" in capsys.readouterr().out
    params = params_io.load(params_io.checkpoint_path(str(tmp_path / "nets"), "net"), "cpu")
    assert params["fc1"]["w"].shape == (32, 1024) and set(MULTI_SCALE_HEADS) <= set(params)

    out_dir = tmp_path / "out"
    cli_infer.main(common + ["--device", "cpu", "--input_dir", str(train_dir / "noisy"),
                             "--results_path", str(out_dir)])
    assert sorted(os.listdir(out_dir)) == sorted("sphere_n1" + s for s in SEVEN_FILES)
