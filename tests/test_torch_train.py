"""The port's training slice against the JAX package, on the CPU.

On CPU tensors the K1 and K2 wrappers run their plain PyTorch versions, so
these tests hold those versions, the autograd Function over them, the
train step, Adam with its schedule, the losses, the augmentation, the
dataset files and the training loop against the JAX package. The JAX side
runs its Pallas epilogue in interpret mode (the monkeypatch of
tests/test_pallas_conv.py). Small widths (channels 8/16/32, M = 4, fc 64),
float32.

Tolerances: conv values and gradients atol 1e-5 (float32 sums in another
order); a train step's loss atol 1e-4 degrees, its gradients atol 1e-4 on
each gradient scaled to max 1 (the backward through 8 convs, 2 dense layers,
the global prescale of normalize_tensor and acos, whose derivative grows
near the clamp); parameters after Adam updates fed the same gradients atol
1e-7.
"""

import contextlib
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import facet_graph_convolution_tpu.ops.pallas_conv as pallas_conv
from facet_graph_convolution_tpu.config import default_config as jax_default_config
from facet_graph_convolution_tpu.data.dataset import TrainingSet as JaxTrainingSet
from facet_graph_convolution_tpu.data.dataset import bucket_size as jax_bucket_size
from facet_graph_convolution_tpu.data.dataset import load_dataset as jax_load_dataset
from facet_graph_convolution_tpu.data.dataset import pad_patch_to as jax_pad_patch_to
from facet_graph_convolution_tpu.data.dataset import save_dataset as jax_save_dataset
from facet_graph_convolution_tpu.graph.convert import dedupe_klist as jax_dedupe
from facet_graph_convolution_tpu.graph.convert import split_self_klist as jax_split
from facet_graph_convolution_tpu.models.augment import random_rotation as jax_random_rotation
from facet_graph_convolution_tpu.models.augment import rotate_inputs as jax_rotate_inputs
from facet_graph_convolution_tpu.models.augment import rotate_vec3 as jax_rotate_vec3
from facet_graph_convolution_tpu.models.losses import (
    charbonnier_face_normals_loss as jax_charbonnier,
)
from facet_graph_convolution_tpu.models.losses import face_normals_loss as jax_face_loss
from facet_graph_convolution_tpu.ops.conv import FacetConvVariant as JaxVariant
from facet_graph_convolution_tpu.ops.conv import init_facet_conv
from facet_graph_convolution_tpu.ops.normalization import normalize_tensor as jax_normalize
from facet_graph_convolution_tpu.training.trainer import _apply_model, _patch_arrays
from facet_graph_convolution_tpu.training.trainer import (
    create_train_state as jax_create_train_state,
)
from facet_graph_convolution_tpu.training.trainer import (
    make_normals_train_step as jax_make_normals_train_step,
)
from facet_graph_convolution_torch import params as params_io
from facet_graph_convolution_torch.cli import infer as cli_infer
from facet_graph_convolution_torch.cli import preprocess as cli_preprocess
from facet_graph_convolution_torch.cli import train as cli_train
from facet_graph_convolution_torch.config import default_config
from facet_graph_convolution_torch.data.dataset import (
    TrainingSet,
    bucket_size,
    load_dataset,
    pad_patch_to,
    save_dataset,
)
from facet_graph_convolution_torch.data.preprocess import preprocess_directory
from facet_graph_convolution_torch.data.stream import ShardedDataset
from facet_graph_convolution_torch.data.synthetic import add_vertex_noise, icosphere
from facet_graph_convolution_torch.geometry.obj_io import load_obj, write_obj
from facet_graph_convolution_torch.graph.convert import slot_major_arrays
from facet_graph_convolution_torch.models.augment import (
    random_rotation,
    rotate_inputs,
    rotate_vec3,
)
from facet_graph_convolution_torch.models.losses import (
    charbonnier_face_normals_loss,
    face_normals_loss,
)
from facet_graph_convolution_torch.ops import facet_conv_kernel as k1
from facet_graph_convolution_torch.ops.conv import FacetConvVariant, facet_conv
from facet_graph_convolution_torch.training import trainer
from facet_graph_convolution_torch.training.checkpoint import CheckpointManager
from facet_graph_convolution_torch.training.trainer import (
    adam_state_from_optax,
    adam_update,
    create_train_state,
    lr_schedule,
    make_normals_train_step,
    normals_loss,
    patch_tensors,
    train_normals,
)
from tests.conftest import make_icosphere

ATOL = 1e-5
GRAD_ATOL = 1e-4
MODEL = {"channels": (8, 16, 32), "num_filters": 4, "fc_channels": 64}
TRAIN = {"loss_samples": 256, "save_every": 50, "eval_every": 10, "valid_every": 1000,
         "seed": 0}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """These tensors are small: one intra-op thread each, so that parallel
    test workers do not oversubscribe the CPU (torch defaults to a thread
    per core)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@contextlib.contextmanager
def pallas_interpret():
    """Run the JAX package's Pallas epilogue in interpret mode on the CPU."""
    orig = pallas_conv.facet_conv_pallas
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pallas_conv, "facet_conv_pallas",
                   lambda *a, **kw: orig(*a, **{**kw, "interpret": True}))
        yield


def _random_graph(rng, n, k):
    """Raw one-indexed K-list: self slot, 0..k-2 random neighbours with
    repeats (multiplicities after dedupe), 0 pads; some rows self-only."""
    adj = np.zeros((n, k), np.int32)
    adj[:, 0] = np.arange(n) + 1
    for i in range(n):
        deg = int(rng.integers(0, k - 1))
        adj[i, 1:1 + deg] = rng.choice(n, size=deg, replace=True) + 1
    return adj


def _tables(adj):
    a_u, mult = jax_dedupe(adj)
    return slot_major_arrays(*jax_split(a_u, mult))


def _flat(tree):
    """(layer.name, array) pairs of a parameter tree, sorted."""
    return [(f"{layer}.{name}", tree[layer][name])
            for layer in sorted(tree) for name in sorted(tree[layer])]


# ---------------------------------------------------------------------------
# (a), (b): the conv and K2's plain version
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant", ["default", "translation_invariant"])
def test_facet_conv_gradients_match_jax(rng, variant):
    """Values and gradients for w, b, u, v, c and x of the port's conv
    (autograd Function, plain K1/K2) against jax.grad of
    facet_conv_pallas(interpret=True)."""
    n = 150
    adj_sm, adj_t_sm, mult_rows = _tables(_random_graph(rng, n, 9))
    assert mult_rows.shape[1] > n                          # padded node axis
    x = rng.normal(size=(n, 6)).astype(np.float32)
    r = rng.normal(size=(n, 8)).astype(np.float32)       # cotangent
    ti = variant != "default"
    jparams = init_facet_conv(jax.random.PRNGKey(1), 6, 8, 4, variant=JaxVariant(variant))
    tables = [jnp.asarray(t) for t in (adj_sm, adj_t_sm, mult_rows)]

    def jloss(p, xx):
        y = pallas_conv.facet_conv_pallas(p, xx, *tables, translation_invariant=ti,
                                          interpret=True)
        return jnp.sum(y * r), y

    (_, y_j), (g_p, g_x) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jparams, jnp.asarray(x))

    params = {k: v.requires_grad_() for k, v in params_io.params_from_jax(
        {"c": jax.tree.map(np.asarray, jparams)}, device="cpu")["c"].items()}
    xt = torch.as_tensor(x).requires_grad_()
    y = facet_conv(params, xt, torch.as_tensor(adj_sm), torch.as_tensor(mult_rows),
                   variant=FacetConvVariant(variant), adj_t_sm=torch.as_tensor(adj_t_sm))
    (y * torch.as_tensor(r)).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_j), atol=ATOL)
    assert set(params) == set(g_p) == ({"w", "b", "u", "c"} | ({"v"} if not ti else set()))
    for name in g_p:
        np.testing.assert_allclose(params[name].grad.numpy(), np.asarray(g_p[name]),
                                   atol=ATOL, err_msg=name)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(g_x), atol=ATOL)


@pytest.mark.parametrize("n,k,c_in,m", [(61, 9, 5, 4), (300, 45, 7, 9)])
def test_backward_plain_matches_autograd(rng, n, k, c_in, m):
    """facet_conv_bwd_plain, written out, against torch autograd through
    facet_conv_fwd_plain; the second case has more than 32 slots and a
    transpose map wider than 32. Both have padded nodes."""
    adj_sm, adj_t_sm, rows = _tables(_random_graph(rng, n, k))
    n_pad = adj_sm.shape[1]
    assert n_pad > n and (k < 32 or (adj_sm.shape[0] + 1 > 32 and adj_t_sm.shape[1] > 32))
    cat = torch.as_tensor(rng.normal(size=(n_pad, c_in + m)).astype(np.float32))
    ux = torch.as_tensor(rng.normal(size=(n_pad, m)).astype(np.float32))
    c = torch.as_tensor(rng.normal(size=(m,)).astype(np.float32))
    dz = torch.as_tensor(rng.normal(size=(n_pad, m * c_in)).astype(np.float32))
    tabs = (torch.as_tensor(adj_sm), torch.as_tensor(rows[:, :, 0]))
    leaves = [t.clone().requires_grad_() for t in (cat, ux, c)]
    z = k1.facet_conv_fwd_plain(leaves[0], leaves[1], tabs[0], tabs[1], leaves[2])
    want = torch.autograd.grad(z, leaves, dz)
    before = k1.facet_conv_bwd.launches
    dcat, dux = k1.facet_conv_bwd(cat, ux, tabs[0], torch.as_tensor(adj_t_sm), tabs[1], c, dz)
    assert k1.facet_conv_bwd.launches == before              # CPU: plain, no launch
    for got, ref in zip((dcat, dux, dux.sum(0)), want):
        np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=ATOL)


def test_kernel_launch_outside_autograd_loses_the_gradient(rng, monkeypatch):
    """The fault of slice 1 and its repair. A kernel launched through ctypes
    fills a fresh tensor: it has no grad_fn. Slice 1 called K1 so on the
    card, and the loss gradient never reached u, v, c or x there. Emulated
    here with a stand-in for the launch that returns such a tensor: called
    directly it cuts the graph; through the conv's autograd Function the
    gradients are those of autograd through the plain version."""
    n = 80
    adj_sm, adj_t_sm, mult_rows = _tables(_random_graph(rng, n, 7))
    x = torch.as_tensor(rng.normal(size=(n, 6)).astype(np.float32))
    layer = params_io.params_from_jax({"c": jax.tree.map(np.asarray, init_facet_conv(
        jax.random.PRNGKey(2), 6, 8, 4))}, device="cpu")["c"]

    def grads(fn):
        p = {k: v.clone().requires_grad_() for k, v in layer.items()}
        xt = x.clone().requires_grad_()
        y = fn(p, xt)
        return y, torch.autograd.grad(y.sum(), [p["u"], p["v"], p["c"], xt], allow_unused=True)

    def plain_conv(p, xt):
        proj = torch.nn.functional.pad(xt, (0, 0, 0, mult_rows.shape[1] - n))
        cat = torch.cat([proj, proj @ p["v"].T], dim=-1)
        z = k1.facet_conv_fwd_plain(cat, proj @ p["u"].T, torch.as_tensor(adj_sm),
                                    torch.as_tensor(mult_rows[:, :, 0]), p["c"])
        w_flat = p["w"].permute(1, 0, 2).reshape(8, -1)
        gate = (torch.as_tensor(mult_rows[:, :, 0]).sum(0) > 0).float()
        return (z @ w_flat.T + p["b"] * gate[:, None])[:n]

    _, want = grads(plain_conv)
    monkeypatch.setattr(k1, "facet_conv_fwd",
                        lambda *a: k1.facet_conv_fwd_plain(*a).detach())
    cat = torch.zeros(mult_rows.shape[1], 10, requires_grad=True)
    z = k1.facet_conv_fwd(cat, torch.zeros(mult_rows.shape[1], 4), torch.as_tensor(adj_sm),
                          torch.as_tensor(mult_rows[:, :, 0]), torch.zeros(4))
    assert z.grad_fn is None and not z.requires_grad          # the fault
    y, got = grads(lambda p, xt: facet_conv(
        p, xt, torch.as_tensor(adj_sm), torch.as_tensor(mult_rows),
        adj_t_sm=torch.as_tensor(adj_t_sm)))
    assert y.grad_fn is not None                              # the repair
    for g, ref in zip(got, want):
        np.testing.assert_allclose(g.numpy(), ref.numpy(), atol=ATOL)


def test_backward_without_transpose_map_raises(rng):
    adj_sm, _, mult_rows = _tables(_random_graph(rng, 40, 5))
    layer = params_io.params_from_jax({"c": jax.tree.map(np.asarray, init_facet_conv(
        jax.random.PRNGKey(3), 6, 8, 4))}, device="cpu")["c"]
    x = torch.randn(40, 6, requires_grad=True)
    y = facet_conv(layer, x, torch.as_tensor(adj_sm), torch.as_tensor(mult_rows))
    with pytest.raises(RuntimeError, match="transpose map"):
        y.sum().backward()


# ---------------------------------------------------------------------------
# (c): one full train step and Adam against the JAX package
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def sphere_patch():
    """A noisy subdivision-2 icosphere with GT, one patch (JAX host code)."""
    v, f = make_icosphere(2)
    noisy = (v + np.random.default_rng(3).normal(scale=0.02, size=v.shape)).astype(np.float32)
    ds = JaxTrainingSet(max_patch_size=20000, coarsening_steps=2, coarsening_levels=3,
                        k_faces=23, seed=0)
    ds.add_mesh(noisy, f, gt_vertices=v)
    return ds


def test_train_steps_match_jax(sphere_patch):
    """Three steps of JAX's make_normals_train_step on
    _patch_arrays(pallas=True) against the port. Each step's rotation and
    loss samples are derived from JAX's key as trainer.py:125-130 does and
    injected into the port. The port's loss and gradients are compared at
    each step; then JAX's gradients are fed to the port's Adam (the same
    gradients for both optimizers: Adam's first update is ±lr for a gradient
    of any size, so a near-zero gradient summed in another order could flip
    a parameter by 2·lr), and the parameters compared after 1 and 3 steps.
    Last, the optax state after 3 steps is loaded into a fresh port state
    (adam_state_from_optax) and one more shared update compared."""
    patch = sphere_patch.patches[0]
    jcfg = jax_default_config().replace(model=MODEL, train=TRAIN)
    cfg = default_config().replace(model=MODEL, train=TRAIN)
    jstate, tx = jax_create_train_state(jax.random.PRNGKey(0), jcfg)
    jstep = jax_make_normals_train_step(tx, jcfg)
    x, adjs, gt, adj_ts, mults = _patch_arrays(patch, pallas=True)

    def jloss(params, rot, idx):
        y = _apply_model(params, jax_rotate_inputs(rot, x), adjs, adj_ts, mults, steps=2,
                         variant=JaxVariant.DEFAULT, alpha=0.1)
        g = jax_rotate_vec3(rot, gt)
        return jax_face_loss(jnp.take(jax_normalize(y), idx, axis=0), jnp.take(g, idx, axis=0))

    state = create_train_state(cfg, device="cpu",
                               params=params_io.params_from_jax(
                                   jax.tree.map(np.asarray, jstate.params), device="cpu"))
    tensors = patch_tensors(patch, "cpu")
    leaves = [t for _, t in _flat(state.params)]
    with pallas_interpret():
        jgrad = jax.jit(jax.value_and_grad(jloss))
        for i in range(4):
            key = jax.random.PRNGKey(10 + i)
            rot_key, samp_key = jax.random.split(key)
            rot = jax_random_rotation(rot_key)
            idx = jax.random.randint(samp_key, (cfg.train.loss_samples,), 0, x.shape[0])
            j_loss, j_grads = jgrad(jstate.params, rot, idx)
            rot_t, idx_t = torch.tensor(np.asarray(rot)), torch.tensor(np.asarray(idx))
            if i == 3:
                break
            loss = normals_loss(state.params, cfg, *tensors, idx_t, rot_t)
            grads = torch.autograd.grad(loss, leaves)
            assert abs(float(loss.detach()) - float(j_loss)) < 1e-4
            for (name, jg), g in zip(_flat(jax.tree.map(np.asarray, j_grads)), grads):
                scale = max(float(np.abs(jg).max()), 1e-30)
                np.testing.assert_allclose(g.numpy() / scale, jg / scale, atol=GRAD_ATOL,
                                           err_msg=name)
            if i == 0:
                # the port's own step, with the same rotation and samples
                probe = create_train_state(cfg, device="cpu", params=state.params)
                probe, step_loss = make_normals_train_step(cfg)(
                    probe, *tensors, rot=rot_t, sample_idx=idx_t)
                assert probe.step == 1 and abs(float(step_loss) - float(j_loss)) < 1e-4
            jstate, jl = jstep(jstate, x, adjs, gt, key, adj_ts, mults)
            assert abs(float(jl) - float(j_loss)) < 1e-4
            for leaf, (_, jg) in zip(leaves, _flat(jax.tree.map(np.asarray, j_grads))):
                leaf.grad = torch.tensor(jg)
            adam_update(state)
            if i in (0, 2):
                for (name, jp), t in zip(_flat(jax.tree.map(np.asarray, jstate.params)),
                                         leaves):
                    np.testing.assert_allclose(t.detach().numpy(), jp, atol=1e-7,
                                               err_msg=f"step {i + 1}: {name}")
    assert state.step == int(jstate.step) == 3

    # optax's state after 3 steps, carried into a fresh port state
    adam = jstate.opt_state[0]
    fresh = create_train_state(cfg, device="cpu", params=state.params)
    adam_state_from_optax(fresh, jax.tree.map(np.asarray, adam.mu),
                          jax.tree.map(np.asarray, adam.nu), int(adam.count))
    updates, _ = tx.update(j_grads, jstate.opt_state, jstate.params)
    j_next = jax.tree.map(np.asarray, optax.apply_updates(jstate.params, updates))
    for (_, leaf), (_, jg) in zip(_flat(fresh.params), _flat(jax.tree.map(np.asarray, j_grads))):
        leaf.grad = torch.tensor(jg)
    adam_update(fresh)
    for (name, jp), (_, t) in zip(_flat(j_next), _flat(fresh.params)):
        np.testing.assert_allclose(t.detach().numpy(), jp, atol=1e-7, err_msg=name)


# ---------------------------------------------------------------------------
# (d): losses, augmentation, schedule
# ---------------------------------------------------------------------------

def test_losses_match_jax(rng):
    """face_normals_loss (values and gradient) and the Charbonnier variant,
    with fake rows (zero GT) masked out."""
    pred = rng.normal(size=(64, 3)).astype(np.float32)
    pred /= np.linalg.norm(pred, axis=1, keepdims=True)
    gt = rng.normal(size=(64, 3)).astype(np.float32)
    gt /= np.linalg.norm(gt, axis=1, keepdims=True)
    gt[::5] = 0.0                                             # fake nodes
    gt[1] = pred[1]                                           # at the acos clamp
    for ours, ref in ((face_normals_loss, jax_face_loss),
                      (charbonnier_face_normals_loss, jax_charbonnier)):
        j_val, j_grad = jax.value_and_grad(ref)(jnp.asarray(pred), jnp.asarray(gt))
        p = torch.as_tensor(pred).requires_grad_()
        val = ours(p, torch.as_tensor(gt))
        val.backward()
        np.testing.assert_allclose(float(val.detach()), float(j_val), rtol=1e-6)
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(j_grad), atol=1e-5)


@pytest.mark.parametrize("c", [6, 7, 8])
def test_rotate_inputs_matches_jax(rng, c):
    rot = np.linalg.qr(rng.normal(size=(3, 3)))[0].astype(np.float32)
    x = rng.normal(size=(20, c)).astype(np.float32)
    np.testing.assert_allclose(
        rotate_inputs(torch.as_tensor(rot), torch.as_tensor(x)).numpy(),
        np.asarray(jax_rotate_inputs(jnp.asarray(rot), jnp.asarray(x))), atol=1e-6)
    np.testing.assert_allclose(
        rotate_vec3(torch.as_tensor(rot), torch.as_tensor(x[:, :3])).numpy(),
        np.asarray(jax_rotate_vec3(jnp.asarray(rot), jnp.asarray(x[:, :3]))), atol=1e-6)


def test_random_rotation_is_a_rotation():
    """The JAX package's construction from the generator's numbers: an
    orthonormal matrix with determinant +1, the same for the same seed."""
    rots = [random_rotation(torch.Generator().manual_seed(s)) for s in (0, 0, 1)]
    for rot in rots:
        np.testing.assert_allclose((rot @ rot.T).numpy(), np.eye(3), atol=1e-5)
        assert abs(float(torch.linalg.det(rot)) - 1.0) < 1e-5
    assert torch.equal(rots[0], rots[1]) and not torch.equal(rots[0], rots[2])


def test_cosine_schedule_matches_optax():
    """lr at steps 0, 1, warmup and end, as create_train_state builds the
    optax schedule (trainer.py:87-96); and optax's order: the first update
    of a cosine run has lr 0 and moves nothing."""
    total = 500
    cfg = default_config().replace(model=MODEL, train={"lr_schedule": "cosine"})
    warmup = min(cfg.train.lr_warmup_steps, max(total // 10, 1))
    ref = optax.warmup_cosine_decay_schedule(
        init_value=0.0, peak_value=cfg.train.learning_rate, warmup_steps=warmup,
        decay_steps=max(total, warmup + 1),
        end_value=cfg.train.learning_rate * cfg.train.lr_min_ratio)
    ours = lr_schedule(cfg, total)
    for count in (0, 1, warmup - 1, warmup, warmup + 1, total // 2, total - 1, total,
                  total + 7):
        # optax computes in float32, the port in float64
        np.testing.assert_allclose(ours(count), float(ref(count)), rtol=1e-5, atol=1e-12)
    assert ours(0) == 0.0
    constant = lr_schedule(default_config(), total)
    assert constant(0) == constant(total) == 1e-3

    state = create_train_state(cfg, num_steps=total, device="cpu")
    before = [t.detach().clone() for _, t in _flat(state.params)]
    for _, t in _flat(state.params):
        t.grad = torch.ones_like(t)
    adam_update(state)
    assert state.step == 1
    assert all(torch.equal(a, t) for a, (_, t) in zip(before, _flat(state.params)))
    adam_update(state)                                        # lr(1) > 0 moves them
    assert not torch.equal(before[0], _flat(state.params)[0][1])


# ---------------------------------------------------------------------------
# (e): dataset files and bucket padding
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,align", [(1000, 1024), (1024, 1024), (1100, 64), (7, 16)])
def test_bucket_size_matches_jax(n, align):
    assert bucket_size(n, align) == jax_bucket_size(n, align)


def test_pad_patch_to_and_npz_match_jax(sphere_patch, tmp_path, monkeypatch):
    """pad_patch_to against JAX; the .npz that each package writes, read by
    the other; and the port's TrainingSet against JAX's (NumPy paths)."""
    patch = sphere_patch.patches[0]
    target = jax_bucket_size(patch.num_nodes, 1024)
    ours, ref = pad_patch_to(patch, target), jax_pad_patch_to(patch, target)
    np.testing.assert_array_equal(ours.inputs, ref.inputs)
    np.testing.assert_array_equal(ours.gt_normals, ref.gt_normals)
    assert len(ours.adjs) == len(ref.adjs) == 3
    for a, b in zip(ours.adjs, ref.adjs):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        pad_patch_to(patch, patch.num_nodes - 16)

    monkeypatch.setenv("FGC_DISABLE_NATIVE", "1")
    v, f = icosphere(2)
    noisy = add_vertex_noise(v, f, 0.2, np.random.default_rng(1))
    sets = []
    for cls in (TrainingSet, JaxTrainingSet):
        ds = cls(max_patch_size=200, coarsening_steps=2, coarsening_levels=3, k_faces=23,
                 seed=0)
        ds.add_mesh(noisy, f, gt_vertices=v)
        sets.append(ds)
    assert len(sets[0].patches) == len(sets[1].patches) > 1
    save_dataset(sets[0], str(tmp_path / "port.npz"))
    jax_save_dataset(sets[1], str(tmp_path / "jax.npz"))
    read = [jax_load_dataset(str(tmp_path / "port.npz")), load_dataset(str(tmp_path / "jax.npz"))]
    for ds in read:
        assert len(ds.patches) == len(sets[0].patches)
        assert (ds.max_patch_size, ds.coarsening_steps, ds.coarsening_levels, ds.k_faces) == (
            200, 2, 3, 23)
        np.testing.assert_array_equal(ds.edge_map, sets[0].edge_map)
        for p, q in zip(ds.patches, sets[0].patches):
            np.testing.assert_array_equal(p.inputs, q.inputs)
            np.testing.assert_array_equal(p.gt_normals, q.gt_normals)
            np.testing.assert_array_equal(p.patch_indices, q.patch_indices)
            np.testing.assert_array_equal(p.perm_inv, q.perm_inv)
            assert p.num_real == q.num_real
            for a, b in zip(p.adjs, q.adjs, strict=True):
                np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# (f): the training loop
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def port_sphere_set():
    v, f = make_icosphere(2)
    noisy = (v + np.random.default_rng(3).normal(scale=0.02, size=v.shape)).astype(np.float32)
    ds = TrainingSet(max_patch_size=20000, coarsening_steps=2, coarsening_levels=3,
                     k_faces=23, seed=0)
    ds.add_mesh(noisy, f, gt_vertices=v)
    return ds


@pytest.fixture(scope="module")
def trained(port_sphere_set, tmp_path_factory):
    """300 steps of train_normals on the CPU (as tests/test_training.py)."""
    net_dir = str(tmp_path_factory.mktemp("nets")) + "/"
    cfg = default_config().replace(model=MODEL, train={**TRAIN, "network_path": net_dir})
    state, hist = train_normals(cfg, port_sphere_set, num_iterations=300, bucket_align=64,
                                log_every=10, device="cpu")
    return cfg, state, hist


def test_loss_halves_and_updates_are_counted(trained):
    cfg, state, hist = trained
    assert np.isfinite(hist[:, 0]).all() and len(hist) == 30
    first, last = np.mean(hist[:3, 0]), np.mean(hist[-3:, 0])
    assert last < first * 0.5, (first, last)
    assert state.step == 300                                  # exactly num_iterations
    assert all(int(s["step"]) == 300 for s in state.optimizer.state.values())
    rows = np.loadtxt(os.path.join(cfg.train.network_path, "net.csv"), delimiter=",")
    np.testing.assert_allclose(rows, hist)


def test_checkpoints_and_resume(trained, port_sphere_set):
    cfg, state, _ = trained
    mgr = CheckpointManager(cfg.train.network_path, cfg.train.net_name)
    assert mgr.steps() == [200, 250, 300]                     # the last 3 kept
    served = params_io.load(params_io.checkpoint_path(cfg.train.network_path, "net"), "cpu")
    for (name, t), (_, s) in zip(_flat(state.params), _flat(served)):
        assert torch.equal(t.detach(), s), name
    restored, step = mgr.restore(create_train_state(cfg, device="cpu"))
    assert step == 300 and restored.step == 300
    for (_, t), (_, s) in zip(_flat(restored.params), _flat(state.params)):
        assert torch.equal(t.detach(), s.detach())
    # resume: 20 more steps continue from 300 and save 320, with a
    # validation sweep every 10 steps (the eval step on the same set)
    more, hist = train_normals(cfg.replace(train={"valid_every": 10}), port_sphere_set,
                               valid_set=port_sphere_set, num_iterations=20,
                               bucket_align=64, log_every=10, device="cpu")
    assert more.step == 320 and mgr.latest_step() == 320
    # rows of steps 0 and 10; a row is logged before that step's sweep (as in
    # the JAX loop), so row 1 carries the validation loss of step 0
    assert hist.shape == (2, 2) and np.isfinite(hist[:, 0]).all()
    assert np.isnan(hist[0, 1]) and 0 < hist[1, 1] < 2 * hist[0, 0]


def test_nan_loss_aborts_without_poisoned_checkpoint(port_sphere_set, tmp_path, monkeypatch):
    cfg = default_config().replace(model=MODEL, train={
        **TRAIN, "network_path": str(tmp_path) + "/", "save_every": 5, "eval_every": 1})
    calls = []
    loss_fn = trainer.normals_loss

    def poisoned(*args, **kwargs):
        calls.append(1)
        loss = loss_fn(*args, **kwargs)
        return loss * math.nan if len(calls) > 12 else loss

    monkeypatch.setattr(trainer, "normals_loss", poisoned)
    state, hist = train_normals(cfg, port_sphere_set, num_iterations=40, bucket_align=64,
                                device="cpu")
    assert len(calls) == 15                                   # aborted at the checkpoint of 15
    assert not np.isfinite(hist[-1, 0])
    mgr = CheckpointManager(cfg.train.network_path, cfg.train.net_name)
    assert mgr.steps() == [5, 10]
    restored, step = mgr.restore(create_train_state(cfg, device="cpu"))
    assert step == 10 and all(torch.isfinite(t).all() for _, t in _flat(restored.params))
    served = params_io.load(params_io.checkpoint_path(cfg.train.network_path, "net"), "cpu")
    assert all(torch.isfinite(t).all() for _, t in _flat(served))


def test_training_refuses_what_is_not_ported(port_sphere_set, tmp_path):
    """An unknown compute_dtype raises; streaming shards, refused before
    they were ported, are written beside the training set."""
    cfg = default_config().replace(model=MODEL)
    with pytest.raises(ValueError, match="compute_dtype"):
        create_train_state(cfg.replace(model={"compute_dtype": "float16"}), device="cpu")
    base = tmp_path / "run"
    v, f = icosphere(2)
    for sub, name, verts in (("noisy", "sphere_n1.obj", add_vertex_noise(
            v, f, 0.2, np.random.default_rng(0))), ("original", "sphere.obj", v)):
        (base / "Data" / "Synthetic" / "train" / sub).mkdir(parents=True)
        write_obj(verts, f, str(base / "Data" / "Synthetic" / "train" / sub / name))
    cfg = default_config(str(base)).replace(model=MODEL, data={"max_patch_size": 100})
    preprocess_directory(cfg, shard_size=3)
    shards = ShardedDataset(str(base / "Preprocessed_Data" / "trainingShards"))
    whole = load_dataset(str(base / "Preprocessed_Data" / "trainingSet.npz"))
    assert len(shards) == len(whole.patches) == 4
    assert [s["num_patches"] for s in shards.index["shards"]] == [3, 1]
    for i, p in enumerate(whole.patches):
        np.testing.assert_array_equal(shards.patch(i).inputs, p.inputs)


# ---------------------------------------------------------------------------
# (g): the CLIs, preprocess → train → infer, on the CPU
# ---------------------------------------------------------------------------

def test_cli_preprocess_train_infer(tmp_path, monkeypatch, capsys):
    base = tmp_path / "run"
    noisy_dir = base / "Data" / "Synthetic" / "train" / "noisy"
    gt_dir = base / "Data" / "Synthetic" / "train" / "original"
    noisy_dir.mkdir(parents=True)
    gt_dir.mkdir(parents=True)
    v, f = icosphere(2)
    write_obj(add_vertex_noise(v, f, 0.2, np.random.default_rng(0)), f,
              str(noisy_dir / "sphere_n1.obj"))
    write_obj(v, f, str(gt_dir / "sphere.obj"))
    valid_dir = base / "Data" / "Synthetic" / "train" / "valid"
    valid_dir.mkdir()
    write_obj(add_vertex_noise(v, f, 0.2, np.random.default_rng(1)), f,
              str(valid_dir / "sphere_n2.obj"))
    common = ["--base_path", str(base), "--network_path", str(tmp_path / "nets")]
    cli_preprocess.main(common + ["--shard_size", "1"])
    for name in ("trainingSet.npz", "validSet.npz", "trainingShards/index.json"):
        assert (base / "Preprocessed_Data" / name).is_file()

    # streaming from the shards: 50 steps, a history row at eval_every (50)
    cli_train.main(common + ["--device", "cpu", "--stream_dir",
                             str(base / "Preprocessed_Data" / "trainingShards"),
                             "--network_path", str(tmp_path / "nets_stream"),
                             "--num_iterations", "50"])
    assert CheckpointManager(str(tmp_path / "nets_stream"), "net").steps() == [50]
    rows = np.loadtxt(str(tmp_path / "nets_stream" / "net.csv"), delimiter=",", ndmin=2)
    assert rows.shape == (1, 2) and np.isfinite(rows[0, 0])
    with monkeypatch.context() as mp:
        mp.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli_train.main(common + ["--num_iterations", "1"])

    cli_train.main(common + ["--device", "cpu", "--num_iterations", "3"])
    assert CheckpointManager(str(tmp_path / "nets"), "net").steps() == [3]
    rows = np.loadtxt(str(tmp_path / "nets" / "net.csv"), delimiter=",", ndmin=2)
    assert rows.shape == (1, 2) and np.isfinite(rows[0, 0])
    assert "validation loss" in capsys.readouterr().out       # validSet.npz was read
    # 6 steps at 4 a call: a chunk of 4 and one of 2, a CSV row each
    nets4 = ["--network_path", str(tmp_path / "nets4")]
    cli_train.main(common + nets4 + ["--device", "cpu", "--num_iterations", "6",
                                     "--steps_per_call", "4"])
    assert CheckpointManager(str(tmp_path / "nets4"), "net").steps() == [6]
    rows = np.loadtxt(str(tmp_path / "nets4" / "net.csv"), delimiter=",", ndmin=2)
    assert rows.shape == (2, 2) and np.isfinite(rows[:, 0]).all()
    cli_infer.main(common + ["--device", "cpu", "--input_dir", str(noisy_dir),
                             "--results_path", str(tmp_path / "out")])
    out_v, out_f, _ = load_obj(str(tmp_path / "out" / "sphere_n1_denoised.obj"))
    assert out_v.shape == v.shape and np.isfinite(out_v).all()
    np.testing.assert_array_equal(out_f.astype(np.int64), f.astype(np.int64))
