"""The port's multi-step train calls (``steps_per_call > 1``) on the CPU:
the stacked patch tables, one call against JAX's ``make_scanned_train_step``,
the chunk loops of ``train_normals`` and ``train_with_vertices`` (exact
update counts, the same draws and states as single steps, the NaN abort, the
vertex loop's pinned patches), the checkpoint of the card's capturable Adam
read on the CPU, and the numpy Adam that ``tests/test_torch_cuda.py`` holds
the capturable Adam against, here against optax.

On the CPU a call runs the captured step's code eagerly, a step at a time
(``training/graph_step.py``). Small widths: the normals network at channels
8/16/32, M = 4, fc 64; the vertex network at 4/8/16, M = 2, fc 16, schedule
(8, 4, 4), 32 chamfer samples. The JAX side runs its Pallas epilogue in
interpret mode.

Tolerances: a patch's loss and gradients from the stacked tables against its
own tables, loss rtol 1e-6 and gradients atol 1e-6 scaled to max 1 (the
padded slots add exact zeros, but the plain K1/K2's einsums may block the
longer slot axis differently); the multi-step call against JAX, losses atol
2e-4 degrees and parameters atol 1e-6 (float32 sums in another order through
three steps; see the test); chunked against single steps bit for bit; the
numpy Adam against optax atol 1e-7.
"""

import contextlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import facet_graph_convolution_tpu.ops.pallas_conv as pallas_conv
from facet_graph_convolution_tpu.config import default_config as jax_default_config
from facet_graph_convolution_tpu.models.augment import random_rotation as jax_random_rotation
from facet_graph_convolution_tpu.training.trainer import _patch_arrays, _stack_patch_arrays
from facet_graph_convolution_tpu.training.trainer import (
    create_train_state as jax_create_train_state,
)
from facet_graph_convolution_tpu.training.trainer import (
    make_normals_train_step as jax_make_normals_train_step,
)
from facet_graph_convolution_tpu.training.trainer import (
    make_scanned_train_step as jax_make_scanned_train_step,
)
from facet_graph_convolution_torch import params as params_io
from facet_graph_convolution_torch.config import default_config
from facet_graph_convolution_torch.data.dataset import TrainingSet, bucket_size, pad_patch_to
from facet_graph_convolution_torch.data.synthetic import add_vertex_noise, icosphere
from facet_graph_convolution_torch.graph.convert import transpose_adjacency
from facet_graph_convolution_torch.models.augment import random_rotation
from facet_graph_convolution_torch.training import trainer
from facet_graph_convolution_torch.training.checkpoint import CheckpointManager
from facet_graph_convolution_torch.training.trainer import (
    create_train_state,
    make_scanned_train_step,
    make_vertex_train_step,
    normals_draws,
    normals_loss,
    patch_tensors,
    stack_patch_tensors,
    train_normals,
    train_with_vertices,
    vertex_patch_tensors,
)
from tests.conftest import make_icosphere
from tests.test_torch_cuda import optax_adam_reference

MODEL = {"channels": (8, 16, 32), "num_filters": 4, "fc_channels": 64}
TRAIN = {"loss_samples": 128, "save_every": 1000, "eval_every": 10, "valid_every": 1000,
         "seed": 0}
VERTEX = dict(model={"channels": (4, 8, 16), "num_filters": 2, "fc_channels": 16},
              eval={"ms_solver_iterations": (8, 4, 4)})
VERTEX_TRAIN = {"chamfer_samples": 32, "save_every": 1000, "valid_every": 1000, "seed": 0}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small tensors: one intra-op thread, so that parallel test workers do
    not oversubscribe the CPU."""
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


def _noisy_sphere(max_patch_size, vertices=False):
    v, f = make_icosphere(2)
    noisy = (v + np.random.default_rng(3).normal(scale=0.02, size=v.shape)).astype(np.float32)
    ds = TrainingSet(max_patch_size=max_patch_size, coarsening_steps=2, coarsening_levels=3,
                     k_faces=23, seed=0)
    if vertices:
        ds.add_mesh_with_vertices(noisy, f, gt_vertices=v)
    else:
        ds.add_mesh(noisy, f, gt_vertices=v)
    return ds


@pytest.fixture(scope="module")
def multi_set():
    """Four normals patches of 112-128 faces whose K' differ per level."""
    return _noisy_sphere(100)


@pytest.fixture(scope="module")
def one_patch_set():
    return _noisy_sphere(20000)


@pytest.fixture(scope="module")
def vertex_sets():
    """A one-patch and a three-patch vertex set."""
    v, f = icosphere(2)
    noisy = add_vertex_noise(v, f, 0.2, np.random.default_rng(1))
    sets = []
    for size in (20000, 200):
        ds = TrainingSet(max_patch_size=size, coarsening_steps=2, coarsening_levels=3,
                         k_faces=23, seed=0)
        ds.add_mesh_with_vertices(noisy, f, gt_vertices=v)
        sets.append(ds)
    assert len(sets[0].patches) == 1 and len(sets[1].patches) == 3
    return sets


def _padded(patches):
    target = max(bucket_size(p.num_nodes, 64) for p in patches)
    return [pad_patch_to(p, target) for p in patches]


def _flat(tree):
    return [(f"{layer}.{name}", tree[layer][name])
            for layer in sorted(tree) for name in sorted(tree[layer])]


def _normals_cfg(tmp_path=None, **train):
    net = {"network_path": str(tmp_path) + "/"} if tmp_path is not None else {}
    return default_config().replace(model=MODEL, train={**TRAIN, **net, **train})


def _vertex_cfg(tmp_path, **train):
    return default_config().replace(
        **VERTEX, train={**VERTEX_TRAIN, "network_path": str(tmp_path) + "/", **train})


def _train(kind, cfg, ds, **kw):
    if kind == "normals":
        return train_normals(cfg, ds, bucket_align=64, device="cpu", **kw)
    return train_with_vertices(cfg, ds, device="cpu", **kw)


# ---------------------------------------------------------------------------
# (a) the stacked tables
# ---------------------------------------------------------------------------

def test_stacked_tables_give_each_patch_its_own_loss_and_gradients(multi_set):
    """Each patch selected from the stack (zero-padded to the largest K' and
    K_t) gives the loss and parameter gradients of its own tables; the
    stacked transpose maps still list every slot that reads a node."""
    patches = _padded(multi_set.patches)
    stack = stack_patch_tensors(patches, "cpu")
    widths = {tuple(a.shape[0] for a in patch_tensors(p, "cpu")[1]) for p in patches}
    assert len(widths) > 1                                # the patches' K' differ
    for lvl, (adj, adj_t) in enumerate(zip(stack.adjs, stack.adj_ts)):
        for i in range(len(patches)):
            want = transpose_adjacency(adj[i].numpy(), num_targets=adj.shape[2])
            got = adj_t[i].numpy()
            assert not got[:, want.shape[1]:].any()
            np.testing.assert_array_equal(got[:, :want.shape[1]], want, err_msg=f"level {lvl}")
    cfg = _normals_cfg()
    state = create_train_state(cfg, device="cpu")
    leaves = [t for _, t in _flat(state.params)]
    rng = np.random.default_rng(0)
    for i, patch in enumerate(patches):
        rot = torch.as_tensor(np.linalg.qr(rng.normal(size=(3, 3)))[0].astype(np.float32))
        idx = torch.as_tensor(rng.integers(0, patch.num_nodes, 128))
        out = []
        for tensors in (patch_tensors(patch, "cpu"), stack.select(torch.tensor([i]))):
            loss = normals_loss(state.params, cfg, *tensors, idx, rot)
            out.append((float(loss.detach()), torch.autograd.grad(loss, leaves)))
        (loss_own, g_own), (loss_stack, g_stack) = out
        assert abs(loss_stack - loss_own) <= 1e-6 * abs(loss_own)
        for (name, _), a, b in zip(_flat(state.params), g_stack, g_own):
            scale = float(b.abs().max()) or 1.0
            np.testing.assert_allclose(a.numpy() / scale, b.numpy() / scale, atol=1e-6,
                                       err_msg=f"patch {i}: {name}")


def test_stacking_refuses_patches_of_different_sizes(multi_set):
    with pytest.raises(ValueError, match="pad_patch_to"):
        stack_patch_tensors(multi_set.patches, "cpu")


# ---------------------------------------------------------------------------
# (b) one multi-step call against JAX's make_scanned_train_step
# ---------------------------------------------------------------------------

def _jax_stack(patches):
    """JAX's stacked arrays of its Pallas-form patch tables: its
    ``_stack_patch_arrays`` pads 2-D leaves, so the [K'+1, N', 1] rows go
    through it as [K'+1, N'] and get their last axis back."""
    arrays = []
    for p in patches:
        x, adjs, gt, adj_ts, mults = _patch_arrays(p, pallas=True)
        arrays.append((x, adjs, gt, adj_ts,
                       tuple({"pallas_rows": m["pallas_rows"][:, :, 0]} for m in mults)))
    xs, adjs, gts, adj_ts, mults = _stack_patch_arrays(arrays)
    return xs, adjs, gts, adj_ts, tuple({"pallas_rows": m["pallas_rows"][..., None]}
                                        for m in mults)


def test_scanned_call_matches_jax(multi_set):
    """Three steps in one call over two stacked patches (patch sequence 1, 0,
    1) against JAX's ``make_scanned_train_step(step_fn, 3)`` on its own
    stacked tables, from the same parameters. Each step's rotation and loss
    samples are derived from JAX's per-step keys as its scan body does
    (trainer.py:386-389, :125-130) and injected into the port's call. The
    per-step losses (~100 degrees) agree within 2e-4: the first step's
    within float32's few ulps, the later ones also carry the parameters'
    float32 differences (about ten ulps). The parameters after the three
    updates agree within 1e-6: Adam's first move is ±lr whatever a
    gradient's size, so a near-zero gradient summed in another order could
    flip it by 2·lr, which these draws do not meet."""
    patches = _padded(multi_set.patches[:2])
    jcfg = jax_default_config().replace(model=MODEL, train=TRAIN)
    cfg = default_config().replace(model=MODEL, train=TRAIN)
    jstate, tx = jax_create_train_state(jax.random.PRNGKey(0), jcfg)
    run = jax_make_scanned_train_step(jax_make_normals_train_step(tx, jcfg), 3)
    xs, adjs, gts, adj_ts, mults = _jax_stack(patches)
    idxs = np.array([1, 0, 1])
    base_key = jax.random.PRNGKey(11)
    with pallas_interpret():
        jnext, jlosses = run(jstate, xs, adjs, gts, jnp.asarray(idxs), base_key, adj_ts, mults)
    n = patches[0].num_nodes
    rots, samples = [], []
    for key in jax.random.split(base_key, 3):
        rot_key, samp_key = jax.random.split(key)
        rots.append(np.asarray(jax_random_rotation(rot_key)))
        samples.append(np.asarray(jax.random.randint(samp_key, (TRAIN["loss_samples"],), 0, n)))

    state = create_train_state(cfg, device="cpu", params=params_io.params_from_jax(
        jax.tree.map(np.asarray, jstate.params), device="cpu"))
    scanned = make_scanned_train_step(state, cfg, stack_patch_tensors(patches, "cpu"), 3)
    state, losses = scanned(state, {"idx": torch.tensor(idxs).reshape(3, 1),
                                    "sample_idx": torch.tensor(np.stack(samples)),
                                    "rot": torch.tensor(np.stack(rots))})
    np.testing.assert_allclose(losses.numpy(), np.asarray(jlosses), atol=2e-4)
    assert state.step == int(jnext.step) == 3
    for (name, jp), (_, t) in zip(_flat(jax.tree.map(np.asarray, jnext.params)),
                                  _flat(state.params)):
        np.testing.assert_allclose(t.detach().numpy(), jp, atol=1e-6, err_msg=name)


# ---------------------------------------------------------------------------
# (c) exact update counts with a remainder chunk
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["normals", "vertex"])
def test_remainder_chunk_applies_exactly_num_iterations(kind, multi_set, vertex_sets, tmp_path):
    """70 iterations at 32 a call: chunks of 32, 32 and 6, 70 updates (JAX
    tests/test_training.py::test_scanned_training_exact_iteration_count),
    a history row a chunk, the final checkpoint at 70."""
    if kind == "normals":
        cfg, ds = _normals_cfg(tmp_path, loss_samples=64), multi_set
    else:
        cfg, ds = _vertex_cfg(tmp_path), vertex_sets[1]
    state, hist = _train(kind, cfg, ds, num_iterations=70, steps_per_call=32)
    assert state.step == 70
    assert all(int(s["step"]) == 70 for s in state.optimizer.state.values())
    assert hist.shape == (3, 2) and np.isfinite(hist[:, 0]).all()
    assert CheckpointManager(cfg.train.network_path, cfg.train.net_name).steps() == [70]


# ---------------------------------------------------------------------------
# (d) a call of k steps is k single steps
# ---------------------------------------------------------------------------

def test_normals_draws_are_the_single_steps_draws():
    """normals_draws takes from the generator what as many single steps
    take, in their order: the rotation, then the loss samples."""
    cfg = _normals_cfg()
    a, b = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
    draws = normals_draws(cfg, a, [2, 0, 1], 96)
    for j in range(3):
        assert torch.equal(draws["rot"][j], random_rotation(b))
        assert torch.equal(draws["sample_idx"][j], torch.randint(0, 96, (128,), generator=b))
    assert draws["idx"].tolist() == [[2], [0], [1]]
    assert torch.equal(torch.rand(4, generator=a), torch.rand(4, generator=b))


@pytest.mark.parametrize("kind", ["normals", "vertex"])
def test_chunked_training_equals_single_steps(kind, one_patch_set, vertex_sets, tmp_path):
    """On a one-patch set, 7 steps at 3 a call and 7 single steps from the
    same generator: the same draws, so the same parameters, Adam state and
    checkpoints (3, 6 and 7), bit for bit."""
    ds = one_patch_set if kind == "normals" else vertex_sets[0]
    runs = []
    for spc in (3, 1):
        out = tmp_path / f"spc{spc}"
        cfg = (_normals_cfg(out, save_every=3) if kind == "normals"
               else _vertex_cfg(out, save_every=3))
        state, _ = _train(kind, cfg, ds, num_iterations=7, steps_per_call=spc)
        runs.append((state, CheckpointManager(cfg.train.network_path, cfg.train.net_name)))
    (chunked, mgr_c), (single, mgr_s) = runs
    assert chunked.step == single.step == 7
    assert mgr_c.steps() == mgr_s.steps() == [3, 6, 7]
    for (name, a), (_, b) in zip(_flat(chunked.params), _flat(single.params)):
        assert torch.equal(a, b), name
    for a, b in zip(trainer._leaves(chunked.params), trainer._leaves(single.params)):
        sa, sb = chunked.optimizer.state[a], single.optimizer.state[b]
        assert all(torch.equal(sa[k], sb[k]) for k in ("step", "exp_avg", "exp_avg_sq"))
    for step in (3, 6, 7):
        ta = torch.load(mgr_c._path(step), weights_only=True)
        tb = torch.load(mgr_s._path(step), weights_only=True)
        assert ta["step"] == tb["step"] == step
        for layer, leaves in ta["params"].items():
            for name, t in leaves.items():
                assert torch.equal(t, tb["params"][layer][name]), (step, layer, name)


# ---------------------------------------------------------------------------
# (e) a NaN inside a chunk
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["normals", "vertex"])
@pytest.mark.parametrize("first_nan,calls,saved", [(13, 16, [4, 8, 12]), (10, 12, [4, 8])])
def test_nan_chunk_aborts_without_a_final_save(kind, first_nan, calls, saved, multi_set,
                                               vertex_sets, tmp_path, monkeypatch):
    """Chunks of 4, a checkpoint every 4 steps, 40 iterations, NaN losses
    from call ``first_nan`` on: the run stops at the NaN chunk, saves none
    of it and no final state, and the served params.pt is finite. A NaN at
    call 13 falls in the chunk of 13-16, read at once (16 is a checkpoint);
    one at call 10 in the chunk of 9-12, also read at once, so the next
    chunk never starts; a chunk runs whole, so the calls end with it."""
    name = "normals_loss" if kind == "normals" else "vertex_loss"
    loss_fn = getattr(trainer, name)
    count = []

    def poisoned(*args, **kwargs):
        count.append(1)
        loss = loss_fn(*args, **kwargs)
        return loss * math.nan if len(count) >= first_nan else loss

    monkeypatch.setattr(trainer, name, poisoned)
    if kind == "normals":
        cfg, ds = _normals_cfg(tmp_path, save_every=4), multi_set
    else:
        cfg, ds = _vertex_cfg(tmp_path, save_every=4), vertex_sets[1]
    state, hist = _train(kind, cfg, ds, num_iterations=40, steps_per_call=4)
    assert len(count) == calls
    assert math.isnan(hist[-1, 0]) and np.isfinite(hist[:-1, 0]).all()
    mgr = CheckpointManager(cfg.train.network_path, cfg.train.net_name)
    assert mgr.steps() == saved
    served = params_io.load(params_io.checkpoint_path(cfg.train.network_path, "net"), "cpu")
    assert all(torch.isfinite(t).all() for _, t in _flat(served))


def test_nan_in_a_deferred_chunk_is_read_one_chunk_late(multi_set, tmp_path, monkeypatch):
    """Without checkpoints inside the run, chunk 2 (calls 5-8) turns NaN;
    its losses are read after chunk 3 is enqueued (the deferred read), so
    12 calls ran, and nothing is saved."""
    loss_fn = trainer.normals_loss
    count = []

    def poisoned(*args, **kwargs):
        count.append(1)
        loss = loss_fn(*args, **kwargs)
        return loss * math.nan if len(count) >= 6 else loss

    monkeypatch.setattr(trainer, "normals_loss", poisoned)
    cfg = _normals_cfg(tmp_path)
    _, hist = _train("normals", cfg, multi_set, num_iterations=40, steps_per_call=4)
    assert len(count) == 12 and hist.shape == (2, 2) and math.isnan(hist[-1, 0])
    assert CheckpointManager(cfg.train.network_path, cfg.train.net_name).steps() == []


# ---------------------------------------------------------------------------
# (f) the vertex loop pins one patch a chunk
# ---------------------------------------------------------------------------

def test_vertex_chunks_pin_one_patch_in_the_jax_sequence(vertex_sets, tmp_path, monkeypatch):
    """Each chunk runs on one patch, drawn as the JAX loop draws it
    (trainer.py:1019: ``rng.integers(len(arrays))`` a chunk from
    ``default_rng(seed)``), with a step graph a patch made at its first
    use."""
    ds = vertex_sets[1]
    loss_fn = trainer.vertex_loss
    seen, made = [], []

    def patch_of(t):
        return next(i for i, p in enumerate(ds.patches) if np.array_equal(t.x.numpy(), p.inputs))

    def record(params, cfg, t, *args, **kwargs):
        seen.append(patch_of(t))
        return loss_fn(params, cfg, t, *args, **kwargs)

    make_step = trainer.make_vertex_train_step

    def counting(*args, **kwargs):
        step = make_step(*args, **kwargs)
        inner = step.scanned

        def scanned(state, t, steps_per_call):
            made.append(patch_of(t))
            return inner(state, t, steps_per_call)

        step.scanned = scanned
        return step

    monkeypatch.setattr(trainer, "vertex_loss", record)
    monkeypatch.setattr(trainer, "make_vertex_train_step", counting)
    cfg = _vertex_cfg(tmp_path, seed=3)
    _train("vertex", cfg, ds, num_iterations=22, steps_per_call=5)
    rng = np.random.default_rng(3)
    want = []
    for chunk in (5, 5, 5, 5, 2):
        want += [int(rng.integers(3))] * chunk
    assert len(set(want)) > 1 and seen == want
    assert sorted(made) == sorted(set(want))


# ---------------------------------------------------------------------------
# Adam: the card's checkpoints on the CPU, and the numpy reference of optax
# ---------------------------------------------------------------------------

def test_a_capturable_adam_checkpoint_loads_on_the_cpu(one_patch_set, tmp_path):
    """A checkpoint in the card's form (capturable Adam, a tensor learning
    rate) restores into the CPU's plain Adam with its own settings: the
    moments and counts loaded, the learning rate a float again; training
    then resumes from it."""
    cfg = _normals_cfg(tmp_path)
    state, _ = train_normals(cfg, one_patch_set, num_iterations=2, bucket_align=64,
                             device="cpu")
    mgr = CheckpointManager(cfg.train.network_path, cfg.train.net_name)
    tree = torch.load(mgr._path(2), weights_only=True)
    for group in tree["optimizer"]["param_groups"]:
        group.update(capturable=True, foreach=True, lr=torch.tensor(0.5))
    torch.save(tree, mgr._path(2))
    restored, step = mgr.restore(create_train_state(cfg, device="cpu"))
    assert step == 2 and restored.step == 2
    group = restored.optimizer.param_groups[0]
    assert group["capturable"] is False and isinstance(group["lr"], float)
    for a, b in zip(trainer._leaves(restored.params), trainer._leaves(state.params)):
        sa, sb = restored.optimizer.state[a], state.optimizer.state[b]
        assert sa["step"].device.type == "cpu" and int(sa["step"]) == 2
        assert torch.equal(sa["exp_avg"], sb["exp_avg"])
    more, _ = train_normals(cfg, one_patch_set, num_iterations=2, bucket_align=64,
                            device="cpu", steps_per_call=2)
    assert more.step == 4 and mgr.latest_step() == 4


def test_numpy_adam_reference_matches_optax():
    """``optax_adam_reference`` (what tests/test_torch_cuda.py holds the
    card's capturable Adam against, where JAX is absent) equals optax.adam
    over three updates from a loaded state, within 1e-7."""
    rng = np.random.default_rng(2)
    params = {"w": rng.normal(size=(5, 4)).astype(np.float32)}
    mu = {"w": rng.normal(size=(5, 4)).astype(np.float32) * 1e-2}
    nu = {"w": np.abs(rng.normal(size=(5, 4))).astype(np.float32) * 1e-4}
    tx = optax.adam(3e-3)
    state = tx.init(params)
    state = (state[0]._replace(count=jnp.asarray(4, jnp.int32), mu=mu, nu=nu),) + state[1:]
    p, ref = params, (params["w"], mu["w"], nu["w"], 4)
    for _ in range(3):
        g = {"w": rng.normal(size=(5, 4)).astype(np.float32)}
        updates, state = tx.update(g, state, p)
        p = optax.apply_updates(p, updates)
        ref = optax_adam_reference(*ref, g["w"], 3e-3)
        np.testing.assert_allclose(ref[0], np.asarray(p["w"]), atol=1e-7)


def test_vertex_step_draw_is_the_single_steps_draw(vertex_sets):
    """step.draw takes from the generator what as many single vertex steps
    take: the rotation, then the samples of the vertices and of the GT
    vertices."""
    cfg = _vertex_cfg("unused")
    tensors = vertex_patch_tensors(cfg, vertex_sets[0].patches[0], "cpu")
    a, b = torch.Generator().manual_seed(9), torch.Generator().manual_seed(9)
    draws = make_vertex_train_step(cfg, generator=a).draw(tensors, 2)
    for j in range(2):
        assert torch.equal(draws["rot"][j], random_rotation(b))
        for name, n in (("idx0", tensors.vertices.shape[0]),
                        ("idx1", tensors.gt_vertices.shape[0])):
            assert torch.equal(draws[name][j], torch.randint(0, n, (32,), generator=b))
