"""The port's streaming training (``data/stream.py`` and
``training/trainer.py::train_normals_streaming``) on the CPU, against the
JAX package's (``tests/test_stream.py``'s five tests, and more).

- the shards: written by either package and read by the other, bit for bit,
  with the shard cache held to ``cache_shards``;
- the loader: it delivers, stops and surfaces errors, and draws the JAX
  loader's index sequence for the same seed, by items and by windows;
- the trainer: it converges, with the history shape of JAX's
  ``train_normals_streaming`` for the same ``num_iterations`` /
  ``eval_every`` / ``steps_per_call`` (80/40/1 and 18/8/8); a window of the
  port's streaming step against JAX ``make_windowed_train_step`` on the same
  patches, with the draws of JAX's keys; the windowed path equal to single
  steps bit for bit where the tables are the same; a width growth in the
  middle of a run; the device copies held bounded past the memo; the NaN
  abort; resumption.

Small widths: channels 8/16/32, M = 4, fc 64 on subdivision-2 icosphere
patches. Tolerances: the window against JAX as
``tests/test_torch_scanned.py::test_scanned_call_matches_jax`` (losses atol
2e-4 degrees, parameters atol 1e-6: float32 sums in another order through
three steps); the windowed run with a width growth against single steps on
the same draws, the history rtol 1e-5 and the parameters atol 1e-5 (the
plain K1/K2 sum the padded slot axes, of other lengths, in another order,
through eight Adam updates).
"""

import json
import math
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facet_graph_convolution_tpu.config import default_config as jax_default_config
from facet_graph_convolution_tpu.data.dataset import MeshDataset as JaxMeshDataset
from facet_graph_convolution_tpu.data.dataset import TrainingSet as JaxTrainingSet
from facet_graph_convolution_tpu.data.stream import PrefetchLoader as JaxPrefetchLoader
from facet_graph_convolution_tpu.data.stream import ShardedDataset as JaxShardedDataset
from facet_graph_convolution_tpu.data.stream import save_sharded as jax_save_sharded
from facet_graph_convolution_tpu.models.augment import random_rotation as jax_random_rotation
from facet_graph_convolution_tpu.training.trainer import _leaf_dims, _pad_to_dims, _patch_arrays
from facet_graph_convolution_tpu.training.trainer import (
    create_train_state as jax_create_train_state,
)
from facet_graph_convolution_tpu.training.trainer import (
    make_normals_train_step as jax_make_normals_train_step,
)
from facet_graph_convolution_tpu.training.trainer import (
    make_windowed_train_step as jax_make_windowed_train_step,
)
from facet_graph_convolution_tpu.training.trainer import (
    train_normals_streaming as jax_train_normals_streaming,
)
from facet_graph_convolution_torch import params as params_io
from facet_graph_convolution_torch.config import default_config
from facet_graph_convolution_torch.data.dataset import (
    MeshDataset,
    TrainingSet,
    bucket_size,
    pad_patch_to,
)
from facet_graph_convolution_torch.data.stream import (
    PrefetchLoader,
    ShardedDataset,
    save_sharded,
)
from facet_graph_convolution_torch.training import trainer
from facet_graph_convolution_torch.training.checkpoint import CheckpointManager
from facet_graph_convolution_torch.training.trainer import (
    WindowBuffers,
    create_train_state,
    make_scanned_train_step,
    patch_tensors,
    train_normals_streaming,
)
from tests.conftest import make_icosphere

MODEL = {"channels": (8, 16, 32), "num_filters": 4, "fc_channels": 64}
TRAIN = {"loss_samples": 128, "save_every": 1000, "eval_every": 10, "valid_every": 1000,
         "seed": 0}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small tensors: one intra-op thread, so that parallel test workers do
    not oversubscribe the CPU."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _sphere_set(kind, max_patch_size, seeds):
    """Noisy subdivision-2 icospheres (one a seed) as a port or JAX set."""
    v, f = make_icosphere(2)
    cls = TrainingSet if kind == "port" else JaxTrainingSet
    ds = cls(max_patch_size=max_patch_size, coarsening_steps=2, coarsening_levels=3,
             k_faces=23, seed=0)
    for s in seeds:
        noisy = (v + np.random.default_rng(s).normal(scale=0.02, size=v.shape)).astype(np.float32)
        ds.add_mesh(noisy, f, gt_vertices=v)
    return ds


@pytest.fixture(scope="module")
def multi_set():
    """Eight patches of 112-128 faces whose K' differ per level."""
    return _sphere_set("port", 100, (3, 4))


@pytest.fixture(scope="module")
def shard_dir(multi_set, tmp_path_factory):
    out = tmp_path_factory.mktemp("shards")
    save_sharded(multi_set, str(out), patches_per_shard=3)
    return str(out)


def _cfg(tmp_path, **train):
    return default_config().replace(model=MODEL, train={
        **TRAIN, "network_path": str(tmp_path) + "/", **train})


def _summary(out: str) -> dict:
    lines = [line for line in out.splitlines() if line.startswith("streaming summary: ")]
    assert len(lines) == 1, out
    return json.loads(lines[0].split(": ", 1)[1])


def _flat(tree):
    return [(f"{layer}.{name}", tree[layer][name])
            for layer in sorted(tree) for name in sorted(tree[layer])]


# ---------------------------------------------------------------------------
# (a) the shards, both ways
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("writer", ["port", "jax"])
def test_shards_are_read_by_the_other_package(writer, tmp_path):
    """Five patches in shards of 2, written by one package and read by the
    other's ShardedDataset: every field bit for bit, the index's
    ``max_num_nodes``, and at most ``cache_shards`` shards held."""
    ds = _sphere_set(writer, 20000, range(5))
    write, read = ((save_sharded, JaxShardedDataset) if writer == "port"
                   else (jax_save_sharded, ShardedDataset))
    assert write(ds, str(tmp_path), patches_per_shard=2) == 3
    sharded = read(str(tmp_path), cache_shards=1)
    assert len(sharded) == 5
    assert sharded.max_num_nodes == max(p.num_nodes for p in ds.patches)
    for i, want in enumerate(ds.patches):
        got = sharded.patch(i)
        assert got.num_real == want.num_real
        for name in ("inputs", "gt_normals"):
            np.testing.assert_array_equal(getattr(got, name), getattr(want, name))
        assert len(got.adjs) == len(want.adjs) == 3
        for a, b in zip(got.adjs, want.adjs):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    assert len(sharded._cache) == 1
    assert isinstance(sharded._cache[2], JaxMeshDataset if writer == "port" else MeshDataset)


# ---------------------------------------------------------------------------
# (b) the loader
# ---------------------------------------------------------------------------

def test_loader_delivers_and_stops(multi_set, shard_dir):
    loader = PrefetchLoader(ShardedDataset(shard_dir), lambda p, i: (i, p.num_real), seed=1,
                            depth=2, num_items=11)
    seen = list(loader)
    assert len(seen) == 11
    for i, num_real in seen:                   # each index with its own patch
        assert multi_set.patches[i].num_real == num_real
    loader.close()
    assert not loader._thread.is_alive()


def test_loader_surfaces_errors_and_closes(shard_dir):
    def boom(_, __):
        raise ValueError("prep failed")

    loader = PrefetchLoader(ShardedDataset(shard_dir), boom, num_items=1)
    with pytest.raises(ValueError, match="prep failed"):
        next(loader)
    # a loader closed while it waits on a full queue ends its thread
    blocked = PrefetchLoader(ShardedDataset(shard_dir), lambda p, i: i, depth=1)
    next(blocked)
    blocked.close()
    assert not blocked._thread.is_alive()


@pytest.mark.parametrize("window", [None, 3])
def test_loader_order_is_the_jax_loaders(window, shard_dir):
    """For a seed, the port's loader yields the JAX loader's indices (over
    the same shards: three epochs of shuffled shards, shuffled within), by
    items and by windows, the last one shorter."""
    runs = []
    for loader_cls, sharded_cls in ((PrefetchLoader, ShardedDataset),
                                    (JaxPrefetchLoader, JaxShardedDataset)):
        loader = loader_cls(sharded_cls(shard_dir), lambda p, i: i, seed=7, num_items=23,
                            window=window)
        runs.append(list(loader))
        loader.close()
    port, jax_run = runs
    assert port == jax_run
    if window is None:
        assert sorted(port[:8]) == list(range(8))          # an epoch visits each patch once
    else:
        assert [count for _, count in port] == [3] * 7 + [2]


# ---------------------------------------------------------------------------
# (c) the trainer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("iters,eval_every,steps_per_call", [(80, 40, 1), (18, 8, 8)])
def test_streaming_training_converges_with_jax_history_shape(
        iters, eval_every, steps_per_call, multi_set, shard_dir, tmp_path, capsys):
    """The port's streaming run has JAX's history shape (a row at each
    ``it % eval_every < steps_per_call``: 2 rows, and 3 with the partial
    last window), converges over 80 steps, and writes its CSV and the final
    checkpoint; both packages train on the port's shards."""
    cfg = _cfg(tmp_path / "port", eval_every=eval_every)
    state, hist = train_normals_streaming(cfg, shard_dir, num_iterations=iters,
                                          bucket_align=64, steps_per_call=steps_per_call,
                                          device="cpu")
    jcfg = jax_default_config().replace(model=MODEL, train={
        **TRAIN, "network_path": str(tmp_path / "jax") + "/", "eval_every": eval_every})
    _, jhist = jax_train_normals_streaming(jcfg, shard_dir, num_iterations=iters,
                                           bucket_align=64, steps_per_call=steps_per_call)
    assert hist.shape == jhist.shape == ((2, 2) if steps_per_call == 1 else (3, 2))
    assert np.isfinite(hist[:, 0]).all() and np.isnan(hist[:, 1]).all()
    if iters == 80:
        assert hist[-1, 0] < hist[0, 0]
    assert state.step == iters
    assert CheckpointManager(cfg.train.network_path, cfg.train.net_name).steps() == [iters]
    rows = np.loadtxt(str(tmp_path / "port" / "net.csv"), delimiter=",", ndmin=2)
    np.testing.assert_array_equal(rows[:, 0], hist[:, 0])
    summary = _summary(capsys.readouterr().out)
    assert summary["windows"] == -(-iters // steps_per_call)
    assert summary["patches_prepared"] == len(multi_set.patches)   # each prepared once
    assert summary["captures"] == 0                                # nothing is captured here


def _window_patches(multi_set, count):
    target = max(bucket_size(p.num_nodes, 64) for p in multi_set.patches[:count])
    return [pad_patch_to(p, target) for p in multi_set.patches[:count]], target


def test_window_matches_jax_windowed_step(multi_set):
    """One window of three patches (their K' differ, padded to the running
    maxima) through the port's streaming step (WindowBuffers read by
    make_scanned_train_step) against JAX's ``make_windowed_train_step`` on
    its own prepared tables (``_patch_arrays(lane="pre")`` padded by
    ``_pad_to_dims``, as its streaming loop builds them), from the same
    parameters; each step's rotation and loss samples come from JAX's
    per-step keys (the window's ``jax.random.split(base_key, 3)``, each
    split into the rotation's and the samples' keys)."""
    patches, target = _window_patches(multi_set, 3)
    jcfg = jax_default_config().replace(model=MODEL, train=TRAIN)
    jstate, tx = jax_create_train_state(jax.random.PRNGKey(0), jcfg)
    prepared = [_patch_arrays(p, lane="pre", to_device=False) for p in patches]
    dims = [tuple(max(d) for d in zip(*col)) for col in zip(*(_leaf_dims(a) for a in prepared))]
    items = tuple(jax.tree.map(jnp.asarray, _pad_to_dims(a, dims)) for a in prepared)
    base_key = jax.random.PRNGKey(5)
    run = jax_make_windowed_train_step(jax_make_normals_train_step(tx, jcfg))
    jnext, jlosses = run(jstate, items, base_key)
    rots, samples = [], []
    for key in jax.random.split(base_key, 3):
        rot_key, samp_key = jax.random.split(key)
        rots.append(np.asarray(jax_random_rotation(rot_key)))
        samples.append(np.asarray(jax.random.randint(samp_key, (TRAIN["loss_samples"],), 0,
                                                     target)))

    cfg = default_config().replace(model=MODEL, train=TRAIN)
    state = create_train_state(cfg, device="cpu", params=params_io.params_from_jax(
        jax.tree.map(np.asarray, jstate.params), device="cpu"))
    tensors = [patch_tensors(p, "cpu") for p in patches]
    widths = {trainer._slot_dims(t) for t in tensors}
    assert len(widths) > 1                                   # the window pads slot axes
    wdims = tuple(tuple(max(w) for w in zip(*lvl)) for lvl in zip(*widths))
    buffers = WindowBuffers(3)
    assert buffers.load([trainer._pad_to_dims(t, wdims) for t in tensors])
    window = make_scanned_train_step(state, cfg, buffers, 3)
    state, losses = window(state, {"idx": torch.arange(3).reshape(3, 1),
                                   "sample_idx": torch.tensor(np.stack(samples)),
                                   "rot": torch.tensor(np.stack(rots))})
    np.testing.assert_allclose(losses.numpy(), np.asarray(jlosses), atol=2e-4)
    assert state.step == int(jnext.step) == 3
    for (name, jp), (_, t) in zip(_flat(jax.tree.map(np.asarray, jnext.params)),
                                  _flat(state.params)):
        np.testing.assert_allclose(t.detach().numpy(), jp, atol=1e-6, err_msg=name)


def test_window_buffers_keep_their_addresses(multi_set):
    """A window of the buffers' shape is written in place (a captured graph
    reads the same addresses); a shorter last window fills the first slots;
    another shape allocates them anew."""
    patches, _ = _window_patches(multi_set, 3)
    tensors = [patch_tensors(p, "cpu") for p in patches]
    dims = tuple(tuple(max(w) for w in zip(*lvl))
                 for lvl in zip(*(trainer._slot_dims(t) for t in tensors)))
    padded = [trainer._pad_to_dims(t, dims) for t in tensors]
    buffers = WindowBuffers(3)
    assert buffers.load(padded) and buffers.dims == dims
    ptr = buffers.stack.adjs[0].data_ptr()
    assert not buffers.load(padded[::-1][:2])
    assert buffers.stack.adjs[0].data_ptr() == ptr
    for slot, t in enumerate(padded[::-1][:2] + padded[2:]):
        got = buffers.select(torch.tensor([slot]))
        assert torch.equal(got[0], t[0]) and all(
            torch.equal(a, b) for a, b in zip(got[1] + got[2] + got[3], t[1] + t[2] + t[3]))
    wider = tuple((k + 1, kt) for k, kt in dims)
    assert buffers.load([trainer._pad_to_dims(t, wider) for t in padded])
    assert buffers.dims == wider and buffers.stack.adjs[0].data_ptr() != ptr


def test_windowed_path_equals_single_steps(tmp_path):
    """On a one-patch set the windowed path (7 steps at 3 a window: 3, 3,
    and a last window of 1) and single steps train on the same tables with
    the same draws: the same parameters, Adam state and checkpoints, bit for
    bit."""
    shards = tmp_path / "shards"
    save_sharded(_sphere_set("port", 20000, (3,)), str(shards))
    runs = []
    for spc in (3, 1):
        cfg = _cfg(tmp_path / f"spc{spc}", save_every=3)
        state, _ = train_normals_streaming(cfg, str(shards), num_iterations=7, bucket_align=64,
                                           steps_per_call=spc, device="cpu")
        runs.append((state, CheckpointManager(cfg.train.network_path, cfg.train.net_name)))
    (windowed, mgr_w), (single, mgr_s) = runs
    assert windowed.step == single.step == 7
    assert mgr_w.steps() == mgr_s.steps() == [3, 6, 7]
    for (name, a), (_, b) in zip(_flat(windowed.params), _flat(single.params)):
        assert torch.equal(a, b), name
    for a, b in zip(trainer._leaves(windowed.params), trainer._leaves(single.params)):
        sa, sb = windowed.optimizer.state[a], single.optimizer.state[b]
        assert all(torch.equal(sa[k], sb[k]) for k in ("step", "exp_avg", "exp_avg_sq"))


def test_width_growth_mid_run_keeps_the_results(multi_set, shard_dir, tmp_path, capsys):
    """Windows of 2 over the eight patches (one 128-node bucket at align
    64): at seed 5 a later window holds a wider patch than the first two
    windows did, so the buffers are allocated anew once (on the card the
    step's graph is captured again) and the copies made before are padded
    again when they are drawn.
    The run equals single steps with the same draws (the same patches, node
    counts and generator) up to float32 sums over slot axes of other
    lengths."""
    runs = []
    for spc in (2, 1):
        cfg = _cfg(tmp_path / f"spc{spc}", eval_every=2, seed=5)
        runs.append(train_normals_streaming(cfg, shard_dir, num_iterations=8, bucket_align=64,
                                            steps_per_call=spc, device="cpu"))
        summary = _summary(capsys.readouterr().out)
        assert summary["growths"] == (1 if spc == 2 else 0)
        assert summary["captures"] == 0
    (windowed, hist_w), (single, hist_s) = runs
    assert hist_w.shape == hist_s.shape == (4, 2)
    np.testing.assert_allclose(hist_w[:, 0], hist_s[:, 0], rtol=1e-5)
    for (name, a), (_, b) in zip(_flat(windowed.params), _flat(single.params)):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), atol=1e-5,
                                   err_msg=name)


@pytest.mark.parametrize("steps_per_call", [1, 2])
def test_device_copies_stay_bounded_past_the_memo(steps_per_call, shard_dir, tmp_path,
                                                  monkeypatch):
    """A run that draws more patches than the memo keeps (MAX_PREPARED cut
    to 3 against the eight patches, 40 steps, so that evicted patches are
    prepared and uploaded again) holds no more of the memo's copies alive at
    any window than the memo and two windows: nothing keeps a window's
    copies after its steps (on the card its device memory stays flat)."""
    monkeypatch.setattr(trainer, "MAX_PREPARED", 3)
    uploads, alive = [], []
    upload, stage = trainer._PatchMemo._upload, trainer._PatchMemo.stage

    def tracked(self, fresh):
        out, events = upload(self, fresh)
        uploads.extend(weakref.ref(tensors[0]) for tensors in out.values())
        return out, events

    def counted(self, items):
        alive.append(sum(ref() is not None for ref in uploads))
        return stage(self, items)

    monkeypatch.setattr(trainer._PatchMemo, "_upload", tracked)
    monkeypatch.setattr(trainer._PatchMemo, "stage", counted)
    train_normals_streaming(_cfg(tmp_path), shard_dir, num_iterations=40, bucket_align=64,
                            steps_per_call=steps_per_call, device="cpu")
    bound = 3 + 2 * steps_per_call
    assert len(alive) == 40 // steps_per_call
    assert len(uploads) > 2 * bound                 # the run re-uploads evicted patches
    assert max(alive) <= bound, alive


@pytest.mark.parametrize("steps_per_call", [1, 4])
def test_nan_aborts_without_a_final_save(steps_per_call, shard_dir, tmp_path, monkeypatch):
    """NaN losses from the 13th step on, a checkpoint and a row every 4
    steps, 40 iterations: the run stops at the row of steps 13-16, saves
    none of them and no final state, and the served params.pt is finite."""
    calls = []
    loss_fn = trainer.normals_loss

    def poisoned(*args, **kwargs):
        calls.append(1)
        loss = loss_fn(*args, **kwargs)
        return loss * math.nan if len(calls) > 12 else loss

    monkeypatch.setattr(trainer, "normals_loss", poisoned)
    cfg = _cfg(tmp_path, save_every=4, eval_every=4)
    state, hist = train_normals_streaming(cfg, shard_dir, num_iterations=40, bucket_align=64,
                                          steps_per_call=steps_per_call, device="cpu")
    assert len(calls) == 16
    assert hist.shape == (4, 2) and math.isnan(hist[-1, 0]) and np.isfinite(hist[:-1, 0]).all()
    mgr = CheckpointManager(cfg.train.network_path, cfg.train.net_name)
    assert mgr.steps() == [4, 8, 12]
    served = params_io.load(params_io.checkpoint_path(cfg.train.network_path, "net"), "cpu")
    assert all(torch.isfinite(t).all() for _, t in _flat(served))


def test_resume_from_the_latest_checkpoint(shard_dir, tmp_path):
    """A second run resumes from the first one's final checkpoint (step 8)
    and saves at 8 + its own steps; its first steps draw the first run's
    patches again (the loader starts from the seed)."""
    cfg = _cfg(tmp_path, save_every=4)
    first, _ = train_normals_streaming(cfg, shard_dir, num_iterations=8, bucket_align=64,
                                       device="cpu")
    saved = {name: t.detach().clone() for name, t in _flat(first.params)}
    mgr = CheckpointManager(cfg.train.network_path, cfg.train.net_name)
    assert mgr.steps() == [4, 8]
    resumed, _ = train_normals_streaming(cfg, shard_dir, num_iterations=4, bucket_align=64,
                                         device="cpu")
    assert resumed.step == 12 and mgr.steps() == [4, 8, 12]
    start, step = mgr.restore(create_train_state(cfg, device="cpu"), 8)
    assert step == 8
    for name, t in _flat(start.params):
        assert torch.equal(t, saved[name]), name
    assert any(not torch.equal(t, saved[name]) for name, t in _flat(resumed.params))
