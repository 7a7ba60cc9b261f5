"""The port's halo-sharded path (``facet_graph_convolution_torch/parallel``)
against the JAX package's, on the CPU.

The port's ranks are processes on gloo (``tests/torch_halo_ranks.py``, no
JAX there), joined through a file under ``tmp_path``; the JAX side runs on
the suite's 8 virtual CPU devices. One noisy ``icosphere(3)`` patch, padded
so that 1, 2, 4 and 8 shards divide every level; channels 8/16/32, M = 4,
fc 32. JAX's windowed convs stay off (``WINDOWED_MIN_NODES`` raised), but
one case holds the port against JAX's unfused windowed step.

Tolerances: the partition and the exchange exactly (the cotangents are
small integers, so their sums are exact); the forward 1e-5 against JAX's
sharded forward and the port's flat ``unet_apply``; train-step losses
rtol 1e-4, the parameters after 3 Adam steps and the first step's
gradients atol 3e-4 (JAX's ``test_sharded_grads_match_single_device``);
bfloat16 steps' losses within 0.03 × JAX's and gradients within 0.05 × the
largest of each (``tests/test_variant_matrix.py``); ``remat`` bit for
bit.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facet_graph_convolution_tpu.config import default_config as jax_default_config
from facet_graph_convolution_tpu.data.dataset import TrainingSet as JaxTrainingSet
from facet_graph_convolution_tpu.data.dataset import bucket_size, pad_patch_to
from facet_graph_convolution_tpu.models.augment import random_rotation as jax_random_rotation
from facet_graph_convolution_tpu.models.unet import init_unet as jax_init_unet
from facet_graph_convolution_tpu.ops.conv import FacetConvVariant as JaxVariant
from facet_graph_convolution_tpu.parallel import halo as jax_halo
from facet_graph_convolution_tpu.parallel.mesh import make_mesh as jax_make_mesh
from facet_graph_convolution_tpu.training.trainer import (
    create_train_state as jax_create_train_state,
)
from facet_graph_convolution_torch.config import default_config
from facet_graph_convolution_torch.models.unet import train_graph_tensors, unet_apply
from facet_graph_convolution_torch.ops.conv import FacetConvVariant
from facet_graph_convolution_torch.ops.normalization import normalize_tensor
from facet_graph_convolution_torch.params import params_from_jax
from facet_graph_convolution_torch.parallel import halo
from facet_graph_convolution_torch.parallel.mesh import GraphGroup
from tests.conftest import make_icosphere
from tests.torch_halo_ranks import job_train, run_ranks

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")

WIDTHS = {"channels": (8, 16, 32), "num_filters": 4, "fc_channels": 32}
CPU = GraphGroup(0, 1, torch.device("cpu"))
PARTITIONS = {"auto": {}, "rings": {"exchange": "rings"}, "a2a": {"exchange": "a2a"},
              "hosts2": {"devices_per_host": 2}}


@pytest.fixture(scope="module")
def patch():
    v, f = make_icosphere(3)
    noisy = (v + np.random.default_rng(3).normal(scale=0.02, size=v.shape)).astype(np.float32)
    ds = JaxTrainingSet(max_patch_size=10**9, coarsening_steps=2, coarsening_levels=3,
                        k_faces=23, seed=0)
    ds.add_mesh(noisy, f, gt_vertices=v)
    return pad_patch_to(ds.patches[0], bucket_size(ds.patches[0].num_nodes, 16 * 8))


@pytest.fixture(scope="module")
def jax_params():
    out = {}
    for variant in (JaxVariant.DEFAULT, JaxVariant.ROTATION_INVARIANT):
        p = jax_init_unet(jax.random.PRNGKey(0), in_channels=6, variant=variant, **WIDTHS)
        out[variant.value] = jax.tree.map(np.asarray, p)
    return out


@pytest.fixture
def no_windows(monkeypatch):
    monkeypatch.setattr(jax_halo, "WINDOWED_MIN_NODES", 10**9)


def _adjs(patch):
    return [np.asarray(a) for a in patch.adjs]


@pytest.mark.parametrize("mode", sorted(PARTITIONS))
@pytest.mark.parametrize("shards", [1, 2, 4, 8])
def test_build_partition_equals_jax(patch, shards, mode):
    """Every table of every level, array for array and dtype for dtype."""
    got = halo.build_partition(_adjs(patch), shards, **PARTITIONS[mode])
    want = jax_halo.build_partition(_adjs(patch), shards, **PARTITIONS[mode])
    assert got.num_shards == want.num_shards
    for a, b in zip(got.levels, want.levels):
        for name in ("num_nodes", "block", "offsets", "halo_size", "cross_halo"):
            assert getattr(a, name) == getattr(b, name), name
        for name in ("local_adj", "local_adj_t", "lane_adj", "lane_adj_t", "send_idx",
                     "recv_mask", "mult", "self_mult", "cross_send", "cross_mask"):
            x, y = getattr(a, name), getattr(b, name)
            if y is None:
                assert x is None, name
                continue
            assert x.dtype == y.dtype, name
            np.testing.assert_array_equal(x, y, err_msg=name)
        assert halo.level_geometry(a) == halo.LevelGeometry(*jax_halo.level_geometry(b).__dict__
                                                            .values())


@pytest.mark.parametrize("shards,mode", [(2, "rings"), (4, "rings"), (4, "auto"),
                                         (4, "hosts2")])
def test_halo_exchange_and_backward(patch, shards, mode, tmp_path):
    """The extended rows equal a gather from the whole graph (zeros in
    inactive slots), and the backward equals the gather's adjoint summed
    over every rank's cotangents, exactly."""
    rng = np.random.default_rng(shards)
    adjs = _adjs(patch)
    part = halo.build_partition(adjs, shards, **PARTITIONS[mode])
    if mode == "rings":
        assert all(lvl.offsets for lvl in part.levels)
    else:
        assert part.fine.cross_send is not None
    xs = [rng.normal(size=(a.shape[0], 5)).astype(np.float32) for a in adjs]
    gs = [[rng.integers(-4, 5, size=(halo.extended_rows(part, lvl, r).shape[0], 5))
           .astype(np.float32) for lvl in range(3)] for r in range(shards)]
    out = run_ranks("exchange", shards, {"adjs": adjs, "partition": PARTITIONS[mode],
                                         "xs": xs, "gs": gs}, str(tmp_path))
    for lvl in range(3):
        n = part.levels[lvl].block
        dx = np.zeros_like(xs[lvl])
        for r in range(shards):
            ids = halo.extended_rows(part, lvl, r)
            want = np.where(ids[:, None] >= 0, xs[lvl][np.maximum(ids, 0)], 0.0)
            ext, grad = out[r][lvl]
            np.testing.assert_array_equal(ext, want)
            np.add.at(dx, ids[ids >= 0], gs[r][lvl][ids >= 0])
        for r in range(shards):
            np.testing.assert_array_equal(out[r][lvl][1], dx[r * n:(r + 1) * n])


def _jax_forward(params, x, part, shards, variant):
    mesh = jax_make_mesh((1, shards), ("data", "graph"))
    with mesh:
        return np.asarray(jax.jit(lambda p, xx: jax_halo.sharded_unet_apply(
            p, xx, part, mesh, variant=variant))(params, jnp.asarray(x)))


@pytest.mark.parametrize("shards", [1, 2, 4])
def test_sharded_forward_matches_jax_and_flat(patch, jax_params, shards, no_windows,
                                              tmp_path):
    """Both variants (default; rotation-invariant conv1 through K3's plain
    version) against JAX's sharded forward and the port's flat U-Net."""
    adjs = _adjs(patch)
    if shards == 1:
        part = halo.build_partition(adjs, 1)
        got = {name: halo.sharded_unet_apply(params_from_jax(p, "cpu"), patch.inputs, part,
                                             CPU, variant=name).numpy()
               for name, p in jax_params.items()}
    else:
        got = run_ranks("forward", shards, {"adjs": adjs, "x": patch.inputs,
                                            "params": jax_params}, str(tmp_path))
        for other in got[1:]:
            for name in jax_params:
                np.testing.assert_array_equal(other[name], got[0][name])
        got = got[0]
    jpart = jax_halo.build_partition(adjs, shards)
    tables = train_graph_tensors(adjs, "cpu")
    for name, params in jax_params.items():
        want = _jax_forward(params, patch.inputs, jpart, shards, JaxVariant(name))
        np.testing.assert_allclose(got[name], want, atol=1e-5, err_msg=name)
        flat = normalize_tensor(unet_apply(params_from_jax(params, "cpu"),
                                           torch.as_tensor(patch.inputs), tables[0], tables[2],
                                           variant=FacetConvVariant(name)))
        np.testing.assert_allclose(got[name], flat.numpy(), atol=1e-5, err_msg=name)


def _cfgs(**model):
    port = default_config().replace(model={**WIDTHS, **model}, train={"loss_samples": 512})
    jcfg = jax_default_config().replace(model={**WIDTHS, **model}, train={"loss_samples": 512})
    return port, jcfg


def _draws(patch, steps=3):
    rng = np.random.default_rng(7)
    n = patch.num_nodes
    masks = []
    for _ in range(steps):
        m = np.zeros(n, np.float32)
        m[rng.integers(0, n, size=512)] = 1.0
        masks.append(m)
    keys = [jax.random.PRNGKey(11 + i) for i in range(steps)]
    rots = [np.asarray(jax_random_rotation(k)) for k in keys]
    return keys, rots, masks


def _jax_grads(jcfg, params, patch, shards, key, mask):
    """JAX's gradients of one sharded step (its ``loss_and_grads``)."""
    from functools import partial

    from jax.sharding import PartitionSpec as P

    from facet_graph_convolution_tpu.models.augment import rotate_inputs, rotate_vec3

    mesh = jax_make_mesh((1, shards), ("data", "graph"))
    part = jax_halo.build_partition(_adjs(patch), shards)
    operands = jax_halo.partition_operands_nminor(part)
    offsets = tuple(lvl.offsets for lvl in part.levels)
    dtype = jnp.bfloat16 if jcfg.model.compute_dtype == "bfloat16" else None
    rot = jax_random_rotation(key)
    spec = P("graph")

    @partial(jax.shard_map, mesh=mesh, out_specs=P(),
             in_specs=(P(), spec, spec, spec, jax.tree.map(lambda _: spec, operands)))
    def grads(params, x_b, gt_b, m_b, level_ops):
        level_ops = jax.tree.map(lambda a: a[0], level_ops)
        x_b, gt_b = rotate_inputs(rot, x_b), rotate_vec3(rot, gt_b)

        def loss_fn(p):
            y = jax_halo.sharded_unet_forward_local_nminor(
                p, x_b, level_ops, offsets, "graph", coarsening_steps=2, compute_dtype=dtype)
            y = jax_halo._sharded_normalize_tensor(y, "graph")
            return jax_halo._sharded_face_normals_loss(y, gt_b, m_b, "graph")

        return jax.lax.pmean(jax.grad(loss_fn)(params), "graph")

    with mesh:
        g = jax.jit(grads)(jax.tree.map(jnp.asarray, params), jnp.asarray(patch.inputs),
                           jnp.asarray(patch.gt_normals), jnp.asarray(mask), operands)
    return jax.tree.map(np.asarray, g)


def _assert_grads_close(got, want, atol=None, rel=None):
    for layer in want:
        for name in want[layer]:
            a, b = got[layer][name], want[layer][name]
            bound = atol if atol is not None else rel * max(np.abs(b).max(), 1e-3)
            assert np.abs(a - b).max() <= bound, (layer, name, np.abs(a - b).max(), bound)


def _jax_steps(jcfg, params, patch, shards, keys, masks):
    mesh = jax_make_mesh((1, shards), ("data", "graph"))
    part = jax_halo.build_partition(_adjs(patch), shards)
    state, tx = jax_create_train_state(jax.random.PRNGKey(0), jcfg)
    state = state._replace(params=jax.tree.map(jnp.asarray, params)) if hasattr(
        state, "_replace") else type(state)(jax.tree.map(jnp.asarray, params),
                                            tx.init(jax.tree.map(jnp.asarray, params)),
                                            state.step)
    step = jax_halo.make_sharded_train_step(tx, jcfg, part, mesh)
    x, gt = jnp.asarray(patch.inputs), jnp.asarray(patch.gt_normals)
    losses = []
    with mesh:
        for key, m in zip(keys, masks):
            state, loss = step(state, x, gt, jnp.asarray(m), key)
            losses.append(float(loss))
    return losses, jax.tree.map(np.asarray, state.params)


def _train_payload(patch, params, cfgs, rots, masks):
    return {"adjs": _adjs(patch), "x": patch.inputs, "gt": patch.gt_normals,
            "params": params, "cfgs": cfgs, "rots": rots, "masks": masks}


def _assert_params_close(got, want, p0, atol=None, rel=None):
    for layer in want:
        for name in want[layer]:
            a, b = got[layer][name], np.asarray(want[layer][name])
            if atol is not None:
                np.testing.assert_allclose(a, b, atol=atol, err_msg=f"{layer}.{name}")
            else:
                delta = np.abs(b - p0[layer][name]).max()
                assert np.abs(a - b).max() <= rel * max(delta, 1e-6), (layer, name)


@pytest.mark.parametrize("shards", [1, 2, 4])
def test_sharded_train_steps_match_jax(patch, jax_params, shards, no_windows, tmp_path):
    """Three steps from the same parameters on JAX's rotations and masks:
    the global losses and the parameters, equal on every rank."""
    cfg, jcfg = _cfgs()
    keys, rots, masks = _draws(patch)
    params = jax_params["default"]
    payload = _train_payload(patch, params, {"f32": cfg}, rots, masks)
    out = ([job_train(payload, CPU)] if shards == 1
           else run_ranks("train", shards, payload, str(tmp_path)))
    for other in out[1:]:
        assert other["f32"]["losses"] == out[0]["f32"]["losses"]
        _assert_params_close(other["f32"]["params"], out[0]["f32"]["params"], None, atol=0)
    want_losses, want_params = _jax_steps(jcfg, params, patch, shards, keys, masks)
    np.testing.assert_allclose(out[0]["f32"]["losses"], want_losses, rtol=1e-4)
    _assert_params_close(out[0]["f32"]["params"], want_params, params, atol=3e-4)
    _assert_grads_close(out[0]["f32"]["grads"][0],
                        _jax_grads(jcfg, params, patch, shards, keys[0], masks[0]), atol=3e-4)


def test_sharded_steps_match_jax_unfused_windowed(patch, jax_params, monkeypatch, tmp_path):
    """JAX's unfused windowed step (windows forced on at 64 nodes) and the
    port's step, three steps at D = 2."""
    monkeypatch.setattr(jax_halo, "_WINDOWED_FUSED", False)
    monkeypatch.setattr(jax_halo, "WINDOWED_MIN_NODES", 64)
    monkeypatch.setattr(jax_halo, "WINDOWED_BLOCK", 128)
    assert jax_halo.build_level_windows(jax_halo.build_partition(_adjs(patch), 2))[0] is not None
    cfg, jcfg = _cfgs()
    keys, rots, masks = _draws(patch)
    params = jax_params["default"]
    out = run_ranks("train", 2, _train_payload(patch, params, {"f32": cfg}, rots, masks),
                    str(tmp_path))
    want_losses, want_params = _jax_steps(jcfg, params, patch, 2, keys, masks)
    np.testing.assert_allclose(out[0]["f32"]["losses"], want_losses, rtol=1e-4)
    _assert_params_close(out[0]["f32"]["params"], want_params, params, atol=3e-4)


def test_bf16_and_remat_sharded_steps(patch, jax_params, no_windows, tmp_path):
    """At D = 2: bfloat16 steps against JAX's bfloat16 sharded steps (the
    losses within 0.03 × JAX's, the first step's gradients within 0.05 × the
    largest of each), and ``remat`` equal to the plain step bit for bit in
    float32 and bfloat16."""
    cfg, _ = _cfgs()
    cfg16, jcfg16 = _cfgs(compute_dtype="bfloat16")
    keys, rots, masks = _draws(patch)
    params = jax_params["default"]
    out = run_ranks("train", 2, _train_payload(
        patch, params, {"f32": cfg, "f32_remat": cfg, "bf16": cfg16, "bf16_remat": cfg16},
        rots, masks), str(tmp_path))[0]
    for name in ("f32", "bf16"):
        assert out[name]["losses"] == out[name + "_remat"]["losses"]
        _assert_params_close(out[name + "_remat"]["params"], out[name]["params"], None, atol=0)
        for a, b in zip(out[name + "_remat"]["grads"], out[name]["grads"]):
            _assert_grads_close(a, b, atol=0)
    want_losses, _ = _jax_steps(jcfg16, params, patch, 2, keys, masks)
    got = np.asarray(out["bf16"]["losses"])
    assert np.all(np.abs(got - want_losses) <= 0.03 * np.abs(want_losses))
    _assert_grads_close(out["bf16"]["grads"][0],
                        _jax_grads(jcfg16, params, patch, 2, keys[0], masks[0]), rel=0.05)


def test_rotation_invariant_sharded_steps_match_flat(patch, jax_params, tmp_path):
    """The rotation-invariant step at D = 2 (conv1's raw features exchanged,
    K3's plain version) against the port's flat step on the same draws."""
    from facet_graph_convolution_torch.training.trainer import (
        create_train_state,
        make_normals_train_step,
    )

    cfg, _ = _cfgs()
    cfg = cfg.replace(model={"rotation_invariance": True})
    _, rots, masks = _draws(patch)
    params = jax_params["rotation_invariant"]
    out = run_ranks("train", 2, _train_payload(patch, params, {"f32": cfg}, rots, masks),
                    str(tmp_path))[0]["f32"]
    state = create_train_state(cfg, device="cpu", params=params_from_jax(params, "cpu"))
    step = make_normals_train_step(cfg)
    x, gt = torch.as_tensor(patch.inputs), torch.as_tensor(patch.gt_normals)
    adjs, adj_ts, rows = train_graph_tensors(_adjs(patch), "cpu")
    losses = []
    for rot, m in zip(rots, masks):
        state, loss = step(state, x, adjs, adj_ts, rows, gt, rot=torch.tensor(rot),
                           sample_idx=torch.as_tensor(np.flatnonzero(m)))
        losses.append(float(loss))
    np.testing.assert_allclose(out["losses"], losses, rtol=1e-4)
    _assert_params_close(out["params"], {k: {n: t.detach().numpy() for n, t in v.items()}
                                         for k, v in state.params.items()}, params, atol=3e-4)


def test_train_normals_sharded_driver(patch, tmp_path):
    """``train_normals_sharded(device="cpu")`` at D = 2: the validation
    sweep's column, the CSV written by rank 0 alone, checkpoints and a
    resume that continues the step count, and the NaN abort (no final
    checkpoint)."""
    cfg = default_config().replace(
        model=WIDTHS, train={"loss_samples": 256, "save_every": 4,
                             "network_path": str(tmp_path / "net")})
    runs = [{"num_iterations": 6, "checkpoint": True, "log_every": 2, "validate": True},
            {"num_iterations": 2, "checkpoint": True, "log_every": 1},
            {"num_iterations": 3, "checkpoint": True, "log_every": 1, "nan_inputs": True,
             "cfg": {"train": {"network_path": str(tmp_path / "nan")}}}]
    out = run_ranks("driver", 2, {"cfg": cfg, "patch": patch, "runs": runs},
                    str(tmp_path / "ranks"))
    first, resumed, nan = out[0]
    assert first["step"] == 6 and resumed["step"] == 8
    assert np.isfinite(first["losses"]).all() and first["losses"].shape == (6,)
    np.testing.assert_array_equal(out[1][0]["losses"], first["losses"])
    steps = sorted(os.listdir(tmp_path / "net" / cfg.train.net_name))
    assert steps == ["params.pt", "step_4.pt", "step_6.pt", "step_8.pt"]
    hist = np.loadtxt(tmp_path / "net" / (cfg.train.net_name + ".csv"), delimiter=",")
    assert hist.shape == (3 + 2, 2)                   # rank 0's rows only
    assert np.isfinite(hist[:3]).all() and np.isnan(hist[3:, 1]).all()   # validated run first
    assert not np.isfinite(nan["losses"][-1])
    assert nan["losses"].shape == (1,)
    assert not [f for f in os.listdir(tmp_path / "nan" / cfg.train.net_name)
                if f.startswith("step_")]


@pytest.mark.parametrize("local_rank,card", [(None, 1), ("0", 0)])
def test_initialize_and_make_mesh_pick_one_card(monkeypatch, local_rank, card):
    """Rank 1 of 2 on a host of 2 cards (mocked): the card that
    ``initialize`` selects before NCCL starts is the card that
    ``make_mesh`` places the rank's tensors on, with JAX's launcher flags
    (no ``LOCAL_RANK``) as under torchrun (``LOCAL_RANK`` set)."""
    from facet_graph_convolution_torch.parallel import distributed, mesh

    for name in ("LOCAL_RANK", "WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(name, raising=False)
    if local_rank is not None:
        monkeypatch.setenv("LOCAL_RANK", local_rank)
    selected = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "set_device", selected.append)
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: False)
    monkeypatch.setattr(torch.distributed, "init_process_group", lambda *a, **kw: None)
    assert distributed.initialize("127.0.0.1:1", num_processes=2, process_id=1) == (1, 2)
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_rank", lambda group=None: 1)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda group=None: 2)
    monkeypatch.setattr(torch.distributed, "get_backend", lambda group=None: "nccl")
    group = mesh.make_mesh("cuda")
    assert selected == [card]
    assert (group.rank, group.size, group.device) == (1, 2, torch.device("cuda", card))
