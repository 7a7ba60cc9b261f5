"""The port's data parallelism (``parallel/data_parallel.py``) and tensor
parallelism (``parallel/tensor_parallel.py``) against the JAX package's, on
the CPU.

The port's ranks are gloo processes (``tests/torch_halo_ranks.py``); the
JAX side runs on the suite's virtual CPU devices. Patches of two noisy
``icosphere(3)`` meshes cut at 500 faces, a bank padded to 1,024 nodes;
channels 8/16/32, M = 4, fc 32; 256 loss faces.

- One DP step at D = 1, 2 and 4 against JAX ``make_dp_train_step`` on the
  same bank, patch indices and draws (each rank's rotation and loss faces
  drawn from its JAX key as JAX's step draws them, given to the port); in
  bfloat16 compute and with the rotation-invariant conv (K3's plain
  version) at D = 2. JAX's gradients come from its step with
  ``optax.sgd(1.0)`` (the update is −g). They are the SUM of the devices'
  gradients: inside ``shard_map`` the gradient of a replicated parameter is
  already summed over the devices, so the step's ``pmean`` returns that
  sum (Adam's update hides the scale). The port averages, as the ``pmean``
  means to, so its gradients are held to JAX's divided by D (ROADMAP
  queue 3). Then the scanned and the chunked runners, and
  ``train_normals_dp``'s contract at D = 2 (JAX's
  ``test_dp_driver_full_contract`` and ``test_train_normals_dp_driver``):
  both selections, validation, checkpoints and a resume, the CSV of rank 0
  alone, the NaN abort.
- Tensor parallelism at D = 2: the U-Net's three heads with the fc head
  split over the ranks equal the unsplit forward, and fc1's weight is
  really split by columns (JAX's ``test_tensor_parallel_fc_sharding``).

Tolerances: f32 loss rtol 1e-4, gradients within 3e-4 × max(1, the
gradient's largest magnitude) (JAX's
``test_sharded_grads_match_single_device`` bar, relative where the angle
loss's gradients reach ~10²), the parameters after the port's Adam step
atol 3e-4 against optax's first Adam update of JAX's gradients where |g| >
1e-6 (below it float32 noise in g sets Adam's update; both stay within lr
of the start); bfloat16 loss within 0.03 × JAX's and gradients within 0.05
of each gradient's largest magnitude (``tests/test_variant_matrix.py``);
the TP forward atol 1e-5; every rank the same bits.
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
from facet_graph_convolution_tpu.models.augment import random_rotation as jax_random_rotation
from facet_graph_convolution_tpu.models.unet import init_unet as jax_init_unet
from facet_graph_convolution_tpu.ops.conv import FacetConvVariant as JaxVariant
from facet_graph_convolution_tpu.parallel import data_parallel as jax_dp
from facet_graph_convolution_tpu.parallel.mesh import make_mesh as jax_make_mesh
from facet_graph_convolution_tpu.training.trainer import TrainState as JaxTrainState
from facet_graph_convolution_torch.config import default_config
from facet_graph_convolution_torch.models.unet import train_graph_tensors, unet_apply
from facet_graph_convolution_torch.params import params_from_jax
from facet_graph_convolution_torch.parallel import data_parallel as dp
from facet_graph_convolution_torch.parallel.mesh import GraphGroup
from facet_graph_convolution_torch.parallel.tensor_parallel import unet_param_shardings
from tests.conftest import make_icosphere
from tests.torch_halo_ranks import job_dp, run_ranks

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")

WIDTHS = {"channels": (8, 16, 32), "num_filters": 4, "fc_channels": 32}
CPU = GraphGroup(0, 1, torch.device("cpu"))
SAMPLES = 256


@pytest.fixture(scope="module")
def train_set():
    v, f = make_icosphere(3)
    rng = np.random.default_rng(3)
    ds = JaxTrainingSet(max_patch_size=500, coarsening_steps=2, coarsening_levels=3,
                        k_faces=23, seed=0)
    for noise in (0.02, 0.01):
        ds.add_mesh((v + rng.normal(scale=noise, size=v.shape)).astype(np.float32), f,
                    gt_vertices=v)
    return ds


def _cfgs(**model):
    train = {"loss_samples": SAMPLES}
    return (default_config().replace(model={**WIDTHS, **model}, train=train),
            jax_default_config().replace(model={**WIDTHS, **model}, train=train))


def _params(variant=JaxVariant.DEFAULT, multi_scale=False):
    p = jax_init_unet(jax.random.PRNGKey(0), in_channels=6, variant=variant,
                      multi_scale=multi_scale, **WIDTHS)
    return jax.tree.map(np.asarray, p)


def _draws(keys, num_nodes):
    """JAX's per-device draws of its DP step (``per_patch_loss``): the
    rotation from the first half of each key, the loss faces from the
    second."""
    rots, samples = [], []
    for k in keys:
        rot_key, samp_key = jax.random.split(k)
        rots.append(np.asarray(jax_random_rotation(rot_key)))
        samples.append(np.asarray(jax.random.randint(samp_key, (SAMPLES,), 0, num_nodes)))
    return {"rot": np.stack(rots), "sample_idx": np.stack(samples).astype(np.int64)}


def _jax_dp_step(jcfg, params, patches, idx, keys):
    """JAX's DP step with SGD at rate 1: the mean loss and the averaged
    gradients (the parameters' change, negated)."""
    mesh = jax_make_mesh((len(idx), 1), ("data", "graph"))
    tx = optax.sgd(1.0)
    p0 = jax.tree.map(jnp.asarray, params)
    step = jax_dp.make_dp_train_step(tx, jcfg, mesh)
    bank = jax.tree.map(jnp.asarray, jax_dp.build_patch_bank(patches, jcfg))
    with mesh:
        state, loss = step(JaxTrainState(p0, tx.init(p0), 0), bank,
                           jnp.asarray(idx, jnp.int32), keys)
    return float(loss), jax.tree.map(lambda a, b: np.asarray(a) - np.asarray(b), p0,
                                     state.params)


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


CASES = [("f32", 1), ("f32", 2), ("f32", 4), ("bf16", 2), ("rotinv", 2)]


@pytest.mark.parametrize("case,shards", CASES)
def test_dp_step_matches_jax(train_set, case, shards, tmp_path):
    model = {"bf16": {"compute_dtype": "bfloat16"},
             "rotinv": {"rotation_invariance": True}}.get(case, {})
    cfg, jcfg = _cfgs(**model)
    params = _params(JaxVariant.ROTATION_INVARIANT if case == "rotinv" else JaxVariant.DEFAULT)
    patches = train_set.patches
    n = dp.bank_nodes(patches, cfg)
    idx = [(3 * r + 1) % len(patches) for r in range(shards)]
    keys = jax.random.split(jax.random.PRNGKey(shards), shards)
    more_keys = jax.random.split(jax.random.PRNGKey(99), 2 * shards)
    more = _draws(more_keys, n)
    payload = {"cfg": cfg, "patches": patches, "params": params, "idx": idx,
               "draws": _draws(keys, n),
               "more": {k: v.reshape(2, shards, *v.shape[1:]) for k, v in more.items()}}
    out = ([job_dp(payload, CPU)] if shards == 1
           else run_ranks("dp", shards, payload, str(tmp_path)))
    got = out[0]
    assert got["nodes"] == n == 1024
    for other in out[1:]:
        assert other["loss"] == got["loss"]
        for layer in got["final"]:
            for name in got["final"][layer]:
                np.testing.assert_array_equal(other["final"][layer][name],
                                              got["final"][layer][name])
    assert np.isfinite(got["scanned"]).all() and np.isfinite(got["chunked"]).all()
    want_loss, want_grads = _jax_dp_step(jcfg, params, patches, idx, keys)
    want_grads = jax.tree.map(lambda g: g / shards, want_grads)
    if case == "bf16":
        assert abs(got["loss"] - want_loss) <= 0.03 * abs(want_loss)
        assert abs(got["eval"] - want_loss) <= 0.03 * abs(want_loss)
    else:
        np.testing.assert_allclose(got["loss"], want_loss, rtol=1e-4)
        np.testing.assert_allclose(got["eval"], want_loss, rtol=1e-4)
    for layer in want_grads:
        for name, g in want_grads[layer].items():
            err = np.abs(got["grads"][layer][name] - g).max()
            bound = (0.05 * max(np.abs(g).max(), 1e-3) if case == "bf16"
                     else 3e-4 * max(np.abs(g).max(), 1.0))
            assert err <= bound, (layer, name, err, bound)
    if case != "bf16":
        _assert_adam_step(got["params"], params, want_grads)


def test_stack_patches_and_bank_equal_jax(train_set):
    cfg, jcfg = _cfgs()
    got, want = dp.stack_patches(train_set.patches, 1024), jax_dp.stack_patches(
        train_set.patches, 1024)
    for a, b in zip([got[0], *got[1], got[2]], [want[0], *want[1], want[2]]):
        np.testing.assert_array_equal(a, b)
    bank = dp.build_patch_bank(train_set.patches, cfg, "cpu")
    jbank = jax_dp.build_patch_bank(train_set.patches, jcfg)
    np.testing.assert_array_equal(bank.xs.numpy(), np.asarray(jbank[0]))
    np.testing.assert_array_equal(bank.gts.numpy(), np.asarray(jbank[2]))


def test_train_normals_dp_driver(train_set, tmp_path):
    """``train_normals_dp(device="cpu")`` at D = 2: chunks of 4 by patch
    chunks with validation, checkpoints and the CSV; a resume that
    continues the step count; the per-step selection with a short last
    chunk; single steps in bfloat16 and rotation-invariant; the NaN abort
    (no final checkpoint)."""
    cfg, _ = _cfgs()
    cfg = cfg.replace(train={"network_path": str(tmp_path / "net"), "net_name": "dpnet",
                             "valid_every": 4, "save_every": 8})
    runs = [{"num_iterations": 8, "steps_per_call": 4, "checkpoint": True, "validate": True},
            {"num_iterations": 2, "checkpoint": True},
            {"num_iterations": 6, "steps_per_call": 4, "selection": "step",
             "cfg": {"train": {"network_path": str(tmp_path / "step")}}},
            {"num_iterations": 3, "log_every": 1,
             "cfg": {"model": {"compute_dtype": "bfloat16"},
                     "train": {"network_path": str(tmp_path / "bf16")}}},
            {"num_iterations": 3, "log_every": 1,
             "cfg": {"model": {"rotation_invariance": True},
                     "train": {"network_path": str(tmp_path / "rotinv")}}},
            {"num_iterations": 3, "log_every": 1, "checkpoint": True, "nan_inputs": True,
             "cfg": {"train": {"network_path": str(tmp_path / "nan")}}}]
    out = run_ranks("dp_driver", 2, {"cfg": cfg, "set": train_set, "runs": runs},
                    str(tmp_path / "ranks"))
    first, resumed, by_step, bf16, rotinv, nan = out[0]
    for a, b in zip(out[0], out[1]):
        np.testing.assert_array_equal(a["losses"], b["losses"])
    assert first["step"] == 8 and resumed["step"] == 10
    assert first["losses"].shape == (8,) and np.isfinite(first["losses"]).all()
    assert sorted(os.listdir(tmp_path / "net" / "dpnet")) == ["params.pt", "step_10.pt",
                                                              "step_8.pt"]
    hist = np.loadtxt(tmp_path / "net" / "dpnet.csv", delimiter=",")
    assert hist.shape == (2 + 1, 2)                   # 2 chunks, then 1 logged step
    assert np.isfinite(hist[:2]).all()
    assert by_step["step"] == 6 and np.isfinite(by_step["losses"]).all()
    for run in (bf16, rotinv):
        assert run["step"] == 3 and np.isfinite(run["losses"]).all()
    assert nan["losses"].shape == (1,) and not np.isfinite(nan["losses"][0])
    assert not [f for f in os.listdir(tmp_path / "nan" / "dpnet") if f.startswith("step_")]


def test_tensor_parallel_head_matches_replicated(train_set, tmp_path):
    params = _params(multi_scale=True)
    patch = train_set.patches[0]
    x = patch.inputs
    out = run_ranks("tp", 2, {"params": params, "adjs": patch.adjs, "x": x}, str(tmp_path))
    adjs, adj_ts, rows = train_graph_tensors(patch.adjs, "cpu")
    want = unet_apply(params_from_jax(params, "cpu"), torch.as_tensor(x), adjs, rows,
                      adj_ts=adj_ts, multi_scale=True)
    for r, got in enumerate(out):
        for g, w in zip(got["heads"], want):
            np.testing.assert_allclose(g, w.detach().numpy(), atol=1e-5)
        half = params["fc1"]["w"].shape[1] // 2
        np.testing.assert_array_equal(got["fc1_w"], params["fc1"]["w"][:, r * half:(r + 1) * half])
        np.testing.assert_array_equal(got["out0_w"], params["out0"]["w"][r * half:(r + 1) * half])
    axes = unet_param_shardings(params_from_jax(params, "cpu"))
    assert axes["fc1"] == {"w": 1, "b": 0} and axes["out0"] == {"w": 0, "b": None}
    assert axes["conv1"]["w"] is None


def test_launcher_dp_and_vertex_in_one_process(tmp_path, monkeypatch, capsys):
    """``parallel.launch dp`` and ``vertex`` at one CPU process (no process
    group): each prints its JSON line with finite losses."""
    import json

    from facet_graph_convolution_torch.parallel import launch

    monkeypatch.chdir(tmp_path)
    for name in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(name, raising=False)
    for argv in (["--device", "cpu", "dp", "--iterations", "2", "--subdiv", "2",
                  "--max_patch_size", "200"],
                 ["--device", "cpu", "vertex", "--iterations", "1", "--subdiv", "1",
                  "--vertex_solver", "naive"]):
        assert launch.run(argv) == 0
        line = json.loads([ln for ln in capsys.readouterr().out.splitlines()
                           if ln.startswith("{")][-1])
        assert np.isfinite([line["first_loss"], line["value"]]).all()
