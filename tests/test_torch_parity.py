"""The port's activation-parity harness (``evaluation/parity.py``,
``cli/parity.py``) against the JAX package's.

Narrow widths (channels 8/8/8, M = 3, fc 16) on a subdivision-3 icosphere
patch (1,552 nodes), float32. The JAX capture runs its row-major
``facet_conv`` on the raw K-lists; the port's runs the conv of its U-Net on
the kernel tables, the plain K1 on CPU tensors. Tolerance atol 1e-5 a layer:
the same sums in another order (measured ~1e-8).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _make_patch
from facet_graph_convolution_tpu.evaluation.parity import (
    capture_activations as jax_capture,
)
from facet_graph_convolution_tpu.evaluation.parity import (
    export_activations as jax_export,
)
from facet_graph_convolution_tpu.models.unet import init_unet as jax_init_unet
from facet_graph_convolution_torch.cli import parity as cli_parity
from facet_graph_convolution_torch.data.synthetic import add_vertex_noise, icosphere
from facet_graph_convolution_torch.evaluation.parity import (
    capture_activations,
    compare_activations,
    export_activations,
)
from facet_graph_convolution_torch.evaluation.tf_checkpoint import export_unet_to_tf
from facet_graph_convolution_torch.geometry.obj_io import write_obj
from facet_graph_convolution_torch.models.unet import graph_tensors, init_unet, unet_apply
from facet_graph_convolution_torch.params import params_from_jax

NARROW = dict(channels=(8, 8, 8), num_filters=3, fc_channels=16)
ATOL = 1e-5
LAYERS = {"input", "conv1", "conv1_act", "pool1", "conv2", "pool2", "conv3", "dconv3",
          "upsamp2", "upconv2", "dconv2", "upsamp1", "upconv1", "dconv1", "fc1", "out0"}


@pytest.fixture(scope="module")
def case():
    patch = _make_patch(subdiv=3, seed=3)
    jparams = jax_init_unet(jax.random.PRNGKey(0), **NARROW)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    return patch, jparams, params


def test_capture_matches_jax_layer_by_layer(case):
    patch, jparams, params = case
    ref = jax_capture(jparams, jnp.asarray(patch.inputs),
                      tuple(jnp.asarray(a) for a in patch.adjs))
    acts = capture_activations(params, patch.inputs, patch.adjs, device="cpu")
    assert set(acts) == set(ref) == LAYERS
    for name in ref:
        assert acts[name].shape == ref[name].shape, name
        np.testing.assert_allclose(acts[name], ref[name], atol=ATOL, rtol=0, err_msg=name)


def test_jax_export_passes_port_compare(case, tmp_path):
    patch, jparams, params = case
    a, b = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    jax_export(a, jparams, jnp.asarray(patch.inputs), tuple(jnp.asarray(x) for x in patch.adjs))
    export_activations(b, params, patch.inputs, patch.adjs, device="cpu")
    report = compare_activations(b, a, atol=ATOL)
    assert set(report) == LAYERS and max(report.values()) <= ATOL
    with np.load(b) as port, np.load(a) as ref:
        assert set(port.files) == set(ref.files)
        for i in range(3):
            np.testing.assert_array_equal(port[f"adj_{i}"], ref[f"adj_{i}"])
        np.testing.assert_array_equal(port["input_x"], ref["input_x"])


def test_capture_matches_unet(case):
    patch, _, params = case
    acts = capture_activations(params, patch.inputs, patch.adjs, device="cpu")
    adjs, rows = graph_tensors(patch.adjs, "cpu")
    with torch.no_grad():
        y = unet_apply(params, torch.as_tensor(patch.inputs), adjs, rows)
    np.testing.assert_allclose(acts["out0"], y.numpy(), atol=1e-6, rtol=0)


def test_compare_names_the_perturbed_layer(case, tmp_path):
    patch, _, params = case
    a, c = str(tmp_path / "a.npz"), str(tmp_path / "c.npz")
    export_activations(a, params, patch.inputs, patch.adjs, device="cpu")
    assert max(compare_activations(a, a).values()) == 0.0
    scaled = {layer: {k: t * 1.01 for k, t in leaves.items()} for layer, leaves in params.items()}
    export_activations(c, scaled, patch.inputs, patch.adjs, device="cpu")
    with pytest.raises(AssertionError, match="conv1"):
        compare_activations(a, c)


def test_capture_needs_a_card_unless_cpu(case, monkeypatch):
    patch, _, params = case
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        capture_activations(params, patch.inputs, patch.adjs)


def test_cli_parity_on_cpu(tmp_path, capsys):
    v, f = icosphere(2)
    mesh = str(tmp_path / "sphere_n1.obj")
    write_obj(add_vertex_noise(v, f, 0.1, np.random.default_rng(0)), f, mesh)
    ckpt = str(tmp_path / "ckpt" / "net-1")
    export_unet_to_tf(ckpt, init_unet(0, device="cpu", **NARROW))
    first, second = str(tmp_path / "a.npz"), str(tmp_path / "b.npz")
    common = ["--checkpoint", ckpt, "--mesh", mesh, "--device", "cpu"]
    assert cli_parity.main(common + ["--out", first]) == 0
    capsys.readouterr()
    assert cli_parity.main(common + ["--out", second, "--reference", first]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    report = json.loads(lines[-1])
    assert report["parity"] == "PASS" and report["max_abs_diff"] == 0.0
    assert set(report["layers"]) == LAYERS
    patch = cli_parity.parity_patch(mesh)
    with np.load(first) as acts:
        assert acts["act_out0"].shape == (patch.num_nodes, 3)
