"""The port's U-Net forward and parameter interchange against the JAX package.

Small widths (channels 8/16/32, M = 4, fc 32) on a subdivision-3 icosphere
patch, float32, with ``normalize_tensor`` applied as inference does. The
JAX side runs ``unet_apply_pallas`` with the Pallas epilogue in interpret
mode (as tests/test_pallas_conv.py does) and the row-major ``unet_apply``.
Tolerance atol 1e-4: eight convs and two dense layers of float32 rounding in
another order, on unit normals.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import facet_graph_convolution_tpu.ops.pallas_conv as pallas_conv
from __graft_entry__ import _make_patch
from facet_graph_convolution_tpu.models.unet import init_unet as jax_init_unet
from facet_graph_convolution_tpu.models.unet import unet_apply as jax_unet_apply
from facet_graph_convolution_tpu.models.unet import unet_apply_pallas
from facet_graph_convolution_tpu.ops.conv import FacetConvVariant as JaxVariant
from facet_graph_convolution_tpu.ops.normalization import (
    normalize_tensor as jax_normalize_tensor,
)
from facet_graph_convolution_tpu.training.trainer import _graph_arrays
from facet_graph_convolution_torch import params as params_io
from facet_graph_convolution_torch.models.unet import graph_tensors, init_unet, unet_apply
from facet_graph_convolution_torch.ops.conv import FacetConvVariant
from facet_graph_convolution_torch.ops.normalization import normalize_tensor

SMALL = dict(channels=(8, 16, 32), num_filters=4, fc_channels=32)


@pytest.mark.parametrize("multi_scale", [False, True])
def test_params_round_trip(tmp_path, multi_scale):
    tree = jax.tree.map(np.asarray, jax_init_unet(jax.random.PRNGKey(0), multi_scale=multi_scale,
                                                  **SMALL))
    params = params_io.params_from_jax(tree, device="cpu")
    back = params_io.params_to_numpy(params)
    assert back.keys() == tree.keys()
    for layer in tree:
        assert back[layer].keys() == tree[layer].keys()
        for name in tree[layer]:
            assert back[layer][name].dtype == np.float32
            np.testing.assert_array_equal(back[layer][name], tree[layer][name])
    path = str(tmp_path / "net" / params_io.CHECKPOINT_FILE)
    params_io.save(params, path)
    loaded = params_io.load(path, device="cpu")
    for layer in tree:
        for name in tree[layer]:
            assert torch.equal(loaded[layer][name], params[layer][name])


@pytest.mark.parametrize("multi_scale", [False, True])
def test_init_unet_layout_matches_jax(multi_scale):
    ours = init_unet(0, device="cpu", multi_scale=multi_scale, **SMALL)
    ref = jax_init_unet(jax.random.PRNGKey(0), multi_scale=multi_scale, **SMALL)
    assert ours.keys() == ref.keys()
    for layer in ref:
        assert ours[layer].keys() == ref[layer].keys()
        for name in ref[layer]:
            assert tuple(ours[layer][name].shape) == ref[layer][name].shape


@pytest.fixture(scope="module")
def patch():
    return _make_patch(subdiv=3, seed=3)


@pytest.mark.parametrize("variant", ["default", "translation_invariant"])
def test_unet_forward_matches_jax(patch, monkeypatch, variant):
    orig = pallas_conv.facet_conv_pallas
    monkeypatch.setattr(pallas_conv, "facet_conv_pallas",
                        lambda *a, **kw: orig(*a, **{**kw, "interpret": True}))
    jvar = JaxVariant(variant)
    jparams = jax_init_unet(jax.random.PRNGKey(1), variant=jvar, **SMALL)
    x = jnp.asarray(patch.inputs)

    adjs, adj_ts, mults = _graph_arrays(patch.adjs, pallas=True)
    y_pallas = jax_normalize_tensor(unet_apply_pallas(
        jparams, x, adjs, adj_ts, [mm["pallas_rows"] for mm in mults],
        coarsening_steps=2, variant=jvar))
    y_rows = jax_normalize_tensor(jax_unet_apply(
        jparams, x, tuple(jnp.asarray(a) for a in patch.adjs),
        coarsening_steps=2, variant=jvar))

    params = params_io.params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    t_adjs, t_rows = graph_tensors(patch.adjs, "cpu")
    y = normalize_tensor(unet_apply(params, torch.as_tensor(patch.inputs), t_adjs, t_rows,
                                    coarsening_steps=2, variant=FacetConvVariant(variant)))
    assert y.shape == (patch.num_nodes, 3)
    assert torch.isfinite(y).all()
    np.testing.assert_allclose(y.numpy(), np.asarray(y_pallas), atol=1e-4)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_rows), atol=1e-4)
