"""The port's public API against the JAX package's, on the CPU.

- Each subpackage's ``__init__`` re-exports the names that its JAX
  namesake's does, and no others, except the named lists: JAX-only entry
  points (``ops.JAX_ONLY``, and ``parallel.JAX_ONLY``: the node-minor forms
  of names the port has in its one layout), the multi-scale sharded
  inference that waits for the sharded multi-scale solver
  (``inference.NOT_YET_PORTED``) and the parallel entry points of later
  slices (``parallel.NOT_YET_PORTED``). JAX's ``distributed`` helpers that
  ``torch.distributed`` has no use for are named, with a reason, in
  ``parallel.distributed.NO_COUNTERPART``.
- The four host functions that the port lacked (``vertex_adjacency_klist``,
  ``permute_data``, ``klist_degrees``, ``klist_to_coo``) equal JAX's bit for
  bit on ``tests/test_graph.py``'s fixtures.
- ``init_facet_conv`` / ``init_linear`` give JAX's parameter names, shapes
  and dtypes for each variant, and ``init_unet``, which calls them, gives
  the same bits as its closures did before they were lifted into
  ``ops/conv.py``.
- ``ops.gather_slot_major`` (the port's ``gather_slots``) gives JAX's
  values exactly and its gradients within float32 reordering.
"""

import ast
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facet_graph_convolution_tpu.geometry import triangle_barycenters as jax_barycenters
from facet_graph_convolution_tpu.graph import coarsen_graph as jax_coarsen_graph
from facet_graph_convolution_tpu.graph import face_adjacency_klist as jax_face_adjacency_klist
from facet_graph_convolution_tpu.graph import klist_degrees as jax_klist_degrees
from facet_graph_convolution_tpu.graph import klist_to_coo as jax_klist_to_coo
from facet_graph_convolution_tpu.graph import (
    klist_to_coo_normal_weighted as jax_klist_to_coo_normal_weighted,
)
from facet_graph_convolution_tpu.graph import permute_data as jax_permute_data
from facet_graph_convolution_tpu.graph import vertex_adjacency_klist as jax_vertex_adjacency_klist
from facet_graph_convolution_tpu.geometry import compute_face_normals as jax_face_normals
from facet_graph_convolution_tpu.ops import gather_slot_major as jax_gather_slot_major
from facet_graph_convolution_tpu.ops import init_facet_conv as jax_init_facet_conv
from facet_graph_convolution_tpu.ops import init_linear as jax_init_linear
from facet_graph_convolution_tpu.ops.conv import FacetConvVariant as JaxVariant
import facet_graph_convolution_torch
from facet_graph_convolution_torch import graph, inference, ops, parallel
from facet_graph_convolution_torch.graph.convert import transpose_adjacency
from facet_graph_convolution_torch.models.unet import init_unet
from facet_graph_convolution_torch.ops.conv import FacetConvVariant, per_conv_variants

SUBPACKAGES = ("", "data", "evaluation", "geometry", "graph", "inference", "models", "ops",
               "parallel", "training", "utils")
# JAX re-exports per subpackage (the counts its __init__ files list)
JAX_COUNTS = {"": 2, "data": 11, "evaluation": 12, "geometry": 34, "graph": 18,
              "inference": 8, "models": 10, "ops": 29, "parallel": 20, "training": 7,
              "utils": 5}
LEFT_OUT = {"ops": set(ops.JAX_ONLY), "inference": set(inference.NOT_YET_PORTED),
            "parallel": set(parallel.JAX_ONLY) | set(parallel.NOT_YET_PORTED)}


def _module(package, sub):
    return importlib.import_module(package + ("." + sub if sub else ""))


def _reexports(module):
    """The names a package's ``__init__`` imports from its modules."""
    with open(module.__file__) as fh:
        tree = ast.parse(fh.read())
    return {alias.asname or alias.name for node in tree.body
            if isinstance(node, ast.ImportFrom) for alias in node.names}


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_port_reexports_the_jax_names(sub):
    """The port's ``__init__`` re-exports exactly JAX's names less the named
    lists."""
    want = _reexports(_module("facet_graph_convolution_tpu", sub))
    assert len(want) == JAX_COUNTS[sub]
    port = _module("facet_graph_convolution_torch", sub)
    left_out = LEFT_OUT.get(sub, set())
    assert left_out <= want
    # inference re-exports lazily (its __all__), the others by imports
    assert set(getattr(port, "__all__", None) or _reexports(port)) == want - left_out
    for name in want - left_out:
        assert hasattr(port, name), name
    assert not any(hasattr(port, name) for name in left_out)



def test_parallel_names_without_a_counterpart_exist_in_jax():
    """Each JAX ``parallel.distributed`` function that the port leaves out
    exists there, has a reason, and is absent from the port's module, whose
    own entry points (``initialize``, ``devices_per_host``) are present."""
    from facet_graph_convolution_torch.parallel import distributed
    from facet_graph_convolution_tpu.parallel import distributed as jax_distributed

    assert set(distributed.NO_COUNTERPART) == {"make_multihost_mesh", "distribute", "replicate"}
    for name, reason in distributed.NO_COUNTERPART.items():
        assert callable(getattr(jax_distributed, name)) and reason
        assert not hasattr(distributed, name)
    for name in ("initialize", "devices_per_host"):
        assert callable(getattr(jax_distributed, name)) and callable(getattr(distributed, name))

def test_the_jax_import_forms_work_in_the_port():
    from facet_graph_convolution_torch.geometry import compute_face_normals
    from facet_graph_convolution_torch.geometry.mesh_math import compute_face_normals as defined

    assert compute_face_normals is defined
    from facet_graph_convolution_torch.inference import load_forward
    from facet_graph_convolution_torch.inference.exported import load_forward as exported

    assert load_forward is exported
    # ops.facet_conv is the conv, as in JAX; the K1/K2 wrappers' module is
    # ops.facet_conv_kernel
    from facet_graph_convolution_torch.ops import facet_conv, facet_conv_kernel
    from facet_graph_convolution_torch.ops.conv import facet_conv as conv

    assert facet_conv is conv and callable(facet_conv_kernel.facet_conv_fwd)
    assert facet_graph_convolution_torch.Config is facet_graph_convolution_torch.config.Config
    assert facet_graph_convolution_torch.default_config().model.channels == (32, 64, 128)


@pytest.mark.parametrize("mesh", ["cube", "icosphere"])
def test_graph_functions_equal_jax(mesh, request, rng):
    """On ``tests/test_graph.py``'s fixtures, bit for bit: the vertex
    K-list, the K-list degrees, the position-weighted COO and the tree-order
    permutation of face signals (JAX's coarsening's indices)."""
    v, f = request.getfixturevalue(mesh)
    for k in (23, 4):
        got = graph.vertex_adjacency_klist(v, f, k)
        want = jax_vertex_adjacency_klist(v, f, k)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    adj = jax_face_adjacency_klist(f, 23)
    got, want = graph.klist_degrees(adj), jax_klist_degrees(adj)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    pos = jax_barycenters(v, f)
    got, want = graph.klist_to_coo(adj, pos), jax_klist_to_coo(adj, pos)
    assert got.shape == want.shape and got.dtype == want.dtype
    for name in ("row", "col", "data"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))
    normals = jax_face_normals(v, f)
    _, new_to_old = jax_coarsen_graph(jax_klist_to_coo_normal_weighted(adj, pos, normals), 2,
                                      rng=rng)
    got, want = graph.permute_data(normals, new_to_old), jax_permute_data(normals, new_to_old)
    assert got.shape == want.shape == (len(new_to_old), 3) and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    assert graph.permute_data(normals, None) is normals


@pytest.mark.parametrize("variant", list(FacetConvVariant))
def test_inits_have_jax_names_shapes_and_dtypes(variant):
    jax_params = jax_init_facet_conv(jax.random.PRNGKey(0), 6, 8, 4, JaxVariant(variant.value))
    params = ops.init_facet_conv(6, 8, 4, variant, seed=0, device="cpu")
    assert sorted(params) == sorted(jax_params)
    for name, t in params.items():
        assert tuple(t.shape) == jax_params[name].shape, name
        assert np.dtype(str(t.dtype).removeprefix("torch.")) == jax_params[name].dtype, name
    jax_lin = jax_init_linear(jax.random.PRNGKey(0), 6, 8)
    lin = ops.init_linear(6, 8, seed=0, device="cpu")
    assert {n: tuple(t.shape) for n, t in lin.items()} == {n: a.shape for n, a in jax_lin.items()}
    # a generator goes on drawing where the caller left it; a seed starts anew
    gen = np.random.default_rng(3)
    a = ops.init_linear(6, 8, seed=gen, device="cpu")
    b = ops.init_linear(6, 8, seed=gen, device="cpu")
    assert not torch.equal(a["w"], b["w"])
    assert torch.equal(a["w"], ops.init_linear(6, 8, seed=3, device="cpu")["w"])


def _init_unet_before_the_lift(seed, in_channels, channels, num_filters, fc_channels,
                               out_channels, multi_scale, std_dev, std_dev_bias, variant):
    """``init_unet`` as it was with its closures: one numpy generator,
    every conv's w, b, u, c (and v under the default variant), every linear
    layer's w, b, in the network's order."""
    rng = np.random.default_rng(seed)
    c0, c1, c2 = channels
    v_first, v_rest = per_conv_variants(variant)

    def normal(shape, std):
        return torch.as_tensor(rng.normal(size=shape).astype(np.float32) * np.float32(std))

    def conv(cin, cout, var=v_rest):
        p = {"w": normal((num_filters, cout, cin), std_dev), "b": normal((cout,), std_dev_bias),
             "u": normal((num_filters, cin), std_dev), "c": normal((num_filters,), std_dev)}
        if var == FacetConvVariant.DEFAULT:
            p["v"] = normal((num_filters, cin), std_dev)
        return p

    def lin(cin, cout):
        return {"w": normal((cin, cout), std_dev), "b": normal((cout,), std_dev_bias)}

    params = {"conv1": conv(in_channels, c0, v_first), "conv2": conv(c0, c1),
              "conv3": conv(c1, c2), "dconv3": conv(c2, c2), "upconv2": conv(c2, c1),
              "dconv2": conv(2 * c1, c1), "upconv1": conv(c1, c0), "dconv1": conv(2 * c0, c0),
              "fc1": lin(c0, fc_channels), "out0": lin(fc_channels, out_channels)}
    if multi_scale:
        params["fc_mid"] = lin(c1, fc_channels)
        params["out1"] = lin(fc_channels, out_channels)
        params["fc_coarse"] = lin(c2, fc_channels)
        params["out2"] = lin(fc_channels, out_channels)
    return params


@pytest.mark.parametrize("multi_scale", [False, True])
@pytest.mark.parametrize("variant", list(FacetConvVariant))
def test_init_unet_keeps_its_bits(variant, multi_scale):
    kw = dict(seed=7, in_channels=6, channels=(8, 16, 32), num_filters=4, fc_channels=64,
              out_channels=3, multi_scale=multi_scale, std_dev=0.05, std_dev_bias=0.01,
              variant=variant)
    got = init_unet(**kw, device="cpu")
    want = _init_unet_before_the_lift(**kw)
    assert sorted(got) == sorted(want)
    for layer in want:
        assert sorted(got[layer]) == sorted(want[layer]), layer
        for name, t in want[layer].items():
            assert torch.equal(got[layer][name], t), (layer, name)


def test_gather_slot_major_equals_jax():
    """Values exactly; the scatter-free backward's gradients within float32
    sums of the same terms in another order (rtol 1e-6)."""
    rng = np.random.default_rng(0)
    n, k, w = 16, 5, 3
    adj = rng.integers(0, n + 1, size=(k, n)).astype(np.int32)
    adj_t = transpose_adjacency(adj, num_targets=n)
    cat = rng.normal(size=(n, w)).astype(np.float32)
    g = rng.normal(size=(k, n, w)).astype(np.float32)
    want, vjp = jax.vjp(lambda c: jax_gather_slot_major(c, jnp.asarray(adj), jnp.asarray(adj_t)),
                        jnp.asarray(cat))
    x = torch.tensor(cat, requires_grad=True)
    got = ops.gather_slot_major(x, torch.as_tensor(adj), torch.as_tensor(adj_t))
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    got.backward(torch.as_tensor(g))
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(vjp(jnp.asarray(g))[0]), rtol=1e-6,
                               atol=1e-6)
