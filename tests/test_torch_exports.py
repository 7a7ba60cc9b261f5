"""The port's public API against the JAX package's, on the CPU.

- Each subpackage's ``__init__`` re-exports the names that its JAX
  namesake's does, and no others, except the named lists: JAX-only entry
  points (``ops.JAX_ONLY``, and ``parallel.JAX_ONLY``: the node-minor forms
  of names the port has in its one layout; ``utils.JAX_ONLY``: JAX's
  profiling helpers, which the port's tracer replaces).
  ``parallel.NOT_YET_PORTED`` and
  ``inference.NOT_YET_PORTED`` are empty. Every public function and class
  of each JAX ``parallel/`` and ``inference/`` module resolves in the
  port's module of the same name, but those lists and the named ones
  without a counterpart: JAX's ``distributed`` helpers that
  ``torch.distributed`` has no use for
  (``parallel.distributed.NO_COUNTERPART``), each with a reason;
  ``parallel.halo.NO_COUNTERPART`` is empty (the windowed conv is ported).
- Every public function and class of each JAX ``ops/``, ``graph/`` and
  ``training/`` module resolves in the port's module of the same name (or,
  for the Pallas modules, in the modules that hold their counterparts),
  but the names of :data:`NO_PORT`, each with its reason, which exist in
  JAX and nowhere in the port's modules.
- The four host functions that the port lacked (``vertex_adjacency_klist``,
  ``permute_data``, ``klist_degrees``, ``klist_to_coo``) equal JAX's bit for
  bit on ``tests/test_graph.py``'s fixtures.
- ``init_facet_conv`` / ``init_linear`` give JAX's parameter names, shapes
  and dtypes for each variant, and ``init_unet``, which calls them, gives
  the same bits as its closures did before they were lifted into
  ``ops/conv.py``.
- ``ops.gather_slot_major`` (the port's ``gather_slots``) gives JAX's
  values exactly and its gradients within float32 reordering.
- The exported forward holds the bias + lrelu kernel as an opaque
  operator, once a conv that takes lrelu and once for ``fc1``, and runs
  the chain on the CPU: the eager forward's bits, no launch (its card
  counterpart is in ``tests/test_torch_bias_lrelu.py``).
"""

import ast
import importlib
import io
import os

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
from facet_graph_convolution_torch import graph, inference, ops, parallel, utils
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
            "parallel": set(parallel.JAX_ONLY) | set(parallel.NOT_YET_PORTED),
            "utils": set(utils.JAX_ONLY)}


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



def test_nothing_of_parallel_or_inference_is_left_to_port():
    assert parallel.NOT_YET_PORTED == () and inference.NOT_YET_PORTED == ()
    from facet_graph_convolution_torch.parallel import distributed, halo

    assert halo.NO_COUNTERPART == {}

    skip = set(parallel.JAX_ONLY) | set(distributed.NO_COUNTERPART) | set(halo.NO_COUNTERPART)
    for sub in ("parallel", "inference"):
        jax_pkg = importlib.import_module(f"facet_graph_convolution_tpu.{sub}")
        folder = jax_pkg.__path__[0]
        for fn in sorted(os.listdir(folder)):
            if not fn.endswith(".py") or fn == "__init__.py":
                continue
            with open(os.path.join(folder, fn)) as fh:
                tree = ast.parse(fh.read())
            names = {n.name for n in tree.body
                     if isinstance(n, (ast.FunctionDef, ast.ClassDef)) and n.name[0] != "_"}
            port = importlib.import_module(f"facet_graph_convolution_torch.{sub}.{fn[:-3]}")
            assert not [n for n in names - skip if not hasattr(port, n)], (sub, fn)
    for name, reason in halo.NO_COUNTERPART.items():
        from facet_graph_convolution_tpu.parallel import halo as jax_halo

        assert callable(getattr(jax_halo, name)) and reason and not hasattr(halo, name)


# JAX modules whose counterparts the port keeps in modules of other names
MOVED = {
    ("ops", "pallas_conv.py"): ("ops.facet_conv_kernel", "ops.gather", "graph.convert"),
    ("ops", "pallas_kernels.py"): ("ops.aggregate", "ops.tree_pool_kernel"),
}
# JAX names of ops/, graph/ and training/ that the port does not have, and why
NO_PORT = {
    "facet_conv_nminor": "the node-minor (TPU lane layout) conv; the port's convs are "
                         "row-major over the slot-major tables of K1/K2 and K5",
    "tree_pool_nminor": "the node-minor pool; the port pools row-major [N, C] signals",
    "tree_unpool_nminor": "the node-minor unpool; the port unpools row-major [N, C] signals",
    "gather_neighbors_lane_pre": "the lane gather over host-derived clamp and validity "
                                 "tables (lane_tables_pre), which keep XLA from re-deriving "
                                 "them each step of a scanned bank; the port's kernels read "
                                 "their tables as they are",
    "make_windowed_train_step": "a jitted scan over a window of prepared patches; the "
                                "port's streaming trainer runs its windows through "
                                "make_scanned_train_step (WindowBuffers)",
    "facet_conv_pallas": "the Pallas conv's entry; the port's facet_conv runs K1/K2",
    "conv_epilogue": "the Pallas epilogue pair; its counterpart is "
                     "ops.facet_conv_kernel.facet_conv_epilogue (K1 and K2)",
    "pick_tile": "the Pallas grid's tile size for the TPU's (8, 128) layout",
}


def _public_names(path):
    with open(path) as fh:
        tree = ast.parse(fh.read())
    return {n.name for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.ClassDef)) and n.name[0] != "_"}


def _port_modules(sub, fn):
    names = MOVED.get((sub, fn), (f"{sub}.{fn[:-3]}",))
    return [importlib.import_module(f"facet_graph_convolution_torch.{n}") for n in names]


@pytest.mark.parametrize("sub", ["ops", "graph", "training"])
def test_ops_graph_training_names_are_ported(sub):
    folder = importlib.import_module(f"facet_graph_convolution_tpu.{sub}").__path__[0]
    for fn in sorted(os.listdir(folder)):
        if not fn.endswith(".py") or fn == "__init__.py":
            continue
        mods = _port_modules(sub, fn)
        missing = [n for n in _public_names(os.path.join(folder, fn)) - set(NO_PORT)
                   if not any(hasattr(m, n) for m in mods)]
        assert not missing, (sub, fn, missing)


def test_names_without_a_port_exist_only_in_jax():
    """Each name of NO_PORT has a reason, exists in a JAX module and in no
    port module that stands for it."""
    found = set()
    for sub in ("ops", "graph", "training"):
        folder = importlib.import_module(f"facet_graph_convolution_tpu.{sub}").__path__[0]
        for fn in sorted(os.listdir(folder)):
            if not fn.endswith(".py") or fn == "__init__.py":
                continue
            names = _public_names(os.path.join(folder, fn)) & set(NO_PORT)
            mods = _port_modules(sub, fn)
            assert not [n for n in names if any(hasattr(m, n) for m in mods)], (sub, fn)
            found |= names
    assert found == set(NO_PORT) and all(NO_PORT.values())


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


def test_exported_forward_holds_the_bias_lrelu_operator():
    from facet_graph_convolution_torch.config import default_config
    from facet_graph_convolution_torch.graph.convert import batched_level_tables
    from facet_graph_convolution_torch.inference.exported import load_forward
    from facet_graph_convolution_torch.inference.serving import batched_forward, export_forward
    from facet_graph_convolution_torch.ops import bias_lrelu_kernel

    cfg = default_config().replace(model={"channels": (8, 16, 32), "num_filters": 4,
                                          "fc_channels": 64})
    params = init_unet(seed=3, channels=(8, 16, 32), num_filters=4, fc_channels=64,
                       device="cpu")
    data = export_forward(cfg, params, num_nodes=256, adj_widths=(23, 23, 23))
    program = torch.export.load(io.BytesIO(data))
    op = torch.ops.facet_graph_convolution.bias_lrelu.default
    assert sum(node.target is op for node in program.graph.nodes) == 7
    rng = np.random.default_rng(0)
    x = rng.normal(size=(1, 256, 6)).astype(np.float32)
    adjs = []
    for n in (256, 64, 16):
        a = np.zeros((1, n, 23), np.int32)
        a[0, :, 0] = np.arange(n) + 1
        a[0, :, 1] = rng.integers(1, n + 1, size=n)
        adjs.append(a)
    fn = load_forward(data, device="cpu")
    before = bias_lrelu_kernel.bias_lrelu_fwd.launches
    y = fn(params, x, *adjs)
    assert bias_lrelu_kernel.bias_lrelu_fwd.launches == before
    tables = batched_level_tables(adjs, fn.meta["group"], fn.meta["widths"])
    with torch.no_grad():
        ref = batched_forward(params, torch.as_tensor(x), [torch.as_tensor(a) for a, _ in tables],
                              [torch.as_tensor(r) for _, r in tables],
                              coarsening_steps=cfg.model.coarsening_steps,
                              alpha=cfg.model.lrelu_alpha)
    assert torch.equal(y.view(torch.int32), ref.view(torch.int32))
