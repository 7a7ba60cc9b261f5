"""The port's serving slice against the JAX package's: the batched
``InferenceServer`` (``denoise_batch``, its bounded cache,
``denoise_batch_with_vertices``), the exported forward, the block-diagonal
batched tables, the forward's tables without transpose maps, the K1
operator and ``cli.infer --batch``.

The config of tests/test_serving.py (default widths 32/64/128, M = 9, fc
1024; 5 solver iterations) on its noisy subdivision-2 and -3 icospheres,
one set of JAX parameters carried across by ``params_from_jax``. The port
runs on the CPU (the plain K1, eager forwards); the JAX server runs its
vmapped forward. Tolerances, float32: served normals and vertices atol 1e-4,
the vertex pipeline 2e-4 (schedule (8, 2, 2)), an exported program and a
batched patch against its own forward 1e-5.
"""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from facet_graph_convolution_tpu.config import default_config as jax_default_config
from facet_graph_convolution_tpu.inference.serving import InferenceServer as JaxInferenceServer
from facet_graph_convolution_tpu.models.unet import init_unet as jax_init_unet
from facet_graph_convolution_torch import params as params_io
from facet_graph_convolution_torch.cli import infer as cli_infer
from facet_graph_convolution_torch.config import default_config
from facet_graph_convolution_torch.data.dataset import InferenceMesh, bucket_size, pad_patch_to
from facet_graph_convolution_torch.data.synthetic import add_vertex_noise, icosphere
from facet_graph_convolution_torch.geometry.obj_io import load_obj, write_obj
from facet_graph_convolution_torch.graph.convert import (
    batched_level_tables,
    dedupe_klist,
    slot_major_arrays,
    split_self_klist,
)
from facet_graph_convolution_torch.inference.driver import infer_normals, infer_with_vertices
from facet_graph_convolution_torch.inference.serving import (
    BatchedForward,
    InferenceServer,
    _build_mesh,
    batched_forward,
    export_forward,
    load_exported,
    load_forward,
    save_exported,
)
from facet_graph_convolution_torch.models.unet import (
    batched_graph_tensors,
    graph_tensors,
    train_graph_tensors,
    unet_apply,
)
from facet_graph_convolution_torch.ops import facet_conv_kernel as k1
from facet_graph_convolution_torch.ops.normalization import normalize_tensor
from facet_graph_convolution_torch.training.graph_step import GraphCache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cfgs(**eval_updates):
    updates = dict(data={"max_patch_size": 20000},
                   eval={"solver_iterations": 5, **eval_updates})
    return jax_default_config().replace(**updates), default_config().replace(**updates)


def _meshes():
    rng = np.random.default_rng(0)
    v, f = icosphere(2)
    v2, f2 = icosphere(3)
    return [(add_vertex_noise(v, f, 0.1, rng), f), (add_vertex_noise(v2, f2, 0.1, rng), f2)]


@pytest.fixture(scope="module")
def weights():
    """JAX parameters at default width, normals-only and multi-scale, and
    the port's copies."""
    out = {}
    for multi in (False, True):
        jparams = jax_init_unet(jax.random.PRNGKey(0), multi_scale=multi)
        out[multi] = (jparams, params_io.params_from_jax(jax.tree.map(np.asarray, jparams),
                                                         device="cpu"))
    return out


def _direct(params, patch, cfg, multi_scale=False):
    """A patch's own forward, as the driver runs it."""
    adjs, rows = graph_tensors(patch.adjs, "cpu")
    with torch.no_grad():
        y = unet_apply(params, torch.as_tensor(patch.inputs), adjs, rows,
                       coarsening_steps=cfg.model.coarsening_steps, multi_scale=multi_scale)
    return tuple(normalize_tensor(h) for h in y) if multi_scale else normalize_tensor(y)


def test_denoise_batch_matches_jax_server_and_single(weights):
    jcfg, cfg = _cfgs()
    jparams, params = weights[False]
    meshes = _meshes()
    ref = JaxInferenceServer(jcfg, params=jparams, bucket_align=256).denoise_batch(meshes)
    server = InferenceServer(cfg, params=params, bucket_align=256, device="cpu")
    out = server.denoise_batch(meshes)
    assert len(out) == 2
    for (v, f), (refined, normals), (ref_refined, ref_normals) in zip(meshes, out, ref):
        assert refined.shape == v.shape and normals.shape == (f.shape[0], 3)
        np.testing.assert_allclose(np.linalg.norm(normals, axis=1), 1.0, atol=1e-4)
        np.testing.assert_allclose(normals, ref_normals, atol=1e-4)
        np.testing.assert_allclose(refined, ref_refined, atol=1e-4)

    single = server.denoise(*meshes[0])
    np.testing.assert_allclose(single[0], out[0][0], atol=1e-4)
    np.testing.assert_allclose(single[1], out[0][1], atol=1e-4)
    # the cache is keyed by (batch, the tables' shapes): 2 entries
    assert len(server._compiled) == 2

    # the served vertices are the per-mesh driver's for one config, params
    # and coarsening seed
    mesh = InferenceMesh(max_patch_size=cfg.data.max_patch_size,
                         coarsening_steps=cfg.model.coarsening_steps,
                         coarsening_levels=cfg.model.coarsening_levels,
                         k_faces=cfg.data.k_faces, seed=0)
    mesh.add_mesh(*meshes[0])
    drv_refined, drv_normals = infer_normals(mesh, cfg, params=params, device="cpu")
    np.testing.assert_allclose(out[0][1], drv_normals, atol=1e-4)
    np.testing.assert_allclose(out[0][0], drv_refined, atol=1e-4)


def test_cache_stays_bounded_under_lru(weights):
    """At most ``max_compiled`` forwards, least recently used out first, and
    an evicted key serves again."""
    _, cfg = _cfgs()
    server = InferenceServer(cfg, params=weights[False][1], bucket_align=16, max_compiled=3,
                             device="cpu")
    v, f = icosphere(2)
    noisy = add_vertex_noise(v, f, 0.1, np.random.default_rng(1))
    first = server.denoise_batch([(noisy, f)])
    for b in (2, 3, 4, 5):
        server.denoise_batch([(noisy, f)] * b)
        assert len(server._compiled) <= 3
    assert len(server._compiled) == 3
    assert [key[0] for key in server._compiled] == [3, 4, 5]
    again = server.denoise_batch([(noisy, f)])
    np.testing.assert_allclose(again[0][0], first[0][0], atol=1e-5)
    np.testing.assert_allclose(again[0][1], first[0][1], atol=1e-5)
    assert len(server._compiled) == 3 and server._cache.evictions == 3


def test_denoise_batch_with_vertices_matches_jax_server_and_driver(weights):
    jcfg, cfg = _cfgs(ms_solver_iterations=(8, 2, 2))
    jparams, params = weights[True]
    meshes = _meshes()
    ref = JaxInferenceServer(jcfg, params=jparams, bucket_align=256,
                             include_vertices=True).denoise_batch(meshes)
    server = InferenceServer(cfg, params=params, bucket_align=256, include_vertices=True,
                             device="cpu")
    out = server.denoise_batch(meshes)
    assert len(out) == 2
    keys = ("points", "points_mid", "points_coarse", "fine_normals", "mid_normals",
            "coarse_normals")
    for (v, f), res, res_ref in zip(meshes, out, ref):
        assert res["points"].shape == v.shape and res["fine_normals"].shape == (f.shape[0], 3)
        for key in keys:
            np.testing.assert_allclose(res[key], res_ref[key], atol=2e-4, err_msg=key)

    mesh = InferenceMesh(max_patch_size=cfg.data.max_patch_size,
                         coarsening_steps=cfg.model.coarsening_steps,
                         coarsening_levels=cfg.model.coarsening_levels,
                         k_faces=cfg.data.k_faces, min_patch_size=cfg.data.min_patch_size,
                         seed=0)
    mesh.add_mesh_with_vertices(*meshes[0])
    drv = infer_with_vertices(mesh, cfg, params=params, device="cpu")
    for key in ("points", "points_mid", "points_coarse", "fine_normals"):
        np.testing.assert_allclose(out[0][key], drv[key], atol=2e-4, err_msg=key)


def _bucketed_patch(cfg, align=256):
    mesh = _build_mesh(*_meshes()[0], cfg)
    return pad_patch_to(mesh.patches[0], bucket_size(mesh.patches[0].num_nodes, align))


LOADER_IMPORTS = """
import sys
import facet_graph_convolution_torch.inference.exported
import torch
assert hasattr(torch.ops.facet_graph_convolution, "facet_conv_fwd")
assert hasattr(torch.ops.facet_graph_convolution, "bias_lrelu")
assert not [m for m in sys.modules if m.startswith("facet_graph_convolution_torch.models")]
assert not [m for m in sys.modules if m.startswith(("jax", "facet_graph_convolution_tpu"))]
"""


def test_export_roundtrip(weights, tmp_path):
    """Baked parameters: a self-contained artifact, written and read back,
    equal to the direct forward; the loader's module registers K1 and the
    bias + lrelu operator and imports no model code."""
    _, cfg = _cfgs()
    params = weights[False][1]
    patch = _bucketed_patch(cfg)
    n = patch.num_nodes
    data = export_forward(cfg, params, n, [a.shape[1] for a in patch.adjs], batch=1,
                          bake_params=True)
    assert isinstance(data, bytes) and len(data) > 1000
    path = str(tmp_path / "forward.pt2")
    save_exported(path, data)
    fn = load_forward(load_exported(path), device="cpu")
    y = fn(patch.inputs[None], *(a[None] for a in patch.adjs)).numpy()[0]
    assert y.shape == (n, 3)
    np.testing.assert_allclose(y, _direct(params, patch, cfg).numpy(), atol=1e-5)
    subprocess.run([sys.executable, "-c", LOADER_IMPORTS], cwd=REPO, check=True)


def _self_only_inputs():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(1, 256, 6)).astype(np.float32)
    adjs = []
    for n in (256, 64, 16):
        a = np.zeros((1, n, 23), np.int32)
        a[0, :, 0] = np.arange(n) + 1
        adjs.append(a)
    return x, adjs


def test_export_params_as_arguments(weights):
    """The default export takes the params as an argument: another
    checkpoint swaps in without exporting again."""
    _, cfg = _cfgs()
    params = weights[False][1]
    fn = load_forward(export_forward(cfg, params, num_nodes=256, adj_widths=(23, 23, 23)),
                      device="cpu")
    x, adjs = _self_only_inputs()
    y1 = fn(params, x, *adjs).numpy()
    params2 = {layer: {name: t * 1.5 for name, t in leaves.items()}
               for layer, leaves in params.items()}
    y2 = fn(params2, x, *adjs).numpy()
    assert y1.shape == (1, 256, 3)
    assert not np.allclose(y1, y2)
    t_adjs, t_rows = graph_tensors([a[0] for a in adjs], "cpu")
    with torch.no_grad():
        ref = normalize_tensor(unet_apply(params2, torch.as_tensor(x[0]), t_adjs, t_rows))
    np.testing.assert_allclose(y2[0], ref.numpy(), atol=1e-5)


def test_export_multiscale_heads(weights):
    _, cfg = _cfgs()
    fn = load_forward(export_forward(cfg, weights[True][1], num_nodes=256,
                                     adj_widths=(23, 23, 23), multi_scale=True), device="cpu")
    x, adjs = _self_only_inputs()
    y0, y1, y2 = fn(weights[True][1], x, *adjs)
    assert tuple(y0.shape) == (1, 256, 3)
    assert tuple(y1.shape) == (1, 64, 3)
    assert tuple(y2.shape) == (1, 16, 3)


def test_batched_tables_are_one_graph_per_patch(weights):
    """A batch in two orders gives each patch the same output, and each
    patch's output is its own forward's: no edge, pad slot (the clamped
    gather reads node 0, patch 0's, where mult rows are zero) or pooling
    group reaches across patches."""
    _, cfg = _cfgs()
    params = weights[False][1]
    built = [_build_mesh(v, f, cfg) for v, f in _meshes()]
    patches = [p for mesh in built for p in mesh.patches]
    target = max(bucket_size(p.num_nodes, 256) for p in patches)
    padded = [pad_patch_to(p, target) for p in patches] + [pad_patch_to(patches[0], target)]
    steps = cfg.model.coarsening_steps

    def run(order):
        x = torch.as_tensor(np.stack([padded[i].inputs for i in order]))
        k = [max(p.adjs[lvl].shape[1] for p in padded) for lvl in range(3)]
        adjs_b = [np.stack([np.pad(padded[i].adjs[lvl],
                                   ((0, 0), (0, k[lvl] - padded[i].adjs[lvl].shape[1])))
                            for i in order]) for lvl in range(3)]
        adjs, rows = batched_graph_tensors(adjs_b, steps, "cpu")
        assert adjs[0].shape[1] % 256 == 0      # one node padding, after the last patch
        with torch.no_grad():
            return batched_forward(params, x, adjs, rows, coarsening_steps=steps)

    order = [0, 1, 2]
    y = run(order)
    y_rev = run(order[::-1])
    for pos, i in enumerate(order):
        np.testing.assert_allclose(y[pos].numpy(), y_rev[len(order) - 1 - pos].numpy(),
                                   atol=1e-5)
        np.testing.assert_allclose(y[pos].numpy(), _direct(params, padded[i], cfg).numpy(),
                                   atol=1e-5)
    with pytest.raises(ValueError, match="tree"):
        batched_level_tables([a.adjs[0][None] for a in padded[:1]] * 2, 4)


def test_batched_tables_are_the_block_diagonal_klists_tables():
    """The batch's tables (blocks deduped in place, self-only rows skipped)
    equal :func:`slot_major_arrays` of the block-diagonal K-list, built
    whole, bit for bit."""
    _, cfg = _cfgs()
    patches = [p for v, f in _meshes() for p in _build_mesh(v, f, cfg).patches]
    target = max(bucket_size(p.num_nodes, 256) for p in patches)
    padded = [pad_patch_to(p, target) for p in patches]
    klists = [np.stack([p.adjs[lvl] for p in padded]) for lvl in range(3)]
    for (adj_sm, rows), k in zip(batched_level_tables(klists, 4), klists):
        b, n, _ = k.shape
        whole = np.where(k > 0, k + (np.arange(b) * n)[:, None, None], 0).reshape(b * n, -1)
        ref_sm, _, ref_rows = slot_major_arrays(*split_self_klist(*dedupe_klist(whole)))
        assert np.array_equal(adj_sm, ref_sm) and np.array_equal(rows, ref_rows)


def test_forward_tables_without_transposes_keep_their_bits():
    _, cfg = _cfgs()
    patch = _build_mesh(*_meshes()[1], cfg).patches[0]
    adjs, rows = graph_tensors(patch.adjs, "cpu")
    t_adjs, _, t_rows = train_graph_tensors(patch.adjs, "cpu")
    for a, b in zip(adjs + rows, t_adjs + t_rows):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_cli_infer_batch_matches_per_mesh(weights, tmp_path):
    _, cfg = _cfgs()
    in_dir = tmp_path / "in"
    in_dir.mkdir()
    for name, (v, f) in zip(("a", "b"), _meshes()):
        write_obj(v, f, str(in_dir / f"{name}.obj"))
    net = tmp_path / "net"
    params_io.save(weights[False][1], params_io.checkpoint_path(str(net), "net"))
    common = ["--input_dir", str(in_dir), "--network_path", str(net), "--device", "cpu",
              "--solver_iterations", "5"]
    cli_infer.main(common + ["--results_path", str(tmp_path / "batch"), "--batch"])
    cli_infer.main(common + ["--results_path", str(tmp_path / "single"), "--seed", "0"])
    for name in ("a", "b"):
        vb, fb, _ = load_obj(str(tmp_path / "batch" / f"{name}_denoised.obj"))
        vs, fs, _ = load_obj(str(tmp_path / "single" / f"{name}_denoised.obj"))
        np.testing.assert_array_equal(fb, fs)
        np.testing.assert_allclose(vb, vs, atol=1e-4)


def test_server_takes_no_cpu_fallback(weights):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        InferenceServer(default_config(), params=weights[False][1])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_forward(b"", device="cuda")


def test_k1_operator_has_a_fake_and_follows_swaps():
    """``torch.ops.facet_graph_convolution.facet_conv_fwd`` runs the module's
    ``facet_conv_fwd`` as it stands (the attribute ``chip_smoke.py`` swaps)
    and gives FakeTensors z's shape."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    n, m, c = 40, 4, 6
    rng = np.random.default_rng(0)
    cat = torch.as_tensor(rng.normal(size=(n, c + m)).astype(np.float32))
    ux = torch.as_tensor(rng.normal(size=(n, m)).astype(np.float32))
    adj = torch.as_tensor(rng.integers(0, n + 1, size=(5, n)).astype(np.int32))
    rows = torch.as_tensor(rng.random((6, n)).astype(np.float32))
    cc = torch.zeros(m)
    z = torch.ops.facet_graph_convolution.facet_conv_fwd(cat, ux, adj, rows, cc)
    assert torch.equal(z, k1.facet_conv_fwd_plain(cat, ux, adj, rows, cc))
    calls = []
    kernel = k1.facet_conv_fwd
    try:
        k1.facet_conv_fwd = lambda *a: calls.append(1) or k1.facet_conv_fwd_plain(*a)
        k1.facet_conv_fwd_op(cat, ux, adj, rows, cc)
    finally:
        k1.facet_conv_fwd = kernel
    assert calls == [1]
    with FakeTensorMode() as mode:
        fake = k1.facet_conv_fwd_op(*(mode.from_tensor(t) for t in (cat, ux, adj, rows, cc)))
    assert tuple(fake.shape) == (n, m * c)


class _Stub:
    def __init__(self):
        self.released = False

    @property
    def held_bytes(self):
        return 0

    def release(self):
        self.released = True


def test_graph_cache_bounds_its_entries():
    cache = GraphCache(max_entries=2)
    stubs = {key: cache.get(key, _Stub) for key in "abc"}
    assert list(cache.entries) == ["b", "c"] and stubs["a"].released
    assert (cache.captures, cache.evictions) == (3, 1)
    cache.get("b", _Stub)
    cache.get("d", _Stub)
    assert list(cache.entries) == ["b", "d"] and stubs["c"].released


def test_batched_forward_entry_runs_eagerly_on_the_cpu(weights):
    _, cfg = _cfgs()
    patch = _bucketed_patch(cfg)
    adjs, rows = batched_graph_tensors([a[None] for a in patch.adjs],
                                       cfg.model.coarsening_steps, "cpu")
    entry = BatchedForward(lambda x, a, r: batched_forward(weights[False][1], x, a, r),
                           torch.device("cpu"))
    with torch.no_grad():
        y = entry(torch.as_tensor(patch.inputs[None]), adjs, rows)
    assert entry.graph is None and entry.held_bytes == 0
    np.testing.assert_allclose(y[0].numpy(), _direct(weights[False][1], patch, cfg).numpy(),
                               atol=1e-5)
