"""The windowed conv's tables, gather and K5 (``ops/windowed_conv.py``)
against the JAX package's, on the CPU.

The K-lists are ``tests/test_windowed_gather.py``'s banded lists (every
neighbour within a band of rows, a fifth of the slots pads), with and
without halo rows after the N owned ones. The port keeps its row-major
layout: JAX's [C, N] arrays are transposed to the port's [N, C].

- ``windowed_lane_tables``: every array and the geometry bit for bit at
  N = 4096 and 4352 (the last slab overlapping its predecessor), with and
  without the halo pack, with forced windows, and its None fallbacks;
- the windowed gather: values exactly, gradients within 1e-6;
- K5 through its plain version (the CPU path of ``make_windowed_fused_conv``)
  against JAX's ``make_windowed_fused_conv`` at M = 4 / out = 6 and at M =
  33 / out = 256: y and the gradients in cat, ux, wf and c, float32 within 1e-5 relative (× max|JAX| for the absolute
  floor), bfloat16 within ``tests/test_torch_bf16.py``'s epilogue bound
  (1e-2 × max|JAX|; JAX's CPU compiler may keep some bfloat16 casts in
  f32); the plain backward against autograd through the plain forward in
  float64 (1e-10);
- ``build_level_windows`` / ``unify_level_windows`` and the windowed
  ``partition_operands`` on partitions of a noisy ``icosphere(3)`` patch
  at D = 1, 2, 4, with ``WINDOWED_MIN_NODES`` / ``WINDOWED_BLOCK`` set small
  in both packages (``test_windowed_gather.py:194-196``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facet_graph_convolution_tpu.data.dataset import TrainingSet as JaxTrainingSet
from facet_graph_convolution_tpu.data.dataset import bucket_size, pad_patch_to
from facet_graph_convolution_tpu.graph.convert import windowed_lane_tables as jax_tables
from facet_graph_convolution_tpu.ops.gather import (
    make_windowed_lane_gather as jax_make_gather,
)
from facet_graph_convolution_tpu.ops.windowed_conv import (
    make_windowed_fused_conv as jax_make_fused,
)
from facet_graph_convolution_tpu.parallel import halo as jax_halo
from facet_graph_convolution_tpu.ops.conv import FacetConvVariant as JaxVariant
from facet_graph_convolution_torch.graph.convert import lane_tables_pre, windowed_lane_tables
from facet_graph_convolution_torch.ops import windowed_conv as k5
from facet_graph_convolution_torch.ops.conv import FacetConvVariant
from facet_graph_convolution_torch.ops.gather import make_windowed_lane_gather
from facet_graph_convolution_torch.parallel import halo
from tests.conftest import make_icosphere

HALO = 160
F32_RTOL = 1e-5
BF16_TOL = 1e-2      # tests/test_torch_bf16.py's EPILOGUE_TOL, × max|JAX|
NAMES = ("out_starts", "win_starts", "relT", "validF", "bwd_starts", "relS", "validS",
         "not_tail", "tailT", "tailS", "tailV")


def banded_klist(n, k, band, pad_frac=0.2, seed=0):
    """One-indexed neighbours-only K-list with |j - i| <= band, ~pad_frac
    pads (``tests/test_windowed_gather.py``)."""
    rng = np.random.default_rng(seed)
    adj = np.clip(np.arange(n)[:, None] + rng.integers(-band, band + 1, size=(n, k)), 0,
                  n - 1) + 1
    adj[rng.random((n, k)) < pad_frac] = 0
    return adj.astype(np.int32)


def klist(n, tail, seed=0, k=7):
    """A banded K-list and its source count; with ``tail``, a tenth of the
    live slots read one of HALO rows after the n."""
    adj = banded_klist(n, k, 96, seed=seed)
    if not tail:
        return adj, n
    rng = np.random.default_rng(9)
    to_tail = (rng.random(adj.shape) < 0.1) & (adj > 0)
    adj = np.where(to_tail, rng.integers(n + 1, n + HALO + 1, size=adj.shape), adj)
    return adj.astype(np.int32), n + HALO


def assert_same_tables(got, want):
    assert (got is None) == (want is None)
    if want is None:
        return
    assert got.geometry == want.geometry and got.has_tail == want.has_tail
    assert len(got.arrays) == len(want.arrays)
    for name, a, b in zip(NAMES, got.arrays, want.arrays):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("forced", [None, (1024, 1536)])
@pytest.mark.parametrize("tail", [False, True])
@pytest.mark.parametrize("n", [4096, 4352])
def test_tables_equal_jax(n, tail, forced):
    adj, ext = klist(n, tail)
    kw = {} if forced is None else {"window": forced[0], "bwd_window": forced[1]}
    got = windowed_lane_tables(adj, num_sources=ext, block=512, align=64, **kw)
    want = jax_tables(adj, num_sources=ext, block=512, align=64, **kw)
    assert got is not None and got.has_tail == tail
    assert_same_tables(got, want)
    if forced is not None:
        assert (got.window, got.bwd_window) == forced


def test_tables_from_lane_tables_equal_jax():
    """The ``tables=`` form (a partition's lane tables) gives the same as
    deriving them from the K-list; ``lane_tables_pre`` equals its parts."""
    from facet_graph_convolution_torch.graph.convert import lane_tables

    adj, ext = klist(4352, True)
    adjT, adjT_t = lane_tables(adj, num_sources=ext)
    assert_same_tables(windowed_lane_tables(adj, num_sources=ext, block=512, align=64,
                                            tables=(adjT, adjT_t)),
                       jax_tables(adj, num_sources=ext, block=512, align=64))
    adjT0, validF, idxT, validT = lane_tables_pre(adj, ext)
    np.testing.assert_array_equal(adjT0, np.maximum(adjT - 1, 0))
    np.testing.assert_array_equal(validT, adjT_t > 0)
    assert validF.dtype == validT.dtype == bool and idxT.dtype == np.int32


@pytest.mark.parametrize("case", ["one_block", "no_locality", "fewer_sources"])
def test_table_fallbacks_equal_jax(case):
    """None where windows cannot help, as JAX: fewer than two slabs, no
    locality (a random K-list past the window ratio), fewer sources than
    rows."""
    adj = banded_klist(4096, 7, 64)
    kw = {"block": 512, "align": 64}
    if case == "one_block":
        kw["block"] = 4096
    elif case == "no_locality":
        rng = np.random.default_rng(2)
        adj = (rng.integers(0, 4096, size=(4096, 7)) + 1).astype(np.int32)
        kw.update(block=256, max_window_ratio=2.0)
    else:
        kw["num_sources"] = 4000
    assert windowed_lane_tables(adj, **kw) is None
    assert jax_tables(adj, **kw) is None


def _tensors(wt):
    return k5.window_tensors(wt.arrays, "cpu")


@pytest.mark.parametrize("n,tail", [(4096, False), (4352, False), (4096, True)])
def test_windowed_gather_equals_jax(n, tail):
    adj, ext = klist(n, tail, seed=1)
    wt = windowed_lane_tables(adj, num_sources=ext, block=512, align=64)
    x = np.random.default_rng(1).standard_normal((ext, 5)).astype(np.float32)
    g_out = np.random.default_rng(2).standard_normal((adj.shape[1], n, 5)).astype(np.float32)
    valid = (adj.T > 0)[..., None]

    def jax_loss(x_t):
        g = jax_make_gather(wt.geometry)(x_t, *(jnp.asarray(a) for a in wt.arrays))
        return jnp.sum(g * jnp.asarray(g_out.transpose(2, 0, 1) * valid.transpose(2, 0, 1))), g

    (_, want), want_dx = jax.value_and_grad(jax_loss, has_aux=True)(jnp.asarray(x.T))
    xt = torch.tensor(x, requires_grad=True)
    got = make_windowed_lane_gather(wt.geometry)(xt, *_tensors(wt))
    (got * torch.as_tensor(g_out * valid)).sum().backward()
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want).transpose(1, 2, 0))
    assert xt.grad.shape == (ext, 5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_dx).T, rtol=1e-6, atol=1e-6)


def conv_inputs(n, tail, seed=5, in_ch=5, m=4, out=6):
    adj, ext = klist(n, tail, seed=seed)
    wt = windowed_lane_tables(adj, num_sources=ext, block=512, align=64)
    rng = np.random.default_rng(7)
    k = adj.shape[1]
    mult = np.where(adj.T > 0, rng.uniform(0.5, 2.0, size=(k, n)), 0.0)
    return wt, {
        "cat": rng.standard_normal((ext, in_ch + m)).astype(np.float32),
        "ux": rng.standard_normal((n, m)).astype(np.float32),
        "wf": (rng.standard_normal((out, m * in_ch)) * 0.1).astype(np.float32),
        "c": (rng.standard_normal(m) * 0.1).astype(np.float32),
        "mult_rows": np.concatenate([np.ones((1, n)), mult]).astype(np.float32),
        "gy": rng.standard_normal((n, out)).astype(np.float32),
    }


# (tail, dtype, M, out): the narrow conv, and M = 33 / out = 256, past the
# limits that K5's first kernels had (M <= 32, out <= 128)
FUSED_CASES = [pytest.param(tail, dtype, m, out,
                            id=f"{tail}-{dtype}" + ("-wide" if m == 33 else ""))
               for m, out in ((4, 6), (33, 256)) for tail in (False, True)
               for dtype in ("float32", "bfloat16")]


@pytest.mark.parametrize("tail,dtype,m,out", FUSED_CASES)
def test_fused_conv_equals_jax(tail, dtype, m, out):
    """y and the gradients in cat, ux, wf and c of ``sum(y · gy)``."""
    wt, a = conv_inputs(4352, tail, m=m, out=out)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    fused = jax_make_fused(wt.geometry)
    jtabs = tuple(jnp.asarray(t) for t in wt.arrays)

    def jax_loss(cat_t, ux_t, wf, c):
        y = fused(cat_t, ux_t, wf, c, jnp.asarray(a["mult_rows"]), *jtabs)
        return jnp.sum(y * jnp.asarray(a["gy"].T)), y

    (_, want), want_g = jax.value_and_grad(jax_loss, argnums=(0, 1, 2, 3), has_aux=True)(
        jnp.asarray(a["cat"].T).astype(jdt), jnp.asarray(a["ux"].T), jnp.asarray(a["wf"]),
        jnp.asarray(a["c"]))
    leaves = {name: torch.tensor(a[name]).requires_grad_() for name in ("ux", "wf", "c")}
    cat = torch.tensor(a["cat"]).to(tdt).requires_grad_()
    y = k5.make_windowed_fused_conv(wt.geometry)(
        cat, leaves["ux"], leaves["wf"], leaves["c"], torch.tensor(a["mult_rows"]),
        *_tensors(wt))
    (y * torch.tensor(a["gy"])).sum().backward()
    assert y.dtype == torch.float32 and cat.grad.dtype == tdt
    pairs = [("y", y.detach(), np.asarray(want).T), ("cat", cat.grad.float(),
                                                    np.asarray(want_g[0], np.float32).T),
             ("ux", leaves["ux"].grad, np.asarray(want_g[1]).T),
             ("wf", leaves["wf"].grad, np.asarray(want_g[2])),
             ("c", leaves["c"].grad, np.asarray(want_g[3]))]
    for name, got, ref in pairs:
        scale = float(np.abs(ref).max())
        if dtype == "float32":
            np.testing.assert_allclose(got.numpy(), ref, rtol=F32_RTOL, atol=F32_RTOL * scale,
                                       err_msg=name)
        else:
            assert float(np.abs(got.numpy() - ref).max()) <= BF16_TOL * scale, name


@pytest.mark.parametrize("tail", [False, True])
def test_plain_backward_equals_autograd_float64(tail):
    """``windowed_fused_conv_bwd_plain`` against autograd through
    ``windowed_fused_conv_fwd_plain``, float64 (no rounding between them)."""
    wt, a = conv_inputs(4096, tail, seed=6)
    t = {name: torch.tensor(v, dtype=torch.float64) for name, v in a.items()}
    tabs = _tensors(wt)
    leaves = [t[name].clone().requires_grad_() for name in ("cat", "ux", "wf", "c")]
    y = k5.windowed_fused_conv_fwd_plain(wt.geometry, *leaves, t["mult_rows"], tabs)
    assert y.dtype == torch.float64
    y.backward(t["gy"])
    got = k5.windowed_fused_conv_bwd_plain(wt.geometry, t["cat"], t["ux"], t["wf"], t["c"],
                                           t["mult_rows"], tabs, t["gy"])
    for name, want, g in zip(("cat", "ux", "wf", "c"), [v.grad for v in leaves], got):
        np.testing.assert_allclose(g.double().numpy(), want.numpy(), rtol=1e-10, atol=1e-10,
                                   err_msg=name)


def test_wrappers_refuse():
    """The wrappers refuse a device without a kernel and tables of the wrong
    pack size or dtype, on every device."""
    wt, a = conv_inputs(4096, False)
    args = [torch.tensor(a[name]) for name in ("cat", "ux", "wf", "c", "mult_rows")]
    tabs = _tensors(wt)
    with pytest.raises(ValueError, match="no kernel"):
        k5.windowed_conv_fwd(wt.geometry, *[t.to("meta") for t in args],
                             tuple(t.to("meta") for t in tabs))
    with pytest.raises(ValueError, match="window tables"):
        k5.windowed_conv_fwd(wt.geometry, *args, tabs[:6])
    with pytest.raises(TypeError, match="relT"):
        k5.windowed_conv_fwd(wt.geometry, *args, tabs[:2] + (tabs[2].long(),) + tabs[3:])
    with pytest.raises(TypeError, match="gy"):
        k5.windowed_conv_bwd(wt.geometry, *args, tabs, torch.tensor(a["gy"]).double())


# ---------------------------------------------------------------------------
# The tables of a partitioned pyramid
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def patches():
    """Two noisy icosphere(3) patches of one padded size (two seeds)."""
    out = []
    for seed in (3, 4):
        v, f = make_icosphere(3)
        noisy = (v + np.random.default_rng(seed).normal(scale=0.02, size=v.shape)
                 ).astype(np.float32)
        ds = JaxTrainingSet(max_patch_size=10**9, coarsening_steps=2, coarsening_levels=3,
                            k_faces=23, seed=seed)
        ds.add_mesh(noisy, f, gt_vertices=v)
        out.append(pad_patch_to(ds.patches[0], bucket_size(ds.patches[0].num_nodes, 16 * 8)))
    return out


def _small_windows(monkeypatch, shards):
    """Windows from 64 rows a shard, in slabs of 128 rows (64 at D = 4, so
    that a 416-row shard has several): level 0 windows at every D."""
    block = 64 if shards >= 4 else 128
    for mod in (halo, jax_halo):
        monkeypatch.setattr(mod, "WINDOWED_MIN_NODES", 64)
        monkeypatch.setattr(mod, "WINDOWED_BLOCK", block)


def _adjs(patch):
    return [np.asarray(a) for a in patch.adjs]


@pytest.mark.parametrize("shards", [1, 2, 4])
def test_build_level_windows_equals_jax(patches, shards, monkeypatch):
    _small_windows(monkeypatch, shards)
    adjs = _adjs(patches[0])
    got = halo.build_level_windows(halo.build_partition(adjs, shards))
    want = jax_halo.build_level_windows(jax_halo.build_partition(adjs, shards))
    assert got[0] is not None and got[0].has_tail == (shards > 1)
    for a, b in zip(got, want):
        assert_same_tables(a, b)


def test_rotation_invariant_keeps_level_0_flat(patches, monkeypatch):
    _small_windows(monkeypatch, 1)
    part = halo.build_partition(_adjs(patches[0]), 1)
    got = halo.build_level_windows(part, variant=FacetConvVariant.ROTATION_INVARIANT)
    want = jax_halo.build_level_windows(jax_halo.build_partition(_adjs(patches[0]), 1),
                                        variant=JaxVariant.ROTATION_INVARIANT)
    assert got[0] is None and got[1] is not None
    for a, b in zip(got, want):
        assert_same_tables(a, b)


@pytest.mark.parametrize("shards", [1, 2])
def test_unify_level_windows_equals_jax(patches, shards, monkeypatch):
    """Two meshes' partitions get one window geometry a level, JAX's arrays."""
    _small_windows(monkeypatch, shards)
    parts = [halo.build_partition(_adjs(p), shards) for p in patches]
    jparts = [jax_halo.build_partition(_adjs(p), shards) for p in patches]
    halo.unify_level_windows(parts)
    jax_halo.unify_level_windows(jparts)
    got = [halo.build_level_windows(p) for p in parts]
    assert got[0][0] is not None
    for level in range(len(parts[0].levels)):
        # the windows; the source counts follow each mesh's halo (one only
        # after prepare_sharded_mesh_bank's merged partition geometry)
        geoms = {None if g[level] is None else g[level].geometry[:3] for g in got}
        assert len(geoms) == 1, level
    for pt, jp in zip(got, [jax_halo.build_level_windows(p) for p in jparts]):
        for a, b in zip(pt, jp):
            assert_same_tables(a, b)


@pytest.mark.parametrize("shards", [1, 2])
def test_windowed_partition_operands(patches, shards, monkeypatch):
    """A windowed level carries its shard's window tables and no flat K1/K2
    tables; the others keep theirs; the halo pack goes with the halo."""
    _small_windows(monkeypatch, shards)
    part = halo.build_partition(_adjs(patches[0]), shards)
    windows = halo.build_level_windows(part)
    for rank in range(shards):
        tables = halo.partition_operands(part, rank, "cpu", windows)
        for t, wt in zip(tables, windows):
            if wt is None:
                assert t.windows is None and t.adj_sm is not None
                continue
            assert t.adj_sm is None and t.adj_t_sm is None
            assert t.windows.geometry == wt.geometry
            assert len(t.windows.arrays) == (11 if shards > 1 else 7)
            for got, want in zip(t.windows.arrays, wt.arrays):
                np.testing.assert_array_equal(got.numpy(), want if shards == 1 else want[rank])


@pytest.mark.parametrize("shards", [1, 2])
def test_mesh_bank_windows_of_one_shape(patches, shards, monkeypatch):
    """``prepare_sharded_mesh_bank`` with windows on: each mesh's windows
    equal JAX's bank's (``unify_level_windows`` in both), and every mesh's
    tables, windows included, have one shape on each rank."""
    from facet_graph_convolution_tpu.config import default_config as jax_default_config
    from facet_graph_convolution_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from facet_graph_convolution_torch.config import default_config
    from facet_graph_convolution_torch.parallel.mesh import GraphGroup

    _small_windows(monkeypatch, shards)
    widths = {"channels": (8, 16, 32), "num_filters": 4, "fc_channels": 32}
    cfg = default_config().replace(model=widths)
    jcfg = jax_default_config().replace(model=widths)
    mesh = jax_make_mesh((1, shards), ("data", "graph"))
    jparts = jax_halo.prepare_sharded_mesh_bank(jcfg, patches, mesh)[0]
    for rank in range(shards):
        parts = halo.prepare_sharded_mesh_bank(
            cfg, patches, GraphGroup(rank, shards, torch.device("cpu")))[0]
        shapes = None
        for part, jpart in zip(parts, jparts):
            windows = halo.build_level_windows(part)
            assert windows[0] is not None
            for a, b in zip(windows, jax_halo.build_level_windows(jpart)):
                assert_same_tables(a, b)
            got = halo.table_shapes(halo.partition_operands(part, rank, "cpu", windows))
            shapes = shapes or got
            assert got == shapes, rank
