"""The naive solver under autograd on the CPU (``ops/ms_solver_kernel.py``:
``NaiveScale``, its plain adjoint, the maps of the card's adjoint kernel)
and the vertex trainer's graph cache, against torch.autograd and the JAX
package.

Inputs from numpy seeds: the largest ~300-face patch of a noisy
subdivision-3 icosphere (fake faces, −1 pads) with noisy normals, and
vertex training sets of noisy subdivision-1 and -2 icospheres at small
widths (channels 4/8/16, M = 2, fc 16; schedule (8, 4, 4)). The adjoint
kernel itself runs on the card (``tests/test_torch_cuda.py``).

Tolerances: the plain adjoint against torch.autograd through the plain
loop in float64 on the same inputs, each gradient scaled to max 1: in
float64 atol 1e-12 (the same math, summed in another order), in float32
atol 1e-5 (float32's own rounding over the iterations; autograd in float32
is itself 1.04e-5 from the float64 gradient of the coarse normals in the
chained case, the plain adjoint 3.9e-6); the solver's points and gradients against JAX
``jax.grad`` at tests/test_torch_vertex_train.py's SOLVER_TOL and GRAD_ATOL
(scaled); the pool's adjoint bit for bit (halves and sums of halves are
exact); checkpointed and chunked runs bit for bit (the same operations).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facet_graph_convolution_tpu.ops.pooling import tree_pool as jax_tree_pool
from facet_graph_convolution_tpu.ops.vertex_update import (
    update_positions_multiscale as jax_update_positions_multiscale,
)
from facet_graph_convolution_torch.data.dataset import TrainingSet
from facet_graph_convolution_torch.data.synthetic import add_vertex_noise, icosphere
from facet_graph_convolution_torch.ops import ms_solver_kernel as ms
from facet_graph_convolution_torch.ops.vertex_update import (
    build_naive_maps,
    naive_map_arrays,
    update_positions_multiscale,
)
from facet_graph_convolution_torch.training import trainer
from facet_graph_convolution_torch.training.checkpoint import CheckpointManager
from facet_graph_convolution_torch.training.graph_step import GraphCache
from facet_graph_convolution_torch.training.trainer import train_with_vertices
from tests.test_torch_naive_solver import _patch_solver_case
from tests.test_torch_vertex_train import GRAD_ATOL, SOLVER_TOL

SCHEDULE = (20, 10, 10)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def case():
    return _patch_solver_case()


def _scaled_close(a, b, atol, name=""):
    scale = max(float(b.abs().max()), 1e-30)
    assert scale > 1e-6, name                                      # a gradient reached it
    np.testing.assert_allclose(a.detach().numpy() / scale, b.detach().numpy() / scale, rtol=0,
                               atol=atol, err_msg=name)


def _cotangent(shape, seed=0):
    return torch.as_tensor(np.random.default_rng(seed).normal(size=shape))


# ---------------------------------------------------------------------------
# (a) the plain adjoint against torch.autograd through the plain loop
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,atol", [(torch.float64, 1e-12), (torch.float32, 1e-5)])
@pytest.mark.parametrize("scale", [0, 1, 2])
def test_plain_adjoint_matches_autograd_per_scale(case, scale, dtype, atol):
    x0, normals, faces, v_f = case
    ft, vt = torch.as_tensor(faces), torch.as_tensor(v_f)
    iters = SCHEDULE[2 - scale]
    g = _cotangent(x0.shape)
    x64, fn64 = (torch.tensor(a, dtype=torch.float64, requires_grad=True)
                 for a in (x0, normals[scale]))
    ref = torch.autograd.grad(ms.naive_scale_plain(x64, ft, vt, fn64, scale, 2, iters),
                              [x64, fn64], g)
    x, fn = torch.tensor(x0, dtype=dtype), torch.tensor(normals[scale], dtype=dtype)
    xs = ms.naive_scale_plain(x, ft, vt, fn, scale, 2, iters, store=True)
    assert xs.shape == (iters + 1, *x.shape) and torch.equal(xs[0], x)
    assert torch.equal(xs[-1], ms.naive_scale_plain(x, ft, vt, fn, scale, 2, iters))
    ours = ms.naive_scale_backward_plain(xs, ft, vt, fn, scale, 2, g.to(dtype))
    for name, a, b in zip(("x", "fn"), ours, ref):
        _scaled_close(a, b, atol, name)


@pytest.mark.parametrize("dtype,atol", [(torch.float64, 1e-12), (torch.float32, 1e-5)])
def test_plain_adjoint_chained_over_the_scales_matches_autograd(case, dtype, atol):
    """Coarse to fine, each scale from the last one's result; the adjoint
    runs the scales back, each from its own iterates."""
    x0, normals, faces, v_f = case
    ft, vt = torch.as_tensor(faces), torch.as_tensor(v_f)
    leaves = [torch.tensor(a, dtype=torch.float64, requires_grad=True) for a in (x0, *normals)]
    x = leaves[0]
    for scale, iters in zip((2, 1, 0), SCHEDULE):
        x = ms.naive_scale_plain(x, ft, vt, leaves[1 + scale], scale, 2, iters)
    g = _cotangent(x.shape)
    ref = torch.autograd.grad(x, leaves, g)
    x, fns, stored = torch.tensor(x0, dtype=dtype), [torch.tensor(n, dtype=dtype)
                                                      for n in normals], []
    for scale, iters in zip((2, 1, 0), SCHEDULE):
        stored.append(ms.naive_scale_plain(x, ft, vt, fns[scale], scale, 2, iters, store=True))
        x = stored[-1][-1]
    g, g_fn = g.to(dtype), [None] * 3
    for scale, xs in zip((0, 1, 2), reversed(stored)):
        g, g_fn[scale] = ms.naive_scale_backward_plain(xs, ft, vt, fns[scale], scale, 2, g)
    for name, a, b in zip(("x", "n0", "n1", "n2"), [g, *g_fn], ref):
        _scaled_close(a, b, atol, name)


# ---------------------------------------------------------------------------
# (b) the Function on CPU tensors against JAX jax.grad
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("remat", [False, True])
def test_function_gradients_match_jax_grad(case, remat):
    """⟨solved points, r⟩'s gradients through ``update_positions_multiscale``
    (NaiveScale, the plain adjoint on the CPU) against ``jax.grad`` of the
    JAX solver with ``checkpoint=remat``; remat gives the same bits."""
    x0, normals, faces, v_f = case
    r = np.random.default_rng(9).normal(size=x0.shape).astype(np.float32)
    kw = dict(coarsening_steps=2, iter_nums=SCHEDULE)

    def jsolve(xx, n0, n1, n2):
        out = jax_update_positions_multiscale(xx, [n0, n1, n2], jnp.asarray(faces),
                                              jnp.asarray(v_f), checkpoint=remat, **kw)[0]
        return jnp.sum(out * r), out

    (_, out_j), grads_j = jax.value_and_grad(jsolve, argnums=(0, 1, 2, 3), has_aux=True)(
        jnp.asarray(x0), *map(jnp.asarray, normals))
    maps = build_naive_maps(faces, v_f, 3, 2)
    runs = []
    for ck in (remat, not remat):
        leaves = [torch.tensor(a, requires_grad=True) for a in (x0, *normals)]
        out, _ = update_positions_multiscale(leaves[0], leaves[1:], torch.as_tensor(faces),
                                             torch.as_tensor(v_f), checkpoint=ck, maps=maps,
                                             **kw)
        assert out.grad_fn is not None
        runs.append((out, torch.autograd.grad((out * torch.as_tensor(r)).sum(), leaves)))
    (out, grads), (out2, grads2) = runs
    assert torch.equal(out, out2) and all(torch.equal(a, b) for a, b in zip(grads, grads2))
    assert np.abs(out.detach().numpy() - x0).max() > 1e-3               # the solver moved
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j), **SOLVER_TOL)
    for name, g, jg in zip(("x", "n0", "n1", "n2"), grads, grads_j):
        _scaled_close(g, torch.as_tensor(np.array(jg)), GRAD_ATOL, name)


def test_function_on_cpu_needs_no_maps_and_launches_nothing(case):
    x0, normals, faces, v_f = case
    before = (ms.naive_scale.launches, ms.naive_scale_backward.launches)
    leaves = [torch.tensor(a, requires_grad=True) for a in (x0, *normals)]
    out, _ = update_positions_multiscale(leaves[0], leaves[1:], torch.as_tensor(faces),
                                         torch.as_tensor(v_f), 2, (3, 2, 2))
    out.sum().backward()
    assert all(t.grad is not None and torch.isfinite(t.grad).all() for t in leaves)
    assert (ms.naive_scale.launches, ms.naive_scale_backward.launches) == before


# ---------------------------------------------------------------------------
# (c) the pool's adjoint: the three sibling cases
# ---------------------------------------------------------------------------

def test_pool_adjoint_matches_jax_grad_in_each_sibling_case():
    """Pairs with one zero row (either side), two zero rows and two live
    ones, in each of two rounds; the cotangent of the input against
    ``jax.vjp`` of the JAX ``tree_pool(..., "avg_ignore_zeros")``, bit for
    bit (halving and adding halves are exact)."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(64, 3)).astype(np.float32)
    x[0] = 0.0                        # left zero, right live
    x[3] = 0.0                        # right zero, left live
    x[4:6] = 0.0                      # both zero (a pair), beside a live pair in round 2
    x[8:12] = 0.0                     # a zero group of 4: both zero in round 2 too
    x[17] = (0.0, -0.0, 0.0)          # -0.0 counts as zero
    g = rng.normal(size=(16, 3)).astype(np.float32)
    out, vjp = jax.vjp(lambda a: jax_tree_pool(a, 2, "avg_ignore_zeros"), jnp.asarray(x))
    ref = np.asarray(vjp(jnp.asarray(g))[0])
    pooled, flags = ms.pool_with_flags(torch.as_tensor(x), 2)
    np.testing.assert_array_equal(pooled.numpy(), np.asarray(out))
    ours = ms.pool_adjoint_plain(flags, torch.as_tensor(g)).numpy()
    np.testing.assert_array_equal(ours, ref)
    half = g[0] * np.float32(0.5)     # group 0: two live pooled rows, each from one live row
    np.testing.assert_array_equal(ours[0:4], [np.zeros(3), half, half, np.zeros(3)])
    np.testing.assert_array_equal(ours[4:6], 0.0)         # a zero pair beside a live pair
    np.testing.assert_array_equal(ours[8:12], np.tile(g[2] * np.float32(0.25), (4, 1)))
    np.testing.assert_array_equal(ours[16], g[4] * np.float32(0.5))      # its partner is -0.0


# ---------------------------------------------------------------------------
# (d) the maps of the adjoint kernel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("steps", [2, 3])
def test_face_slot_map_lists_each_slot_once_under_its_node(case, steps):
    _, _, faces, v_f = case
    if faces.shape[0] % (1 << (2 * steps)):
        faces = np.concatenate([faces, np.full((-faces.shape[0] % (1 << (2 * steps)), 3), -1,
                                               np.int32)])
    k = v_f.shape[1]
    face_slots, _ = naive_map_arrays(faces, v_f, 3, steps)
    real = np.flatnonzero((v_f >= 0).ravel())
    for s, (offsets, ids) in enumerate(face_slots):
        nodes = faces.shape[0] >> (steps * s)
        assert offsets.shape == (nodes + 1,) and offsets[0] == 0 and offsets[-1] == ids.size
        assert offsets.dtype == ids.dtype == np.int32
        np.testing.assert_array_equal(np.sort(ids), real)          # each slot exactly once
        node = np.repeat(np.arange(nodes), np.diff(offsets))
        np.testing.assert_array_equal(v_f.ravel()[ids] >> (steps * s), node)


def test_corner_map_lists_each_corner_once(case):
    _, _, faces, v_f = case
    _, (offsets, ids) = naive_map_arrays(faces, v_f, 3, 2)
    num_v = v_f.shape[0]
    assert offsets.shape == (num_v + 1,) and offsets[-1] == ids.size
    vertex = np.repeat(np.arange(num_v), np.diff(offsets))
    listed = sorted(zip(vertex.tolist(), ids.tolist()))
    corners = sorted((int(v), f) for f, row in enumerate(faces) for v in row if v >= 0)
    assert listed == corners                                        # each corner exactly once
    for v in range(num_v):                                          # v_faces' rows inside
        row = v_f[v][v_f[v] >= 0].tolist()
        mine = ids[offsets[v]:offsets[v + 1]].tolist()
        assert all(row.count(f) <= mine.count(f) for f in row)


def test_corner_map_covers_what_v_faces_cuts_and_refuses_a_stray_slot(case):
    """A vertex in more faces than K: its corner list keeps them all. A
    v_faces slot naming a face without the vertex is refused."""
    _, _, faces, v_f = case
    short = v_f[:, :3].copy()
    _, (offsets, ids) = naive_map_arrays(faces, short, 3, 2)
    full = naive_map_arrays(faces, v_f, 3, 2)[1]
    np.testing.assert_array_equal(offsets, full[0])
    np.testing.assert_array_equal(ids, full[1])
    bad = v_f.copy()
    v = int(np.argmax((v_f >= 0).sum(axis=1)))
    bad[v, 0] = int(np.flatnonzero((faces != v).all(axis=1) & (faces[:, 0] >= 0))[0])
    with pytest.raises(ValueError, match="do not name the vertex"):
        naive_map_arrays(faces, bad, 3, 2)


def test_maps_are_int32_tensors_on_the_device(case):
    _, _, faces, v_f = case
    maps = build_naive_maps(faces, v_f, 3, 2, device="cpu")
    assert len(maps.face_slots) == 3
    for t in (*[a for pair in maps.face_slots for a in pair], *maps.corners):
        assert t.dtype == torch.int32 and t.device.type == "cpu"


# ---------------------------------------------------------------------------
# (e) the graph cache's bookkeeping, with stub entries
# ---------------------------------------------------------------------------

class _Stub:
    """A GraphStep's size and release, nothing else."""

    def __init__(self, size):
        self.size, self.released = size, False

    @property
    def held_bytes(self):
        return 0 if self.released else self.size

    def release(self):
        self.released = True


def _maker(made, size=100):
    def make(key):
        made.append(key)
        return _Stub(size)
    return make


def test_graph_cache_without_a_budget_holds_every_key_in_lru_order():
    made = []
    cache = GraphCache()
    make = _maker(made)
    stubs = {key: cache.get(key, lambda key=key: make(key)) for key in "abc"}
    assert cache.get("a", lambda: make("a")) is stubs["a"]
    assert list(cache.entries) == ["b", "c", "a"] and made == ["a", "b", "c"]
    assert (cache.captures, cache.evictions) == (3, 0)


def test_graph_cache_evicts_the_least_recently_used_within_its_budget():
    made = []
    make = _maker(made)
    cache = GraphCache(budget_bytes=250)
    a = cache.get("a", lambda: make("a"))
    cache.get("b", lambda: make("b"))        # 100 held + 100 foreseen <= 250
    assert cache.evictions == 0
    cache.get("c", lambda: make("c"))        # 200 + 100 > 250: "a" goes
    assert a.released and list(cache.entries) == ["b", "c"] and cache.evictions == 1
    cache.get("b", lambda: make("b"))        # a hit: "b" is now the newest
    assert list(cache.entries) == ["c", "b"]
    again = cache.get("a", lambda: make("a"))   # "c" goes, "a" is made again
    assert again is not a and not again.released
    assert list(cache.entries) == ["b", "a"] and made == ["a", "b", "c", "a"]
    assert (cache.captures, cache.evictions) == (4, 2)
    cache.observe()
    assert cache.peak_held == 200 <= cache.budget_bytes


def test_graph_cache_sizes_a_new_entry_as_the_largest_seen():
    """Sized as the largest held so far: a newcomer larger than every one
    before it goes past the budget by its excess (``peak_held`` shows it),
    and the next one is sized by it."""
    cache = GraphCache(budget_bytes=200)
    cache.get("a", lambda: _Stub(100))
    cache.get("b", lambda: _Stub(150))       # foreseen 100: 100 + 100 <= 200
    cache.observe()
    assert cache.evictions == 0 and cache.peak_held == 250 and cache.largest == 150
    cache.get("c", lambda: _Stub(100))       # foreseen 150: "a", then "b" go
    assert list(cache.entries) == ["c"] and cache.evictions == 2
    cache.get("d", lambda: _Stub(100))       # 100 + 150 > 200: "c" goes
    assert list(cache.entries) == ["d"] and cache.evictions == 3
    cache.observe()
    assert cache.peak_held == 250


# ---------------------------------------------------------------------------
# (f) train_with_vertices under the naive solver on the CPU, chunked
# ---------------------------------------------------------------------------

MODEL = {"channels": (4, 8, 16), "num_filters": 2, "fc_channels": 16}
TRAIN = {"chamfer_samples": 32, "save_every": 3, "valid_every": 1000, "seed": 0}


@pytest.fixture(scope="module")
def vertex_sets():
    """A one-patch and a three-patch vertex set of a noisy subdivision-2
    icosphere."""
    v, f = icosphere(2)
    noisy = add_vertex_noise(v, f, 0.2, np.random.default_rng(1))
    sets = []
    for size in (20000, 200):
        ds = TrainingSet(max_patch_size=size, coarsening_steps=2, coarsening_levels=3,
                         k_faces=23, seed=0)
        ds.add_mesh_with_vertices(noisy, f, gt_vertices=v)
        sets.append(ds)
    return sets


def _naive_cfg(tmp_path, **eval_):
    from facet_graph_convolution_torch.config import default_config

    return default_config().replace(
        model=MODEL, train={**TRAIN, "network_path": str(tmp_path) + "/"},
        eval={"ms_solver_iterations": (8, 4, 4), "vertex_solver": "naive", **eval_})


@pytest.mark.parametrize("remat", [False, True])
def test_naive_chunked_training_equals_single_steps(vertex_sets, tmp_path, remat):
    """7 steps at 3 a call against 7 single steps from the same generator:
    the same parameters, Adam state and checkpoints (3, 6 and 7), bit for
    bit, with and without the solver's checkpoint."""
    runs = []
    for spc in (3, 1):
        cfg = _naive_cfg(tmp_path / f"spc{spc}", solver_remat=remat)
        state, hist = train_with_vertices(cfg, vertex_sets[0], num_iterations=7,
                                          steps_per_call=spc, device="cpu")
        assert np.isfinite(hist[:, 0]).all()
        runs.append((state, CheckpointManager(cfg.train.network_path, cfg.train.net_name)))
    (chunked, mgr_c), (single, mgr_s) = runs
    assert chunked.step == single.step == 7
    assert mgr_c.steps() == mgr_s.steps() == [3, 6, 7]
    for a, b in zip(trainer._leaves(chunked.params), trainer._leaves(single.params)):
        assert torch.equal(a, b)
        sa, sb = chunked.optimizer.state[a], single.optimizer.state[b]
        assert all(torch.equal(sa[k], sb[k]) for k in ("step", "exp_avg", "exp_avg_sq"))


def test_naive_patch_tensors_carry_the_maps(vertex_sets, tmp_path):
    cfg = _naive_cfg(tmp_path)
    t = trainer.vertex_patch_tensors(cfg, vertex_sets[1].patches[0], "cpu")
    assert t.tables is None and t.naive_maps is not None and len(t.naive_maps.face_slots) == 3
    op = trainer.vertex_patch_tensors(cfg.replace(eval={"vertex_solver": "operator"}),
                                      vertex_sets[1].patches[0], "cpu")
    assert op.tables is not None and op.naive_maps is None


def test_naive_chunks_hold_a_graph_step_a_patch_in_the_cache(vertex_sets, tmp_path):
    """On the three-patch set: the chunk loop asks the cache for each
    chunk's patch; on the CPU it holds every patch it was asked for."""
    cache = GraphCache()
    cfg = _naive_cfg(tmp_path)
    state, hist = train_with_vertices(cfg, vertex_sets[1], num_iterations=8, steps_per_call=2,
                                      device="cpu", graph_cache=cache)
    rng = np.random.default_rng(cfg.train.seed)
    picked = [int(rng.integers(3)) for _ in range(4)]
    assert state.step == 8 and hist.shape == (4, 2) and np.isfinite(hist[:, 0]).all()
    assert sorted(cache.entries) == sorted(set(picked)) and cache.captures == len(set(picked))
    assert cache.evictions == 0


def test_cli_train_include_vertices_with_the_naive_solver(tmp_path, monkeypatch):
    """cli.preprocess --include_vertices, then cli.train --include_vertices
    --vertex_solver naive at full width on the CPU: the solver's backward
    is the naive scale's adjoint (3 a step), and params.pt is written."""
    from facet_graph_convolution_torch.cli import preprocess as cli_preprocess
    from facet_graph_convolution_torch.cli import train as cli_train
    from facet_graph_convolution_torch.config import add_cli_overrides, config_from_args
    from facet_graph_convolution_torch.geometry.obj_io import write_obj

    base = tmp_path / "run"
    train_dir = base / "Data" / "Synthetic" / "train"
    for sub in ("noisy", "original"):
        (train_dir / sub).mkdir(parents=True)
    v, f = icosphere(1)
    write_obj(add_vertex_noise(v, f, 0.2, np.random.default_rng(0)), f,
              str(train_dir / "noisy" / "sphere_n1.obj"))
    write_obj(v, f, str(train_dir / "original" / "sphere.obj"))
    common = ["--base_path", str(base), "--network_path", str(tmp_path / "nets"),
              "--include_vertices"]
    import argparse

    args = add_cli_overrides(argparse.ArgumentParser()).parse_args(
        common + ["--vertex_solver", "naive"])
    assert config_from_args(args).eval.vertex_solver == "naive"
    cli_preprocess.main(common)
    calls = []
    adjoint = ms.naive_scale_backward

    def counted(*args, **kwargs):
        calls.append(args[4])                     # the scale
        return adjoint(*args, **kwargs)

    monkeypatch.setattr(ms, "naive_scale_backward", counted)
    cli_train.main(common + ["--vertex_solver", "naive", "--device", "cpu",
                             "--num_iterations", "2"])
    assert sorted(calls) == [0, 0, 1, 1, 2, 2]
    assert CheckpointManager(str(tmp_path / "nets"), "net").steps() == [2]
    rows = np.loadtxt(str(tmp_path / "nets" / "net.csv"), delimiter=",", ndmin=2)
    assert rows.shape == (2, 2) and np.isfinite(rows[:, 0]).all()
