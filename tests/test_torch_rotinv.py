"""The port's rotation-invariant training path and its K3 module against the
JAX package, on the CPU; and the rest of the variant matrix (the row-major
oracles).

On CPU tensors the K3 wrapper runs its plain PyTorch version (as K1 and K2
do), so these tests hold that version, the autograd Function over it, the
scatter-free gathers, the rotation-invariant conv, the U-Net with conv1
rotation-invariant, three train steps and the training loop against the JAX
package. The JAX side runs its lane path (``unet_apply_nminor(lane=True)``,
no Pallas kernel on it) and, for K3 itself (the softmax·mult and the slot
sums), the Pallas ``weighted_aggregate`` in interpret mode on JAX's
``softmax·rows``. Small widths (channels 8/16/32, M = 4, fc 32-64), float32.

Tolerances: K3 against the Pallas kernel atol 1e-4 (``tests/test_pallas.py``),
against ``softmax·rows`` then ``_aggregate_nminor`` and its VJP atol 1e-5
(float32 sums in another order); gathers exact in value, their gradients atol 1e-6; the conv's values
atol 2e-5 and gradients atol = rtol = 5e-4, the U-Net atol 3e-5 (the bounds
of ``tests/test_variant_matrix.py``); a train step's loss atol 1e-4 degrees,
its gradients atol 1e-4 on each gradient scaled to max 1, the parameters
after Adam updates fed the same gradients atol 1e-7 (as
``tests/test_torch_train.py``); the row-major oracles atol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facet_graph_convolution_tpu.config import default_config as jax_default_config
from facet_graph_convolution_tpu.data.dataset import TrainingSet as JaxTrainingSet
from facet_graph_convolution_tpu.graph.convert import dedupe_klist as jax_dedupe
from facet_graph_convolution_tpu.graph.convert import fused_mult_rows as jax_fused_mult_rows
from facet_graph_convolution_tpu.graph.convert import lane_tables as jax_lane_tables
from facet_graph_convolution_tpu.graph.convert import split_self_klist as jax_split
from facet_graph_convolution_tpu.models.augment import random_rotation as jax_random_rotation
from facet_graph_convolution_tpu.models.augment import rotate_inputs as jax_rotate_inputs
from facet_graph_convolution_tpu.models.augment import rotate_vec3 as jax_rotate_vec3
from facet_graph_convolution_tpu.models.losses import face_normals_loss as jax_face_loss
from facet_graph_convolution_tpu.models.unet import init_unet as jax_init_unet
from facet_graph_convolution_tpu.models.unet import unet_apply as jax_unet_apply
from facet_graph_convolution_tpu.models.unet import unet_apply_nminor as jax_unet_apply_nminor
from facet_graph_convolution_tpu.ops import conv as jconv
from facet_graph_convolution_tpu.ops.gather import gather_neighbors_lane as jax_gather_lane
from facet_graph_convolution_tpu.ops.normalization import init_moments_norm as jax_init_moments
from facet_graph_convolution_tpu.ops.normalization import moments_norm as jax_moments_norm
from facet_graph_convolution_tpu.ops.normalization import normalize_tensor as jax_normalize
from facet_graph_convolution_tpu.ops.pallas_kernels import weighted_aggregate as pallas_aggregate
from facet_graph_convolution_tpu.training.trainer import _apply_model, _graph_arrays, _patch_arrays
from facet_graph_convolution_tpu.training.trainer import (
    create_train_state as jax_create_train_state,
)
from facet_graph_convolution_tpu.training.trainer import (
    make_normals_train_step as jax_make_normals_train_step,
)
from facet_graph_convolution_torch import params as params_io
from facet_graph_convolution_torch.config import default_config
from facet_graph_convolution_torch.data.dataset import TrainingSet
from facet_graph_convolution_torch.graph.convert import lane_tables, slot_major_arrays
from facet_graph_convolution_torch.inference.driver import infer_directory
from facet_graph_convolution_torch.models.unet import (
    graph_tensors,
    init_unet,
    unet_apply,
    unet_apply_rowmajor,
)
from facet_graph_convolution_torch.ops import aggregate as k3
from facet_graph_convolution_torch.ops import conv
from facet_graph_convolution_torch.ops.gather import gather_neighbors_lane, gather_slots
from facet_graph_convolution_torch.ops.normalization import init_moments_norm, moments_norm
from facet_graph_convolution_torch.training.checkpoint import CheckpointManager
from facet_graph_convolution_torch.training.trainer import (
    adam_update,
    create_train_state,
    make_normals_train_step,
    normals_loss,
    patch_tensors,
    train_normals,
)
from tests.conftest import make_icosphere
from tests.test_models import make_pyramid_graph

GRAD_ATOL = 1e-4
RI = conv.FacetConvVariant.ROTATION_INVARIANT
JRI = jconv.FacetConvVariant.ROTATION_INVARIANT
MODEL = {"channels": (8, 16, 32), "num_filters": 4, "fc_channels": 64,
         "rotation_invariance": True}
TRAIN = {"loss_samples": 256, "save_every": 50, "eval_every": 10, "valid_every": 1000,
         "seed": 0}
SMALL = dict(channels=(8, 16, 32), num_filters=4, fc_channels=32)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small tensors: one intra-op thread, so that parallel test workers do
    not oversubscribe the CPU."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _random_graph(rng, n, k):
    """Raw one-indexed K-list: self slot, 0..k-2 random neighbours with
    repeats (multiplicities after dedupe), 0 pads; some rows self-only."""
    adj = np.zeros((n, k), np.int32)
    adj[:, 0] = np.arange(n) + 1
    for i in range(n):
        deg = int(rng.integers(0, k - 1))
        adj[i, 1:1 + deg] = rng.choice(n, size=deg, replace=True) + 1
    return adj


def _inputs(rng, n, in_ch):
    """Features with unit normals in the first 3 channels, an antiparallel
    and a +z normal, a zero row (a fake node) and, with 4 channels, a
    zero-area node."""
    x = rng.normal(size=(n, in_ch)).astype(np.float32)
    x[:, :3] /= np.linalg.norm(x[:, :3], axis=1, keepdims=True)
    x[1, :3] = (0.0, 0.0, -1.0)
    x[2, :3] = (0.0, 0.0, 1.0)
    x[4] = 0.0
    if in_ch == 4:
        x[6, 3] = 0.0
    return x


def _both_tables(adj):
    """The port's slot-major tables and the JAX package's lane tables of
    the same self-split deduped K-list."""
    nbr, mult_nbr, self_mult = jax_split(*jax_dedupe(adj))
    adjT, adjT_t = jax_lane_tables(nbr)
    return (slot_major_arrays(nbr, mult_nbr, self_mult),
            (adjT, adjT_t, jax_fused_mult_rows(mult_nbr, self_mult)))


def _layer(jparams):
    return params_io.params_from_jax({"l": jax.tree.map(np.asarray, jparams)}, device="cpu")["l"]


def _flat(tree):
    """(layer.name, array) pairs of a parameter tree, sorted."""
    return [(f"{layer}.{name}", tree[layer][name])
            for layer in sorted(tree) for name in sorted(tree[layer])]


# ---------------------------------------------------------------------------
# K3: the plain version, the wrapper and the autograd Function
# ---------------------------------------------------------------------------

def _assignment_inputs(rng, s, n, m):
    """Logits [S, N, M] and slot multipliers [S, N] (zeros in some pad
    slots, as the tables have them)."""
    logits = rng.normal(size=(s, n, m)).astype(np.float32)
    rows = rng.uniform(0.0, 1.0, size=(s, n)).astype(np.float32)
    rows[rng.uniform(size=(s, n)) < 0.2] = 0.0
    return logits, rows


def _jax_assigned(logits, rows):
    """JAX's q = softmax_M(logits)·rows of ``_facet_conv_nminor_rotinv``,
    node-minor [M, S, N]."""
    return jnp.transpose(jax.nn.softmax(logits, axis=-1), (2, 0, 1)) * rows[None]


def test_plain_aggregate_matches_pallas_interpret(rng):
    """At the JAX kernel test's shape (N = 512, K = 23, M = 9, C = 64):
    the plain K3 against ``weighted_aggregate(tile=256, interpret=True)``
    on JAX's ``softmax·rows``; the CPU wrapper takes the plain path and
    counts no launch."""
    n, k, m, c = 512, 23, 9, 64
    logits, rows = _assignment_inputs(rng, k, n, m)
    x = rng.normal(size=(k, n, c)).astype(np.float32)
    q = jnp.transpose(_jax_assigned(jnp.asarray(logits), jnp.asarray(rows)), (2, 1, 0))
    ref = np.asarray(pallas_aggregate(q, jnp.asarray(x.transpose(1, 0, 2)), tile=256,
                                      interpret=True))
    args = [torch.as_tensor(a) for a in (logits, rows, x)]
    z = k3.weighted_aggregate_plain(*args)
    assert z.shape == (n, m * c)
    np.testing.assert_allclose(z.numpy(), ref.reshape(n, m * c), atol=1e-4)
    before = k3.weighted_aggregate.launches
    assert torch.equal(k3.weighted_aggregate(*args), z)
    assert k3.weighted_aggregate.launches == before


@pytest.mark.parametrize("m", [4, 9])
def test_aggregate_and_its_function_match_aggregate_nminor(rng, m):
    """At a conv1 shape (S = 13 slots, C = 6): the plain K3 against JAX's
    ``softmax·rows`` then ``_aggregate_nminor``, and ``WeightedAggregate``'s
    dlogits and dx against ``jax.vjp`` of that composition; dx is computed
    only when asked for, and rows get no gradient."""
    s, n, c = 13, 300, 6
    logits, rows = _assignment_inputs(rng, s, n, m)
    x = rng.normal(size=(s, n, c)).astype(np.float32)
    dz = rng.normal(size=(n, m * c)).astype(np.float32)

    def composed(lg, xs):
        return jconv._aggregate_nminor(_jax_assigned(lg, jnp.asarray(rows)),
                                       jnp.transpose(xs, (2, 0, 1)))      # [M, C, N]

    z_j, vjp = jax.vjp(composed, jnp.asarray(logits), jnp.asarray(x))
    dlogits_j, dx_j = vjp(jnp.asarray(dz.reshape(n, m, c).transpose(1, 2, 0)))

    lt, xt = torch.as_tensor(logits).requires_grad_(), torch.as_tensor(x).requires_grad_()
    rt = torch.as_tensor(rows)
    z = k3.WeightedAggregate.apply(lt, rt, xt)
    np.testing.assert_allclose(z.detach().numpy(),
                               np.asarray(z_j).transpose(2, 0, 1).reshape(n, m * c), atol=1e-5)
    dlogits, dx = torch.autograd.grad(z, [lt, xt], torch.as_tensor(dz))
    np.testing.assert_allclose(dlogits.numpy(), np.asarray(dlogits_j), atol=1e-5)
    np.testing.assert_allclose(dx.numpy(), np.asarray(dx_j), atol=1e-5)

    l_only = torch.as_tensor(logits).requires_grad_()
    z_l = k3.WeightedAggregate.apply(l_only, rt, torch.as_tensor(x))
    calls = []
    einsum = torch.einsum
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch, "einsum", lambda eq, *ops: calls.append(eq) or einsum(eq, *ops))
        z_l.backward(torch.as_tensor(dz))
    assert calls == ["nmc,snc->snm"]                          # dq only, no dx
    np.testing.assert_allclose(l_only.grad.numpy(), dlogits.numpy(), atol=1e-6)


def test_aggregate_wrapper_refuses_what_it_does_not_take():
    """Mismatched shapes on any device; on a device that is neither the CPU
    nor CUDA, no kernel and no quiet fallback, forward and backward."""
    with pytest.raises(ValueError, match="differ"):
        k3.weighted_aggregate(torch.zeros(3, 8, 4), torch.ones(3, 8), torch.zeros(3, 9, 6))
    with pytest.raises(ValueError, match="differ"):
        k3.weighted_aggregate(torch.zeros(3, 8, 4), torch.ones(3, 9), torch.zeros(3, 8, 6))
    with pytest.raises(ValueError, match="need"):
        k3.weighted_aggregate(torch.zeros(3, 8, 4), torch.ones(3, 8), torch.zeros(24, 6))
    meta = torch.zeros((3, 8, 4), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        k3.weighted_aggregate(meta, torch.ones((3, 8), device="meta"),
                              torch.zeros((3, 8, 6), device="meta"))
    with pytest.raises(ValueError, match="no kernel"):
        k3.weighted_aggregate_bwd(meta, torch.ones((3, 8), device="meta"),
                                  torch.zeros((3, 8, 6), device="meta"),
                                  torch.zeros((8, 24), device="meta"))


def test_conv_reaches_k3_only_through_its_function(rng, monkeypatch):
    """The fault the K1 conv once had must not come back: a ctypes launch
    fills a fresh tensor without a grad_fn. Emulated with stand-ins for the
    launches that return such tensors (and count their calls): the
    rotation-invariant conv still has a gradient, equal to the unpatched
    one, because it calls K3 and its backward only through
    ``WeightedAggregate``, once each a forward and a backward."""
    (adj_sm, adj_t_sm, rows), _ = _both_tables(_random_graph(rng, 80, 7))
    x = torch.as_tensor(_inputs(rng, 80, 6))
    layer = _layer(jconv.init_facet_conv(jax.random.PRNGKey(2), 6, 8, 4, variant=JRI))

    def grads():
        p = {k: v.clone().requires_grad_() for k, v in layer.items()}
        y = conv.facet_conv(p, x, torch.as_tensor(adj_sm), torch.as_tensor(rows),
                            variant=RI, adj_t_sm=torch.as_tensor(adj_t_sm))
        return y, torch.autograd.grad((y * y).sum(), [p["u"], p["c"], p["w"]])

    _, want = grads()
    calls = []
    monkeypatch.setattr(k3, "weighted_aggregate", lambda lg, r, xs: calls.append("fwd") or
                        k3.weighted_aggregate_plain(lg, r, xs).detach())
    monkeypatch.setattr(k3, "weighted_aggregate_bwd",
                        lambda *a: calls.append("bwd") or k3.weighted_aggregate_bwd_plain(*a))
    y, got = grads()
    assert y.grad_fn is not None and calls == ["fwd", "bwd"]
    for g, ref in zip(got, want):
        np.testing.assert_allclose(g.numpy(), ref.numpy(), atol=1e-6)


# ---------------------------------------------------------------------------
# The scatter-free gathers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("form", ["slots", "lane"])
def test_gather_matches_jax_lane_gather(rng, form):
    """Values and x-gradients of ``gather_slots`` (the port's padded
    slot-major tables) and ``gather_neighbors_lane`` with its transpose map,
    against JAX ``gather_neighbors_lane`` (the zero-column ``_gather_lane``
    and its scatter-free backward). Pad slots gather zeros."""
    n, c = 150, 5
    adj = _random_graph(rng, n, 9)
    (adj_sm, adj_t_sm, _), (adjT, adjT_t, _) = _both_tables(adj)
    k = adjT.shape[0]
    x = rng.normal(size=(n, c)).astype(np.float32)
    g = rng.normal(size=(c, k, n)).astype(np.float32)
    out_j, vjp = jax.vjp(lambda xt: jax_gather_lane(xt, jnp.asarray(adjT), jnp.asarray(adjT_t)),
                         jnp.asarray(x.T))
    (dx_j,) = vjp(jnp.asarray(g))

    if form == "slots":
        n_pad = adj_sm.shape[1]
        assert n_pad > n
        xt = torch.as_tensor(np.pad(x, ((0, n_pad - n), (0, 0)))).requires_grad_()
        out = gather_slots(xt, torch.as_tensor(adj_sm), torch.as_tensor(adj_t_sm))
        np.testing.assert_array_equal(out[:, :n].detach().numpy(),
                                      np.asarray(out_j).transpose(1, 2, 0))
        assert not out[:, n:].any()                          # padded nodes gather zeros
        g_t = np.zeros((k, n_pad, c), np.float32)
        g_t[:, :n] = g.transpose(1, 2, 0)
        g_t[:, n:] = rng.normal(size=(k, n_pad - n, c))      # read nothing real
        (dx,) = torch.autograd.grad(out, xt, torch.as_tensor(g_t))
        np.testing.assert_allclose(dx[:n].numpy(), np.asarray(dx_j).T, atol=1e-6)
        assert not dx[n:].any()
    else:
        ours = lane_tables(jax_split(*jax_dedupe(adj))[0])
        for a, b in zip(ours, (adjT, adjT_t)):
            np.testing.assert_array_equal(a, b)
        xt = torch.as_tensor(x.T.copy()).requires_grad_()
        out = gather_neighbors_lane(xt, torch.as_tensor(adjT), torch.as_tensor(adjT_t))
        np.testing.assert_array_equal(out.detach().numpy(), np.asarray(out_j))
        (dx,) = torch.autograd.grad(out, xt, torch.as_tensor(g))
        np.testing.assert_allclose(dx.numpy(), np.asarray(dx_j), atol=1e-6)
    assert (adj_sm == 0).any()                               # pad slots exercised


@pytest.mark.parametrize("form", ["slots", "lane"])
def test_gather_backward_is_repeatable_and_matches_index_select(rng, form):
    """The transpose-map backward gives the same bits on two calls, and the
    gradient of autograd through the plain ``index_select`` form (its
    scatter) to atol 1e-6 (the same sums in another order)."""
    n, c = 300, 7
    (adj_sm, adj_t_sm, _), (adjT, adjT_t, _) = _both_tables(_random_graph(rng, n, 12))
    if form == "slots":
        x = rng.normal(size=(adj_sm.shape[1], c)).astype(np.float32)
        adj, adj_t = torch.as_tensor(adj_sm), torch.as_tensor(adj_t_sm)

        def fast(t):
            return gather_slots(t, adj, adj_t)

        def plain(t):
            return torch.cat([t.new_zeros(1, c), t]).index_select(
                0, adj.reshape(-1).long()).reshape(*adj.shape, c)
    else:
        x = rng.normal(size=(c, n)).astype(np.float32)
        adj, adj_t = torch.as_tensor(adjT), torch.as_tensor(adjT_t)

        def fast(t):
            return gather_neighbors_lane(t, adj, adj_t)

        def plain(t):
            return gather_neighbors_lane(t, adj)

    g = None
    grads = []
    for fn in (fast, fast, plain):
        xt = torch.as_tensor(x).requires_grad_()
        out = fn(xt)
        if g is None:
            g = torch.as_tensor(rng.normal(size=tuple(out.shape)).astype(np.float32))
        grads.append(torch.autograd.grad(out, xt, g)[0])
    assert torch.equal(grads[0], grads[1])
    np.testing.assert_allclose(grads[0].numpy(), grads[2].numpy(), atol=1e-6)


# ---------------------------------------------------------------------------
# The rotation-invariant conv
# ---------------------------------------------------------------------------

def test_rotation_to_axis_matches_jax(rng):
    """Random unit normals, +z, −z (antiparallel: R = I, the guard), a
    near-+z normal, a zero normal; R maps each regular normal to +z."""
    normals = rng.normal(size=(40, 3)).astype(np.float32)
    normals /= np.linalg.norm(normals, axis=1, keepdims=True)
    normals[1] = (0.0, 0.0, 1.0)
    normals[2] = (0.0, 0.0, -1.0)
    normals[3] = (1e-7, 0.0, 1.0)
    normals[4] = 0.0
    rot = conv.rotation_to_axis(torch.as_tensor(normals)).numpy()
    np.testing.assert_allclose(rot, np.asarray(jconv.rotation_to_axis(jnp.asarray(normals))),
                               atol=1e-6)
    np.testing.assert_array_equal(rot[2], np.eye(3, dtype=np.float32))
    regular = [i for i in range(40) if i not in (2, 4)]
    np.testing.assert_allclose(np.einsum("nij,nj->ni", rot, normals)[regular],
                               np.tile([0.0, 0.0, 1.0], (len(regular), 1)), atol=1e-5)


@pytest.mark.parametrize("self_slot", [False, True])
@pytest.mark.parametrize("in_ch", [3, 4, 6])
def test_rotation_invariant_feats_match_jax(rng, in_ch, self_slot):
    """Slot-major features against the JAX package's [N, K(+1), C] ones,
    with an antiparallel normal, a zero row, zero (pad) neighbours and, at
    4 channels, a zero-area centre (ratio 0, not NaN)."""
    n, k = 60, 8
    x = _inputs(rng, n, in_ch)
    x_nbr = rng.normal(size=(n, k, in_ch)).astype(np.float32)
    x_nbr[:, -2:] = 0.0                                        # pad slots
    ref = np.asarray(jconv._rotation_invariant_feats(jnp.asarray(x), jnp.asarray(x_nbr),
                                                     self_slot=self_slot))
    feats = conv._rotation_invariant_feats(torch.as_tensor(x),
                                           torch.as_tensor(x_nbr.transpose(1, 0, 2).copy()),
                                           self_slot=self_slot)
    assert feats.shape == (k + self_slot, n, in_ch) and torch.isfinite(feats).all()
    np.testing.assert_allclose(feats.numpy().transpose(1, 0, 2), ref, atol=1e-6)
    with pytest.raises(ValueError, match="3/4/6"):
        conv._rotation_invariant_feats(torch.zeros(4, 5), torch.zeros(2, 4, 5), self_slot)


@pytest.mark.parametrize("in_ch", [3, 4, 6])
def test_rotinv_conv_matches_jax(rng, in_ch):
    """The port's rotation-invariant ``facet_conv`` (padded slot-major
    tables, K3 through ``WeightedAggregate``) against JAX
    ``facet_conv_nminor(variant=ROTATION_INVARIANT, lane=True)``: values,
    and the gradients of u, c, w, b and x."""
    n = 150
    (adj_sm, adj_t_sm, rows), (adjT, adjT_t, rows_l) = _both_tables(_random_graph(rng, n, 9))
    assert rows.shape[1] > n                                   # padded node axis
    x = _inputs(rng, n, in_ch)
    r = rng.normal(size=(n, 8)).astype(np.float32)
    jparams = jconv.init_facet_conv(jax.random.PRNGKey(in_ch), in_ch, 8, 4, variant=JRI)
    assert "v" not in jparams

    def jloss(p, xx):
        y = jconv.facet_conv_nminor(p, xx.T, jnp.asarray(adjT), jnp.asarray(adjT_t),
                                    jnp.asarray(rows_l), variant=JRI, lane=True).T
        return jnp.sum(y * r), y

    (_, y_j), (g_p, g_x) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jparams, jnp.asarray(x))
    params = {k: v.requires_grad_() for k, v in _layer(jparams).items()}
    xt = torch.as_tensor(x).requires_grad_()
    y = conv.facet_conv(params, xt, torch.as_tensor(adj_sm), torch.as_tensor(rows),
                        variant=RI, adj_t_sm=torch.as_tensor(adj_t_sm))
    (y * torch.as_tensor(r)).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_j), atol=2e-5)
    assert set(params) == set(g_p) == {"w", "b", "u", "c"}
    for name in g_p:
        np.testing.assert_allclose(params[name].grad.numpy(), np.asarray(g_p[name]),
                                   atol=5e-4, rtol=5e-4, err_msg=name)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(g_x), atol=5e-4, rtol=5e-4)


def test_per_conv_variants_reference_semantics():
    v = conv.FacetConvVariant
    for variant in v:
        ours = conv.per_conv_variants(variant)
        ref = jconv.per_conv_variants(jconv.FacetConvVariant(variant.value))
        assert [a.value for a in ours] == [a.value for a in ref]
    assert conv.per_conv_variants(RI) == (RI, v.DEFAULT)


# ---------------------------------------------------------------------------
# The U-Net, the train step and the training loop
# ---------------------------------------------------------------------------

def test_rotinv_unet_matches_jax(rng):
    """init_unet's layout (conv1 without v, the other convs with it), and
    unet_apply over the port's tables against JAX ``unet_apply_nminor(...,
    variant=ri, lane=True)`` from converted parameters; the port's own
    row-major oracle gives the same."""
    ours = init_unet(0, device="cpu", variant=RI, **SMALL)
    assert "v" not in ours["conv1"] and all("v" in ours[k] for k in ours if "conv" in k
                                            and k != "conv1")
    jparams = jax_init_unet(jax.random.PRNGKey(0), in_channels=6, variant=JRI, **SMALL)
    assert {k: set(v) for k, v in ours.items()} == {k: set(v) for k, v in jparams.items()}
    adjs = make_pyramid_graph(rng)
    x = _inputs(rng, 64, 6)
    adjs_l, adj_ts_l, mults_l = _graph_arrays([np.asarray(a) for a in adjs])
    y_j = jax_unet_apply_nminor(jparams, jnp.asarray(x), adjs_l, adj_ts_l,
                                [mm["rows_lane"] for mm in mults_l], variant=JRI, lane=True)
    params = params_io.params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    t_adjs, t_rows = graph_tensors([np.asarray(a) for a in adjs], "cpu")
    y = unet_apply(params, torch.as_tensor(x), t_adjs, t_rows, variant=RI)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_j), atol=3e-5)
    y_row = unet_apply_rowmajor(params, torch.as_tensor(x),
                                [torch.as_tensor(np.array(a)) for a in adjs], variant=RI)
    np.testing.assert_allclose(y_row.numpy(), y.numpy(), atol=3e-5)


@pytest.fixture(scope="module")
def sphere_patch():
    """A noisy subdivision-2 icosphere with GT, one patch (JAX host code)."""
    v, f = make_icosphere(2)
    noisy = (v + np.random.default_rng(3).normal(scale=0.02, size=v.shape)).astype(np.float32)
    ds = JaxTrainingSet(max_patch_size=20000, coarsening_steps=2, coarsening_levels=3,
                        k_faces=23, seed=0)
    ds.add_mesh(noisy, f, gt_vertices=v)
    return ds.patches[0]


def test_rotinv_train_steps_match_jax(sphere_patch):
    """Three rotation-invariant steps of JAX's make_normals_train_step on
    _patch_arrays(patch) (lane tables) against the port, each step's
    rotation and loss samples derived from JAX's key as trainer.py:125-130
    does and injected into the port: the loss and the scaled gradients at
    each step, and the parameters after 1 and 3 Adam updates fed JAX's
    gradients (as tests/test_torch_train.py::test_train_steps_match_jax)."""
    jcfg = jax_default_config().replace(model=MODEL, train=TRAIN)
    cfg = default_config().replace(model=MODEL, train=TRAIN)
    jstate, tx = jax_create_train_state(jax.random.PRNGKey(0), jcfg)
    assert "v" not in jstate.params["conv1"]
    jstep = jax_make_normals_train_step(tx, jcfg)
    x, adjs, gt, adj_ts, mults = _patch_arrays(sphere_patch)

    def jloss(params, rot, idx):
        y = _apply_model(params, jax_rotate_inputs(rot, x), adjs, adj_ts, mults, steps=2,
                         variant=JRI, alpha=0.1)
        g = jax_rotate_vec3(rot, gt)
        return jax_face_loss(jnp.take(jax_normalize(y), idx, axis=0), jnp.take(g, idx, axis=0))

    state = create_train_state(cfg, device="cpu", params=params_io.params_from_jax(
        jax.tree.map(np.asarray, jstate.params), device="cpu"))
    tensors = patch_tensors(sphere_patch, "cpu")
    leaves = [t for _, t in _flat(state.params)]
    jgrad = jax.jit(jax.value_and_grad(jloss))
    for i in range(3):
        key = jax.random.PRNGKey(10 + i)
        rot_key, samp_key = jax.random.split(key)
        rot = jax_random_rotation(rot_key)
        idx = jax.random.randint(samp_key, (cfg.train.loss_samples,), 0, x.shape[0])
        j_loss, j_grads = jgrad(jstate.params, rot, idx)
        rot_t, idx_t = torch.tensor(np.asarray(rot)), torch.tensor(np.asarray(idx))
        loss = normals_loss(state.params, cfg, *tensors, idx_t, rot_t)
        grads = torch.autograd.grad(loss, leaves)
        assert abs(float(loss.detach()) - float(j_loss)) < 1e-4
        for (name, jg), g in zip(_flat(jax.tree.map(np.asarray, j_grads)), grads):
            scale = max(float(np.abs(jg).max()), 1e-30)
            np.testing.assert_allclose(g.numpy() / scale, jg / scale, atol=GRAD_ATOL,
                                       err_msg=name)
        if i == 0:
            # the port's own step, with the same rotation and samples
            probe = create_train_state(cfg, device="cpu", params=state.params)
            probe, step_loss = make_normals_train_step(cfg)(
                probe, *tensors, rot=rot_t, sample_idx=idx_t)
            assert probe.step == 1 and abs(float(step_loss) - float(j_loss)) < 1e-4
        jstate, jl = jstep(jstate, x, adjs, gt, key, adj_ts, mults)
        assert abs(float(jl) - float(j_loss)) < 1e-4
        for leaf, (_, jg) in zip(leaves, _flat(jax.tree.map(np.asarray, j_grads))):
            leaf.grad = torch.tensor(jg)
        adam_update(state)
        if i in (0, 2):
            for (name, jp), t in zip(_flat(jax.tree.map(np.asarray, jstate.params)), leaves):
                np.testing.assert_allclose(t.detach().numpy(), jp, atol=1e-7,
                                           err_msg=f"step {i + 1}: {name}")
    assert state.step == int(jstate.step) == 3


@pytest.fixture(scope="module")
def port_sphere_set():
    v, f = make_icosphere(2)
    noisy = (v + np.random.default_rng(3).normal(scale=0.02, size=v.shape)).astype(np.float32)
    ds = TrainingSet(max_patch_size=20000, coarsening_steps=2, coarsening_levels=3,
                     k_faces=23, seed=0)
    ds.add_mesh(noisy, f, gt_vertices=v)
    return ds


def test_train_normals_rotinv_end_to_end(port_sphere_set, tmp_path):
    """train_normals with rotation_invariance on the CPU: finite losses,
    checkpoints whose conv1 has no v, a resumed run continuing from the
    last one, and a validation sweep through the eval step."""
    cfg = default_config().replace(model=MODEL, train={
        **TRAIN, "network_path": str(tmp_path) + "/", "save_every": 4, "eval_every": 2,
        "valid_every": 4})
    state, hist = train_normals(cfg, port_sphere_set, valid_set=port_sphere_set,
                                num_iterations=8, bucket_align=64, device="cpu")
    assert state.step == 8 and np.isfinite(hist[:, 0]).all() and np.isfinite(hist[1:, 1]).all()
    served = params_io.load(params_io.checkpoint_path(cfg.train.network_path, "net"), "cpu")
    assert "v" not in served["conv1"] and "v" in served["conv2"]
    mgr = CheckpointManager(cfg.train.network_path, cfg.train.net_name)
    assert mgr.steps() == [4, 8]
    restored, step = mgr.restore(create_train_state(cfg, device="cpu"))
    assert step == 8 and "v" not in restored.params["conv1"]
    for (_, a), (_, b) in zip(_flat(restored.params), _flat(state.params)):
        assert torch.equal(a.detach(), b.detach())
    more, _ = train_normals(cfg, port_sphere_set, num_iterations=2, bucket_align=64,
                            device="cpu")
    assert more.step == 10 and mgr.latest_step() == 10


def test_infer_directory_refuses_a_rotation_invariant_network(tmp_path):
    """Neither package serves a rotation-invariant conv1 (the JAX drivers
    run the default variant and miss its v): the port says so."""
    params = init_unet(0, device="cpu", variant=RI, **SMALL)
    cfg = default_config().replace(eval={"results_path": str(tmp_path / "out") + "/"})
    for with_vertices in (False, True):
        with pytest.raises(ValueError, match="rotation-invariant conv1"):
            infer_directory(str(tmp_path), cfg, with_vertices=with_vertices, params=params,
                            device="cpu")


# ---------------------------------------------------------------------------
# The row-major oracles and the other convs of the variant matrix
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant", ["default", "translation_invariant", "rotation_invariant"])
def test_facet_conv_gather_and_rowmajor_match_jax(rng, variant):
    """facet_conv_gather and facet_conv_rowmajor over a raw K-list against
    JAX facet_conv_gather and the row-major facet_conv, with and without the
    bias mask."""
    n = 61
    adj = _random_graph(rng, n, 9)
    adj[7] = 0                                                 # a row with no slot at all
    x = _inputs(rng, n, 6)
    jvar = jconv.FacetConvVariant(variant)
    jparams = jconv.init_facet_conv(jax.random.PRNGKey(5), 6, 8, 4, variant=jvar)
    params = _layer(jparams)
    for bias_mask in (True, False):
        ref = np.asarray(jconv.facet_conv_gather(jparams, jnp.asarray(x), jnp.asarray(adj),
                                                 variant=jvar, bias_mask=bias_mask))
        fast = np.asarray(jconv.facet_conv(jparams, jnp.asarray(x), jnp.asarray(adj),
                                           variant=jvar, bias_mask=bias_mask))
        args = (params, torch.as_tensor(x), torch.as_tensor(adj), variant)
        np.testing.assert_allclose(conv.facet_conv_gather(*args, bias_mask=bias_mask).numpy(),
                                   ref, atol=1e-5)
        np.testing.assert_allclose(conv.facet_conv_rowmajor(*args, bias_mask=bias_mask).numpy(),
                                   fast, atol=1e-5)
    np.testing.assert_allclose(
        conv.assignment_weights(*args).numpy(),
        np.asarray(jconv.assignment_weights(jparams, jnp.asarray(x), jnp.asarray(adj), jvar)),
        atol=1e-6)


@pytest.mark.parametrize("translation_invariance", [False, True])
def test_position_assignment_convs_match_jax(rng, translation_invariance):
    """The pos-for-assignment and only-pos-for-assignment convs: init
    layouts, values and parameter gradients against the JAX package."""
    n = 61
    adj = _random_graph(rng, n, 9)
    x = rng.normal(size=(n, 9)).astype(np.float32)
    r = rng.normal(size=(n, 8)).astype(np.float32)
    cases = (
        (jconv.init_facet_conv_pos_assignment, jconv.facet_conv_pos_assignment,
         conv.init_facet_conv_pos_assignment, conv.facet_conv_pos_assignment),
        (jconv.init_facet_conv_only_pos_assignment, jconv.facet_conv_only_pos_assignment,
         conv.init_facet_conv_only_pos_assignment, conv.facet_conv_only_pos_assignment),
    )
    for j_init, j_conv, init, fn in cases:
        jparams = j_init(jax.random.PRNGKey(1), 9, 8, 4,
                         translation_invariance=translation_invariance)
        ours = init(9, 8, 4, translation_invariance=translation_invariance, device="cpu")
        assert {k: tuple(v.shape) for k, v in ours.items()} == {
            k: tuple(v.shape) for k, v in jparams.items()}
        j_val, j_grad = jax.value_and_grad(lambda p: jnp.sum(
            j_conv(p, jnp.asarray(x), jnp.asarray(adj)) * r))(jparams)
        params = {k: v.requires_grad_() for k, v in _layer(jparams).items()}
        val = (fn(params, torch.as_tensor(x), torch.as_tensor(adj)) * torch.as_tensor(r)).sum()
        val.backward()
        np.testing.assert_allclose(float(val.detach()), float(j_val), atol=1e-4)
        for name in j_grad:
            np.testing.assert_allclose(params[name].grad.numpy(), np.asarray(j_grad[name]),
                                       atol=1e-5, err_msg=name)


def test_moments_norm_matches_jax(rng):
    x = rng.normal(loc=2.0, size=(50, 7)).astype(np.float32)
    jparams = jax_init_moments(jax.random.PRNGKey(0), 7)
    ours = init_moments_norm(7, device="cpu")
    assert {k: tuple(v.shape) for k, v in ours.items()} == {
        k: tuple(v.shape) for k, v in jparams.items()}
    params = _layer(jparams)
    np.testing.assert_allclose(moments_norm(params, torch.as_tensor(x)).numpy(),
                               np.asarray(jax_moments_norm(jparams, jnp.asarray(x))), atol=1e-5)


@pytest.mark.parametrize("variant", ["default", "translation_invariant", "rotation_invariant"])
def test_unet_apply_rowmajor_matches_jax(rng, variant):
    """unet_apply_rowmajor against the JAX row-major unet_apply over raw
    K-lists: values (atol 3e-5) and every parameter's gradient (atol = rtol
    = 5e-4)."""
    adjs = make_pyramid_graph(rng)
    x = _inputs(rng, 64, 6)
    r = rng.normal(size=(64, 3)).astype(np.float32)
    jvar = jconv.FacetConvVariant(variant)
    jparams = jax_init_unet(jax.random.PRNGKey(1), in_channels=6, variant=jvar, **SMALL)
    y_j, vjp = jax.vjp(lambda p: jax_unet_apply(p, jnp.asarray(x), adjs, variant=jvar), jparams)
    (j_grad,) = vjp(jnp.asarray(r))
    params = {layer: {k: t.requires_grad_() for k, t in leaves.items()} for layer, leaves in
              params_io.params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu").items()}
    y = unet_apply_rowmajor(params, torch.as_tensor(x),
                            [torch.as_tensor(np.array(a)) for a in adjs], variant=variant)
    y.backward(torch.as_tensor(r))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_j), atol=3e-5)
    for (name, jg), (_, t) in zip(_flat(jax.tree.map(np.asarray, j_grad)), _flat(params)):
        np.testing.assert_allclose(t.grad.numpy(), jg, atol=5e-4, rtol=5e-4, err_msg=name)
