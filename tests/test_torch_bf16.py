"""The port's bfloat16 compute (``compute_dtype="bfloat16"``) against the JAX
package's, on the CPU.

On CPU tensors the K1, K2 and K3 wrappers run their plain versions, which
keep the kernels' bfloat16 contract (upcast, f32 inside, round once), so
these tests hold those versions, the conv, the U-Net, the train step and the
training loop under ``compute_dtype="bfloat16"`` against the JAX package's
bfloat16 paths, with the Pallas kernels in interpret mode. Inputs are drawn
from a numpy seed and rounded to bfloat16 once, the same values on both
sides. Small widths (channels 8/16/32, M = 4, fc 32-64).

Tolerances, each scaled by the reference's largest magnitude: the plain
K1/K2 against JAX ``conv_epilogue`` and its VJP 1e-2 (JAX rounds each slot's
dg row to bfloat16 before the transpose sum, the port rounds dcat once after
it; z and dux round in both); the plain K3 against the Pallas
``weighted_aggregate`` 2^-8 (the port rounds z to bfloat16, one rounding of
at most 2^-9 relative); the conv, the U-Net and the train step's gradients
at the bounds of ``tests/test_variant_matrix.py:197-231``, 0.03 for values
and 0.05 for gradients (bfloat16 roundings at other places in the two
frameworks: the rotation-invariant JAX path rounds every slot product, the
products' backward rounds its cotangent in the port); the train step's
losses 2e-2 relative. Paths that ignore ``compute_dtype`` (eval, vertex
training, serving) equal the float32 config's bit for bit.
"""

import contextlib
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import facet_graph_convolution_tpu.ops.pallas_conv as pallas_conv
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
from facet_graph_convolution_tpu.ops import conv as jconv
from facet_graph_convolution_tpu.ops.normalization import normalize_tensor as jax_normalize
from facet_graph_convolution_tpu.ops.pallas_conv import conv_epilogue, gather_slot_major
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
from facet_graph_convolution_torch.data.dataset import InferenceMesh, TrainingSet
from facet_graph_convolution_torch.data.synthetic import add_vertex_noise, icosphere
from facet_graph_convolution_torch.graph.convert import slot_major_arrays
from facet_graph_convolution_torch.inference.driver import infer_normals
from facet_graph_convolution_torch.models.unet import init_unet, train_graph_tensors, unet_apply
from facet_graph_convolution_torch.ops import aggregate as k3
from facet_graph_convolution_torch.ops import facet_conv_kernel as k1
from facet_graph_convolution_torch.ops.conv import Bf16Matmul, FacetConvVariant, facet_conv
from facet_graph_convolution_torch.training import trainer
from facet_graph_convolution_torch.training.checkpoint import CheckpointManager
from facet_graph_convolution_torch.training.trainer import (
    create_train_state,
    make_normals_eval_step,
    make_normals_train_step,
    make_scanned_train_step,
    normals_draws,
    normals_loss,
    patch_tensors,
    stack_patch_tensors,
    train_normals,
    train_with_vertices,
)
from tests.conftest import make_icosphere
from tests.test_models import make_pyramid_graph

BF16 = torch.bfloat16
EPILOGUE_TOL = 1e-2          # K1/K2 against conv_epilogue, × max|ref|
AGGREGATE_TOL = 2.0 ** -8    # K3 against the Pallas kernel, × max|ref|
VALUE_TOL, GRAD_TOL = 0.03, 0.05   # tests/test_variant_matrix.py:197-231
LOSS_RTOL = 2e-2
SMALL = dict(channels=(8, 16, 32), num_filters=4, fc_channels=32)
MODEL = {"channels": (8, 16, 32), "num_filters": 4, "fc_channels": 64}
TRAIN = {"loss_samples": 256, "save_every": 50, "eval_every": 10, "valid_every": 1000,
         "seed": 0}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small tensors: one intra-op thread, so that parallel test workers do
    not oversubscribe the CPU."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@contextlib.contextmanager
def pallas_interpret():
    """Run the JAX package's Pallas epilogue in interpret mode on the CPU."""
    orig = pallas_conv.facet_conv_pallas
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pallas_conv, "facet_conv_pallas",
                   lambda *a, **kw: orig(*a, **{**kw, "interpret": True}))
        yield


def _random_graph(rng, n, k):
    """Raw one-indexed K-list: self slot, 0..k-2 random neighbours with
    repeats (multiplicities after dedupe), 0 pads; some rows self-only."""
    adj = np.zeros((n, k), np.int32)
    adj[:, 0] = np.arange(n) + 1
    for i in range(n):
        deg = int(rng.integers(0, k - 1))
        adj[i, 1:1 + deg] = rng.choice(n, size=deg, replace=True) + 1
    return adj


def _bf16(rng, *shape):
    """Normal draws rounded to bfloat16 once: a float32 array whose values
    both frameworks hold exactly in bfloat16."""
    x = torch.as_tensor(rng.normal(size=shape).astype(np.float32)).to(BF16)
    return x.float().numpy()


def _unit_inputs(rng, n, in_ch):
    """Features with unit normals in the first 3 channels."""
    x = rng.normal(size=(n, in_ch)).astype(np.float32)
    x[:, :3] /= np.linalg.norm(x[:, :3], axis=1, keepdims=True)
    return x


def _flat(tree):
    """(layer.name, array) pairs of a parameter tree, sorted."""
    return [(f"{layer}.{name}", tree[layer][name])
            for layer in sorted(tree) for name in sorted(tree[layer])]


def _close(got, want, tol, what):
    """max |got - want| within ``tol`` × max|want| (the scale floored at
    1e-3, as tests/test_variant_matrix.py does for gradients)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-3)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: max abs err {err} > {tol} × {scale}"


# ---------------------------------------------------------------------------
# The kernels' plain versions and their autograd Functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,k,c_in,m", [(61, 9, 5, 4), (300, 12, 16, 9)])
def test_plain_bf16_epilogue_matches_conv_epilogue(rng, n, k, c_in, m):
    """``FacetConvEpilogue`` over the plain K1/K2 on bfloat16 cat and ux
    against JAX ``conv_epilogue(compute_dtype=bfloat16, interpret=True)``
    after ``gather_slot_major``, and its VJP: z, dcat and ux's cotangent in
    bfloat16, dc in f32."""
    a_u, mult = jax_dedupe(_random_graph(rng, n, k))
    adj_sm, adj_t_sm, rows = slot_major_arrays(*jax_split(a_u, mult))
    n_pad = adj_sm.shape[1]
    cat, ux = _bf16(rng, n_pad, c_in + m), _bf16(rng, n_pad, m)
    c = rng.normal(size=(m,)).astype(np.float32)
    dz = _bf16(rng, n_pad, m * c_in)

    def jz(cat_, ux_, c_):
        gathered = gather_slot_major(cat_, jnp.asarray(adj_sm), jnp.asarray(adj_t_sm))
        return conv_epilogue(gathered, cat_, ux_, jnp.asarray(rows), c_.reshape(1, -1),
                             jnp.bfloat16, True)

    z_j, vjp = jax.vjp(jz, jnp.asarray(cat, jnp.bfloat16), jnp.asarray(ux, jnp.bfloat16),
                       jnp.asarray(c))
    dcat_j, dux_j, dc_j = vjp(jnp.asarray(dz, jnp.bfloat16))

    cat_t = torch.tensor(cat).to(BF16).requires_grad_()
    ux_t = torch.tensor(ux).to(BF16).requires_grad_()
    c_t = torch.tensor(c).requires_grad_()
    z = k1.FacetConvEpilogue.apply(cat_t, ux_t, c_t, torch.as_tensor(adj_sm),
                                   torch.as_tensor(adj_t_sm), torch.as_tensor(rows[:, :, 0]))
    dcat, dux, dc = torch.autograd.grad(z, [cat_t, ux_t, c_t], torch.tensor(dz).to(BF16))
    assert (z.dtype, dcat.dtype, dux.dtype, dc.dtype) == (BF16, BF16, BF16, torch.float32)
    for got, want, what in ((z, z_j, "z"), (dcat, dcat_j, "dcat"), (dux, dux_j, "dux"),
                            (dc, dc_j.reshape(-1), "dc")):
        _close(got.detach().float().numpy(), np.asarray(want, np.float32), EPILOGUE_TOL, what)

    # the wrappers on CPU tensors are the plain versions, and count nothing
    args = (cat_t.detach(), ux_t.detach(), torch.as_tensor(adj_sm),
            torch.as_tensor(rows[:, :, 0]), c_t.detach())
    before = (k1.facet_conv_fwd.launches, k1.facet_conv_fwd.launches_bf16)
    assert torch.equal(k1.facet_conv_fwd(*args), k1.facet_conv_fwd_plain(*args))
    assert (k1.facet_conv_fwd.launches, k1.facet_conv_fwd.launches_bf16) == before


@pytest.mark.parametrize("n,s,m,c,tile", [(256, 13, 9, 6, 128), (512, 23, 9, 64, 256)])
def test_plain_bf16_aggregate_matches_pallas_interpret(rng, n, s, m, c, tile):
    """The plain K3 on f32 logits and rows and bfloat16 slots against the
    Pallas ``weighted_aggregate(interpret=True)`` on JAX's bfloat16
    ``softmax·rows`` and the same bfloat16 slots (which sums in f32 and
    writes f32): z in bfloat16, within one rounding."""
    logits = rng.normal(size=(s, n, m)).astype(np.float32)
    rows = rng.uniform(0.0, 1.0, size=(s, n)).astype(np.float32)
    x = _bf16(rng, n, s, c)
    q = (jax.nn.softmax(jnp.asarray(logits), axis=-1) * jnp.asarray(rows)[..., None]).astype(
        jnp.bfloat16)
    ref = np.asarray(pallas_aggregate(jnp.transpose(q, (1, 0, 2)), jnp.asarray(x, jnp.bfloat16),
                                      tile=tile, interpret=True), np.float32)
    args = (torch.tensor(logits), torch.tensor(rows),
            torch.tensor(x.transpose(1, 0, 2).copy()).to(BF16))
    z = k3.weighted_aggregate_plain(*args)
    assert z.dtype == BF16 and z.shape == (n, m * c)
    _close(z.float().numpy(), ref.reshape(n, m * c), AGGREGATE_TOL, "z")
    assert torch.equal(k3.weighted_aggregate(*args), z)


def test_bf16_matmul_is_the_f32_product_of_bf16_operands(rng):
    """``Bf16Matmul`` on the CPU: y the f32 product of the bfloat16 values
    (exact products, f32 sums), dz the bf16-rounded product of the
    bf16-rounded cotangent, dw in w's dtype."""
    z = torch.tensor(_bf16(rng, 40, 24)).to(BF16).requires_grad_()
    w = torch.tensor(_bf16(rng, 8, 24)).to(BF16).requires_grad_()
    y = Bf16Matmul.apply(z, w)
    assert y.dtype == torch.float32
    assert torch.equal(y, z.detach().float() @ w.detach().float().T)
    exact = z.detach().double() @ w.detach().double().T         # f32 sums, 24 terms
    np.testing.assert_allclose(y.detach().numpy(), exact.numpy(), rtol=1e-5, atol=1e-5)
    dy = torch.tensor(rng.normal(size=(40, 8)).astype(np.float32))
    dz, dw = torch.autograd.grad(y, [z, w], dy)
    g = dy.to(BF16).float()
    assert dz.dtype == dw.dtype == BF16
    assert torch.equal(dz, (g @ w.detach().float()).to(BF16))
    assert torch.equal(dw, (g.T @ z.detach().float()).to(BF16))


def test_the_kernel_operator_gives_z_in_cats_dtype(rng):
    """The ``torch.library`` operator of K1 gives z in cat's dtype, from its
    implementation and from its fake (what ``torch.export`` traces)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    a_u, mult = jax_dedupe(_random_graph(rng, 40, 7))
    adj_sm, _, rows = slot_major_arrays(*jax_split(a_u, mult))
    n_pad = adj_sm.shape[1]
    args = [torch.tensor(_bf16(rng, n_pad, 9)).to(BF16),
            torch.tensor(_bf16(rng, n_pad, 4)).to(BF16),
            torch.as_tensor(adj_sm), torch.as_tensor(rows[:, :, 0]), torch.zeros(4)]
    assert k1.facet_conv_fwd_op(*args).dtype == BF16
    with FakeTensorMode() as mode:
        fake = k1.facet_conv_fwd_op(*[mode.from_tensor(t) for t in args])
    assert fake.dtype == BF16 and tuple(fake.shape) == (n_pad, 4 * 5)


def test_wrappers_refuse_mixed_dtypes():
    """K1, K2 and K3 refuse cat/ux/dz (logits/slots, slots/dz) of dtypes
    that do not go together on every device, here the CPU; the conv refuses
    a compute dtype it has no kernel for."""
    n, m, c_in = 8, 4, 5
    cat = torch.zeros(n, c_in + m, dtype=BF16)
    ux = torch.zeros(n, m, dtype=BF16)
    adj = torch.zeros(2, n, dtype=torch.int32)
    rows = torch.ones(3, n)
    c = torch.zeros(m)
    with pytest.raises(TypeError, match="ux"):
        k1.facet_conv_fwd(cat, ux.float(), adj, rows, c)
    with pytest.raises(TypeError, match="dz"):
        k1.facet_conv_bwd(cat, ux, adj, torch.zeros(n, 2, dtype=torch.int32), rows, c,
                          torch.zeros(n, m * c_in))
    with pytest.raises(TypeError, match="logits must be torch.float32"):
        k3.weighted_aggregate(torch.zeros(3, n, m, dtype=BF16), torch.ones(3, n),
                              torch.zeros(3, n, 6, dtype=BF16))
    with pytest.raises(TypeError, match="dz"):
        k3.weighted_aggregate_bwd(torch.zeros(3, n, m), torch.ones(3, n),
                                  torch.zeros(3, n, 6, dtype=BF16), torch.zeros(n, m * 6))
    params = {"u": torch.zeros(m, 6), "v": torch.zeros(m, 6), "c": torch.zeros(m),
              "w": torch.zeros(m, 8, 6), "b": torch.zeros(8)}
    with pytest.raises(ValueError, match="compute_dtype"):
        facet_conv(params, torch.zeros(n, 6), adj, rows[:, :, None],
                   compute_dtype=torch.float16)


# ---------------------------------------------------------------------------
# The conv and the U-Net
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant", ["default", "translation_invariant", "rotation_invariant"])
def test_bf16_conv_matches_jax(rng, variant):
    """``facet_conv(compute_dtype=bfloat16)``: the default and
    translation-invariant convs against ``facet_conv_pallas(compute_dtype=
    bfloat16, interpret=True)``, the rotation-invariant one against
    ``_facet_conv_nminor_rotinv(compute_dtype=bfloat16)`` on the lane
    tables; values and parameter gradients."""
    n = 150
    a_u, mult = jax_dedupe(_random_graph(rng, n, 9))
    nbr, mult_nbr, self_mult = jax_split(a_u, mult)
    adj_sm, adj_t_sm, rows = slot_major_arrays(nbr, mult_nbr, self_mult)
    x = _unit_inputs(rng, n, 6)
    r = rng.normal(size=(n, 8)).astype(np.float32)
    jvar = jconv.FacetConvVariant(variant)
    jparams = jconv.init_facet_conv(jax.random.PRNGKey(3), 6, 8, 4, variant=jvar)

    if variant == "rotation_invariant":
        adjT, adjT_t = jax_lane_tables(nbr)
        rows_l = jax_fused_mult_rows(mult_nbr, self_mult)

        def jconv_fn(p):
            return jconv._facet_conv_nminor_rotinv(
                p, jnp.asarray(x).T, jnp.asarray(adjT), jnp.asarray(adjT_t),
                jnp.asarray(rows_l), compute_dtype=jnp.bfloat16, lane=True).T
    else:
        def jconv_fn(p):
            return pallas_conv.facet_conv_pallas(
                p, jnp.asarray(x), jnp.asarray(adj_sm), jnp.asarray(adj_t_sm),
                jnp.asarray(rows), translation_invariant=variant != "default",
                compute_dtype=jnp.bfloat16, interpret=True)

    def jloss(p):
        y = jconv_fn(p)
        return jnp.sum(y * r), y

    (_, y_j), g_j = jax.value_and_grad(jloss, has_aux=True)(jparams)
    params = {k: v.requires_grad_() for k, v in params_io.params_from_jax(
        {"l": jax.tree.map(np.asarray, jparams)}, device="cpu")["l"].items()}
    y = facet_conv(params, torch.as_tensor(x), torch.as_tensor(adj_sm), torch.as_tensor(rows),
                   variant=FacetConvVariant(variant), adj_t_sm=torch.as_tensor(adj_t_sm),
                   compute_dtype=BF16)
    assert y.dtype == torch.float32
    (y * torch.as_tensor(r)).sum().backward()
    _close(y.detach().numpy(), y_j, VALUE_TOL, "y")
    assert set(params) == set(g_j)
    for name in g_j:
        assert params[name].grad.dtype == torch.float32
        _close(params[name].grad.numpy(), g_j[name], GRAD_TOL, name)


@pytest.mark.parametrize("variant", ["default", "translation_invariant"])
def test_bf16_unet_matches_jax(rng, variant):
    """``unet_apply(compute_dtype=bfloat16)`` against ``unet_apply_pallas(
    compute_dtype=bfloat16)`` with the Pallas epilogue in interpret mode,
    from converted parameters: values and every parameter's gradient."""
    adjs_raw = [np.asarray(a) for a in make_pyramid_graph(rng)]
    x = _unit_inputs(rng, adjs_raw[0].shape[0], 6)
    r = rng.normal(size=(x.shape[0], 3)).astype(np.float32)
    jvar = jconv.FacetConvVariant(variant)
    jparams = jax_init_unet(jax.random.PRNGKey(0), in_channels=6, variant=jvar, **SMALL)
    j_adjs, j_adj_ts, j_mults = _graph_arrays(adjs_raw, pallas=True)

    def jloss(p):
        y = _apply_model(p, jnp.asarray(x), j_adjs, j_adj_ts, j_mults, steps=2, variant=jvar,
                         alpha=0.1, compute_dtype=jnp.bfloat16)
        return jnp.sum(y * r), y

    with pallas_interpret():
        (_, y_j), g_j = jax.value_and_grad(jloss, has_aux=True)(jparams)
    params = params_io.params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    leaves = [t.requires_grad_() for _, t in _flat(params)]
    adjs, adj_ts, rows = train_graph_tensors(adjs_raw, "cpu")
    y = unet_apply(params, torch.as_tensor(x), adjs, rows, variant=FacetConvVariant(variant),
                   adj_ts=adj_ts, compute_dtype=BF16)
    _close(y.detach().numpy(), y_j, VALUE_TOL, "y")
    grads = torch.autograd.grad((y * torch.as_tensor(r)).sum(), leaves)
    for (name, jg), g in zip(_flat(jax.tree.map(np.asarray, g_j)), grads):
        _close(g.numpy(), jg, GRAD_TOL, name)


# ---------------------------------------------------------------------------
# The train step and the training loop
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def sphere_patch():
    """A noisy subdivision-2 icosphere with GT, one patch (JAX host code)."""
    v, f = make_icosphere(2)
    noisy = (v + np.random.default_rng(3).normal(scale=0.02, size=v.shape)).astype(np.float32)
    ds = JaxTrainingSet(max_patch_size=20000, coarsening_steps=2, coarsening_levels=3,
                        k_faces=23, seed=0)
    ds.add_mesh(noisy, f, gt_vertices=v)
    return ds.patches[0]


def test_bf16_train_steps_match_jax(sphere_patch):
    """Two bfloat16 steps of JAX's ``make_normals_train_step`` on
    ``_patch_arrays(pallas=True)`` against the port's, from the same weights
    and a fresh Adam on both sides, each step's rotation and samples derived
    from JAX's key and injected: each step's loss within 2e-2 relative, the
    first step's gradients within 0.05 × max|g|; the parameters stay f32."""
    jcfg = jax_default_config().replace(model={**MODEL, "compute_dtype": "bfloat16"},
                                        train=TRAIN)
    cfg = default_config().replace(model={**MODEL, "compute_dtype": "bfloat16"}, train=TRAIN)
    jstate, tx = jax_create_train_state(jax.random.PRNGKey(0), jcfg)
    jstep = jax_make_normals_train_step(tx, jcfg)
    x, adjs, gt, adj_ts, mults = _patch_arrays(sphere_patch, pallas=True)

    def jloss(params, rot, idx):
        y = _apply_model(params, jax_rotate_inputs(rot, x), adjs, adj_ts, mults, steps=2,
                         variant=jconv.FacetConvVariant.DEFAULT, alpha=0.1,
                         compute_dtype=jnp.bfloat16)
        g = jax_rotate_vec3(rot, gt)
        return jax_face_loss(jnp.take(jax_normalize(y), idx, axis=0), jnp.take(g, idx, axis=0))

    state = create_train_state(cfg, device="cpu", params=params_io.params_from_jax(
        jax.tree.map(np.asarray, jstate.params), device="cpu"))
    step = make_normals_train_step(cfg)
    tensors = patch_tensors(sphere_patch, "cpu")
    leaves = [t for _, t in _flat(state.params)]
    with pallas_interpret():
        for i in range(2):
            key = jax.random.PRNGKey(10 + i)
            rot_key, samp_key = jax.random.split(key)
            rot = jax_random_rotation(rot_key)
            idx = jax.random.randint(samp_key, (cfg.train.loss_samples,), 0, x.shape[0])
            rot_t, idx_t = torch.tensor(np.asarray(rot)), torch.tensor(np.asarray(idx))
            if i == 0:
                j_grads = jax.jit(jax.grad(jloss))(jstate.params, rot, idx)
                grads = torch.autograd.grad(normals_loss(state.params, cfg, *tensors, idx_t,
                                                         rot_t), leaves)
                for (name, jg), g in zip(_flat(jax.tree.map(np.asarray, j_grads)), grads):
                    _close(g.numpy(), jg, GRAD_TOL, name)
            jstate, j_loss = jstep(jstate, x, adjs, gt, key, adj_ts, mults)
            state, loss = step(state, *tensors, rot=rot_t, sample_idx=idx_t)
            assert abs(float(loss) - float(j_loss)) <= LOSS_RTOL * abs(float(j_loss)), i
    assert state.step == int(jstate.step) == 2
    assert all(t.dtype == torch.float32 for t in leaves)


@pytest.fixture(scope="module")
def port_sphere_set():
    v, f = make_icosphere(2)
    noisy = (v + np.random.default_rng(3).normal(scale=0.02, size=v.shape)).astype(np.float32)
    ds = TrainingSet(max_patch_size=20000, coarsening_steps=2, coarsening_levels=3,
                     k_faces=23, seed=0)
    ds.add_mesh(noisy, f, gt_vertices=v)
    return ds


def _bf16_cfg(tmp_path, **model):
    return default_config().replace(
        model={**MODEL, "compute_dtype": "bfloat16", **model},
        train={**TRAIN, "network_path": str(tmp_path) + "/", "save_every": 3})


@pytest.mark.parametrize("rotation_invariance", [False, True])
def test_train_normals_bf16_on_the_cpu(port_sphere_set, tmp_path, rotation_invariance):
    """``train_normals`` under bfloat16 for a few steps on the CPU: finite
    losses, float32 checkpoints (Adam's state too), and 6 steps at 3 a call
    equal to 6 single steps bit for bit."""
    runs = []
    for spc in (3, 1):
        cfg = _bf16_cfg(tmp_path / f"spc{spc}", rotation_invariance=rotation_invariance)
        state, hist = train_normals(cfg, port_sphere_set, num_iterations=6, bucket_align=64,
                                    steps_per_call=spc, log_every=1, device="cpu")
        assert np.isfinite(hist[:, 0]).all()
        runs.append((state, cfg))
    (chunked, cfg), (single, _) = runs
    assert chunked.step == single.step == 6
    for (name, a), (_, b) in zip(_flat(chunked.params), _flat(single.params)):
        assert a.dtype == torch.float32 and torch.equal(a, b), name
    mgr = CheckpointManager(cfg.train.network_path, cfg.train.net_name)
    assert mgr.steps() == [3, 6]
    saved = torch.load(mgr._path(6), weights_only=True)
    assert all(t.dtype == torch.float32 for leaves in saved["params"].values()
               for t in leaves.values())
    served = params_io.load(params_io.checkpoint_path(cfg.train.network_path, "net"), "cpu")
    assert all(t.dtype == torch.float32 for _, t in _flat(served))


def test_scanned_bf16_call_runs_the_bf16_step(port_sphere_set):
    """``make_scanned_train_step`` under bfloat16 on the CPU: a call of 2
    steps gives the losses and parameters of 2 single bfloat16 steps on the
    same draws, bit for bit, and differs from the float32 call."""
    cfg = default_config().replace(model={**MODEL, "compute_dtype": "bfloat16"}, train=TRAIN)
    f32 = cfg.replace(model={"compute_dtype": "float32"})
    patch = port_sphere_set.patches[0]
    stack = stack_patch_tensors([patch], "cpu")
    draws = normals_draws(cfg, torch.Generator().manual_seed(5), [0, 0], patch.num_nodes)
    out = {}
    for c in (cfg, f32):
        state = create_train_state(c, device="cpu")
        _, losses = make_scanned_train_step(state, c, stack, 2)(state, draws)
        out[c.model.compute_dtype] = (state, losses.numpy())
    single = create_train_state(cfg, device="cpu")
    step = make_normals_train_step(cfg)
    tensors = patch_tensors(patch, "cpu")
    losses = []
    for j in range(2):
        single, loss = step(single, *tensors, rot=draws["rot"][j],
                            sample_idx=draws["sample_idx"][j])
        losses.append(float(loss))
    state, scanned = out["bfloat16"]
    np.testing.assert_array_equal(scanned, np.asarray(losses, np.float32))
    for (name, a), (_, b) in zip(_flat(state.params), _flat(single.params)):
        assert torch.equal(a, b), name
    assert not np.array_equal(scanned, out["float32"][1])


@pytest.fixture(scope="module")
def vertex_set():
    v, f = icosphere(2)
    ds = TrainingSet(max_patch_size=20000, coarsening_steps=2, coarsening_levels=3,
                     k_faces=23, seed=0)
    ds.add_mesh_with_vertices(add_vertex_noise(v, f, 0.2, np.random.default_rng(1)), f,
                              gt_vertices=v)
    return ds


def test_bf16_config_leaves_the_f32_paths_alone(port_sphere_set, vertex_set, tmp_path):
    """Under a bfloat16 config the paths that ignore ``compute_dtype`` in the
    JAX package run float32, bit for bit as under the float32 config: the
    eval step, ``train_with_vertices``' first two steps, and
    ``infer_normals``."""
    base = {"channels": (4, 8, 16), "num_filters": 2, "fc_channels": 16}
    cfgs = {dt: default_config().replace(
        model={**base, "compute_dtype": dt}, eval={"ms_solver_iterations": (8, 4, 4)},
        train={"chamfer_samples": 32, "loss_samples": 64, "save_every": 1000,
               "valid_every": 1000, "seed": 0, "network_path": str(tmp_path / dt) + "/"})
        for dt in ("float32", "bfloat16")}
    out = {}
    patch = port_sphere_set.patches[0]
    for dt, cfg in cfgs.items():
        state, hist = train_with_vertices(cfg, vertex_set, num_iterations=2, device="cpu")
        params = init_unet(0, device="cpu", **{k: base[k] for k in
                                               ("channels", "num_filters", "fc_channels")})
        ev = make_normals_eval_step(cfg, torch.Generator().manual_seed(2))(
            params, *patch_tensors(patch, "cpu"))
        v, f = icosphere(2)
        mesh = InferenceMesh(max_patch_size=20000, coarsening_steps=2, coarsening_levels=3,
                             k_faces=23, seed=0)
        mesh.add_mesh(add_vertex_noise(v, f, 0.2, np.random.default_rng(4)), f)
        points, normals = infer_normals(mesh, cfg, params=params, device="cpu")
        out[dt] = (state, hist, ev, points, normals)
    (s32, h32, e32, p32, n32), (s16, h16, e16, p16, n16) = out["float32"], out["bfloat16"]
    np.testing.assert_array_equal(h16, h32)
    for (name, a), (_, b) in zip(_flat(s16.params), _flat(s32.params)):
        assert torch.equal(a, b), name
    assert torch.equal(e16, e32)
    np.testing.assert_array_equal(p16, p32)
    np.testing.assert_array_equal(n16, n32)
    # and the train step does run bfloat16: its loss differs from float32's
    probe = {dt: normals_loss(init_unet(0, device="cpu", **SMALL),
                              cfgs[dt].replace(model=SMALL), *patch_tensors(patch, "cpu"),
                              torch.arange(64)) for dt in cfgs}
    assert not torch.equal(probe["bfloat16"], probe["float32"])
    assert trainer.compute_dtype(cfgs["bfloat16"]) == BF16


# ---------------------------------------------------------------------------
# The phase probes of K1 and K2 on the templated sources
# ---------------------------------------------------------------------------

def _tool(name):
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools",
                        name + ".py")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("kernel", ["k1", "k2"])
def test_phase_probes_cut_lines_that_stand_in_the_sources(kernel):
    """``tools/k{1,2}_phase_probe.py`` cut phases out of K1 and K2 by
    replacing source lines, which the storage-type templates rewrote: each
    line they replace stands once in the current source (the card runs the
    probes; this holds their text here)."""
    probe = _tool(f"{kernel}_phase_probe")
    if kernel == "k1":
        with open(os.path.join(probe.cl.CSRC, "facet_conv_fwd.cu")) as fh:
            src = fh.read()
        spec = probe.DESIGNS["block_tiles"]
        assert spec["marker"] in src
        subs, variants = spec["subs"], spec["variants"]
    else:
        with open(os.path.join(probe.cl.CSRC, "facet_conv_bwd.cu")) as fh:
            src = fh.read()
        subs, variants = probe.SUBS, probe.VARIANTS
    assert all(set(drops) <= set(subs) for drops in variants.values())
    for pairs in subs.values():
        for old, new in pairs:
            assert src.count(old) == 1 and new not in src, old
