"""The port's CUDA kernels on the card, against their plain PyTorch versions.

These tests need an NVIDIA GPU with ``nvcc`` (they build ``csrc/``) and skip
without one; run them on the card with

    python -m pytest tests/test_torch_cuda.py -q -m cuda --noconftest

(``--noconftest``: the suite's conftest imports JAX, which a card machine
running only the port may not have.)

Tolerances, float32 with TF32 off: K1, K2 and K3 atol 1e-5 + rtol 1e-5 (the
same sums in another order); K4 bit for bit (the same float operations in the
same order), and its backward kernel equal to autograd through the plain pool
(the same halvings and sums, exact); the U-Net forward and inference atol
1e-4; a train step's loss atol 1e-4 degrees and its gradients atol 1e-4 on
each gradient scaled to max 1 (the backward through 8 convs, summed in
another order); a vertex request's
normals and points atol 1e-4; a vertex train step's loss rtol 1e-4 and its
gradients atol 1e-4 scaled to max 1; the operator solver's points atol 1e-5
+ rtol 1e-4 and its gradients atol 1e-4 scaled to max 1; the scale kernel's
adjoint against the plain adjoint (float32, and float64 on the same
iterates) atol 1e-5 scaled to max 1 (float32 sums in another order; on a
full-width patch both float32 adjoints stay within 8e-6 of float64) and bit
for bit against itself; the batched server's normals and points against the
server on the CPU atol 1e-4, a replayed call bit for bit against the first,
and the exported forward atol 1e-4 against the direct forward on the CPU;
the parity capture through K1 against the plain capture atol 1e-4 a layer,
and a reference-format checkpoint read onto the card bit for bit. In
bfloat16: K1, K2 and K3's bfloat16 forms against their plain versions within
2^-8 of the plain output's largest magnitude (the same f32 sums in another
order, then one bfloat16 rounding: an ulp apart at most; dux, f32, far
within), bit for bit launch to launch; a bfloat16 train step on the card
against the same step on the CPU, its loss within 2e-2 relative and its
gradients within 0.05 of each gradient's largest magnitude (the bounds of
tests/test_variant_matrix.py); the bfloat16 graph step against its eager
steps bit for bit. Streaming: a window of patches through the graph step,
captured while a loader thread builds host tables, against eager steps,
and the streaming trainer's windowed and single steps, bit for bit.
"""

import numpy as np
import pytest
import torch

from facet_graph_convolution_torch.config import default_config
from facet_graph_convolution_torch.data.dataset import InferenceMesh
from facet_graph_convolution_torch.data.synthetic import add_vertex_noise, icosphere
from facet_graph_convolution_torch.graph.convert import (
    dedupe_klist,
    slot_major_arrays,
    split_self_klist,
)
from facet_graph_convolution_torch.geometry.mesh_math import vertex_faces
from facet_graph_convolution_torch.inference.driver import infer_normals, infer_with_vertices
from facet_graph_convolution_torch.models.unet import init_unet
from facet_graph_convolution_torch.ops import aggregate as k3
from facet_graph_convolution_torch.ops import facet_conv_kernel as k1
from facet_graph_convolution_torch.ops import ms_solver_kernel as ms
from facet_graph_convolution_torch.ops import tree_pool_kernel as k4

pytestmark = pytest.mark.cuda
SMALL = dict(channels=(8, 16, 32), num_filters=4, fc_channels=32)


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _all_tables(rng, n, k):
    adj = np.zeros((n, k), np.int32)
    adj[:, 0] = np.arange(n) + 1
    for i in range(n):
        deg = int(rng.integers(0, k - 1))
        adj[i, 1:1 + deg] = rng.choice(n, size=deg, replace=True) + 1
    a_u, mult = dedupe_klist(adj)
    adj_sm, adj_t_sm, rows = slot_major_arrays(*split_self_klist(a_u, mult))
    return adj_sm, adj_t_sm, rows[:, :, 0]


def _tables(rng, n, k):
    adj_sm, _, rows = _all_tables(rng, n, k)
    return adj_sm, rows


@pytest.mark.parametrize("c_in", [6, 32, 37, 64, 128, 256])
@pytest.mark.parametrize("m", [4, 9, 16, 32])
def test_kernel_matches_plain(cuda, rng, c_in, m):
    adj_sm, rows = _tables(rng, 700, 14)
    n = adj_sm.shape[1]
    args = [torch.as_tensor(a, device=cuda) for a in (
        rng.normal(size=(n, c_in + m)).astype(np.float32),
        rng.normal(size=(n, m)).astype(np.float32), adj_sm, rows,
        rng.normal(size=(m,)).astype(np.float32))]
    before = k1.facet_conv_fwd.launches
    z = k1.facet_conv_fwd(*args)
    # one launch per channel chunk of 1024
    assert k1.facet_conv_fwd.launches == before + -(-c_in // 1024)
    torch.testing.assert_close(z, k1.facet_conv_fwd_plain(*args), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("c_in", [6, 64, 256])
@pytest.mark.parametrize("m", [33, 64, 100])
def test_kernels_take_any_m(cuda, rng, c_in, m):
    """M past 32 (the JAX epilogue takes any M): K1 in M-groups of 16 over one
    q tile, K2 through its general pass A, against their plain versions."""
    args = _bwd_args(cuda, rng, 300, 14, c_in, m)
    fwd_args = [args[i] for i in (0, 1, 2, 4, 5)]
    before = k1.facet_conv_fwd.launches
    z = k1.facet_conv_fwd(*fwd_args)
    assert k1.facet_conv_fwd.launches == before + 1
    torch.testing.assert_close(z, k1.facet_conv_fwd_plain(*fwd_args), atol=1e-5, rtol=1e-5)
    for got, ref in zip(k1.facet_conv_bwd(*args), k1.facet_conv_bwd_plain(*args)):
        torch.testing.assert_close(got, ref, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("c_in", [6, 64, 128])
def test_kernel_is_deterministic(cuda, rng, c_in):
    """No atomics, slots summed in a fixed order: two K1 launches on the same
    inputs give the same bits."""
    adj_sm, rows = _tables(rng, 2000, 23)
    n = adj_sm.shape[1]
    args = [torch.as_tensor(a, device=cuda) for a in (
        rng.normal(size=(n, c_in + 9)).astype(np.float32),
        rng.normal(size=(n, 9)).astype(np.float32), adj_sm, rows,
        rng.normal(size=(9,)).astype(np.float32))]
    assert torch.equal(k1.facet_conv_fwd(*args), k1.facet_conv_fwd(*args))


def test_kernel_walks_more_than_32_slots(cuda, rng):
    """K'+1 > 32 slots: the kernel walks its slot table in chunks of 32."""
    adj_sm, rows = _tables(rng, 300, 45)
    assert adj_sm.shape[0] + 1 > 32
    n = adj_sm.shape[1]
    args = [torch.as_tensor(a, device=cuda) for a in (
        rng.normal(size=(n, 41)).astype(np.float32),
        rng.normal(size=(n, 9)).astype(np.float32), adj_sm, rows,
        rng.normal(size=(9,)).astype(np.float32))]
    torch.testing.assert_close(k1.facet_conv_fwd(*args), k1.facet_conv_fwd_plain(*args),
                               atol=1e-5, rtol=1e-5)


def test_kernel_refuses_what_it_does_not_take(cuda, rng):
    adj_sm, rows = _tables(rng, 64, 6)
    n = adj_sm.shape[1]
    cat = torch.randn(n, 13, device=cuda)
    ux = torch.randn(n, 4, device=cuda)
    adj = torch.as_tensor(adj_sm, device=cuda)
    r = torch.as_tensor(rows, device=cuda)
    c = torch.randn(4, device=cuda)
    with pytest.raises(TypeError):
        k1.facet_conv_fwd(cat.double(), ux, adj, r, c)
    with pytest.raises(ValueError, match="contiguous"):
        k1.facet_conv_fwd(cat, torch.randn(4, n, device=cuda).T, adj, r, c)
    # the largest M whose q tile fits a block's shared memory runs; one more
    # is refused, naming the cause and that M
    lib = k1._library("facet_conv_fwd")
    max_m = k1._max_m("facet_conv_fwd", lib, adj.shape[0], 9)
    assert max_m > 1000
    args = [torch.randn(n, 9 + max_m, device=cuda), torch.randn(n, max_m, device=cuda), adj, r,
            torch.randn(max_m, device=cuda)]
    torch.testing.assert_close(k1.facet_conv_fwd(*args), k1.facet_conv_fwd_plain(*args),
                               atol=1e-5, rtol=1e-5)
    m = max_m + 1
    with pytest.raises(ValueError, match=f"shared memory .* at most M={max_m} fit"):
        k1.facet_conv_fwd(torch.randn(n, 9 + m, device=cuda), torch.randn(n, m, device=cuda),
                          adj, r, torch.randn(m, device=cuda))


def test_inference_on_card_matches_cpu(cuda):
    v, f = icosphere(3)
    mesh = InferenceMesh(max_patch_size=700, min_patch_size=800, coarsening_steps=2,
                         coarsening_levels=3, k_faces=23, seed=0)
    mesh.add_mesh(add_vertex_noise(v, f, 0.2, np.random.default_rng(0)), f)
    cfg = default_config().replace(eval={"solver_adaptive_tol": 0.0})
    params = init_unet(0, device="cpu", **SMALL)
    on_card = {layer: {k: t.to(cuda) for k, t in p.items()} for layer, p in params.items()}
    before = k1.facet_conv_fwd.launches
    pts, n = infer_normals(mesh, cfg, params=on_card)
    assert k1.facet_conv_fwd.launches == before + 8 * len(mesh.patches)
    pts_cpu, n_cpu = infer_normals(mesh, cfg, params=params, device="cpu")
    np.testing.assert_allclose(n, n_cpu, atol=1e-4)
    np.testing.assert_allclose(pts, pts_cpu, atol=1e-4)


def test_parity_capture_through_k1_matches_plain(cuda, monkeypatch):
    from facet_graph_convolution_torch.evaluation.parity import capture_activations

    v, f = icosphere(3)
    mesh = InferenceMesh(max_patch_size=20000, coarsening_steps=2, coarsening_levels=3,
                         k_faces=23, seed=0)
    mesh.add_mesh(add_vertex_noise(v, f, 0.2, np.random.default_rng(0)), f)
    patch = mesh.patches[0]
    params = init_unet(0, device=str(cuda))
    before = k1.facet_conv_fwd.launches
    acts = capture_activations(params, patch.inputs, patch.adjs)
    assert k1.facet_conv_fwd.launches == before + 8
    monkeypatch.setattr(k1, "facet_conv_fwd", k1.facet_conv_fwd_plain)
    plain = capture_activations(params, patch.inputs, patch.adjs)
    assert acts.keys() == plain.keys()
    for name in acts:
        np.testing.assert_allclose(acts[name], plain[name], atol=1e-4, rtol=0, err_msg=name)


def test_load_reference_unet_lands_on_the_card(cuda, tmp_path):
    from facet_graph_convolution_torch.evaluation.tf_checkpoint import (
        export_unet_to_tf,
        load_reference_unet,
    )

    params = init_unet(0, device=str(cuda), multi_scale=True)
    prefix = str(tmp_path / "net-1")
    export_unet_to_tf(prefix, params)
    back, multi = load_reference_unet(prefix)
    assert multi and back.keys() == params.keys()
    for layer in params:
        for name, t in params[layer].items():
            assert back[layer][name].device.type == "cuda"
            assert torch.equal(back[layer][name], t), (layer, name)


def _bwd_args(cuda, rng, n, k, c_in, m):
    adj_sm, adj_t_sm, rows = _all_tables(rng, n, k)
    n_pad = adj_sm.shape[1]
    cat = rng.normal(size=(n_pad, c_in + m)).astype(np.float32)
    cat[n:] = 0.0                                       # padded nodes
    return [torch.as_tensor(a, device=cuda) for a in (
        cat, rng.normal(size=(n_pad, m)).astype(np.float32), adj_sm, adj_t_sm, rows,
        rng.normal(size=(m,)).astype(np.float32),
        rng.normal(size=(n_pad, m * c_in)).astype(np.float32))]


@pytest.mark.parametrize("c_in", [6, 32, 37, 64, 128, 256])
@pytest.mark.parametrize("m", [4, 9, 16, 32])
def test_backward_kernel_matches_plain(cuda, rng, c_in, m):
    args = _bwd_args(cuda, rng, 700, 14, c_in, m)
    before = k1.facet_conv_bwd.launches
    dcat, dux = k1.facet_conv_bwd(*args)
    assert k1.facet_conv_bwd.launches == before + 1
    ref_dcat, ref_dux = k1.facet_conv_bwd_plain(*args)
    torch.testing.assert_close(dcat, ref_dcat, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(dux, ref_dux, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("c_in,k", [(41, 45), (6, 45), (6, 300)])
def test_backward_kernel_walks_more_than_32_slots(cuda, rng, c_in, k):
    """K'+1 > 32 and transpose maps wider than 32 (pass B walks them 8, 16
    or 32 entries at a time); at K = 300 the slots of one node outnumber a
    block's threads, so pass A walks them in rounds."""
    args = _bwd_args(cuda, rng, 300, k, c_in, 9)
    assert args[2].shape[0] + 1 > 32 and args[3].shape[1] > 32
    for got, ref in zip(k1.facet_conv_bwd(*args), k1.facet_conv_bwd_plain(*args)):
        torch.testing.assert_close(got, ref, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("c_in", [6, 64, 128])
def test_backward_kernel_is_deterministic(cuda, rng, c_in):
    """No atomics: two launches on the same inputs give the same bits."""
    args = _bwd_args(cuda, rng, 2000, 23, c_in, 9)
    first = k1.facet_conv_bwd(*args)
    second = k1.facet_conv_bwd(*args)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_backward_kernel_refuses_what_it_does_not_take(cuda, rng):
    cat, ux, adj, adj_t, rows, c, dz = _bwd_args(cuda, rng, 64, 6, 9, 4)
    with pytest.raises(TypeError):
        k1.facet_conv_bwd(cat, ux, adj, adj_t, rows, c, dz.double())
    with pytest.raises(TypeError):
        k1.facet_conv_bwd(cat, ux, adj, adj_t.long(), rows, c, dz)
    with pytest.raises(ValueError, match="contiguous"):
        k1.facet_conv_bwd(cat, ux, adj, adj_t, rows, c, dz.T.contiguous().T)
    with pytest.raises(ValueError, match="shape"):
        k1.facet_conv_bwd(cat, ux, adj, adj_t[:-1], rows, c, dz)
    n = cat.shape[0]
    max_m = k1._library("facet_conv_bwd").facet_conv_bwd_max_m()
    assert max_m > 1000
    m = max_m + 1
    with pytest.raises(ValueError, match=f"shared memory .* at most M={max_m} fit"):
        k1.facet_conv_bwd(torch.randn(n, 9 + m, device=cuda), torch.randn(n, m, device=cuda),
                          adj, adj_t, rows, torch.randn(m, device=cuda),
                          torch.randn(n, 9 * m, device=cuda))


@pytest.fixture(scope="module")
def served_patch():
    """The larger patch of a noisy subdivision-5 icosphere, as served (the
    kernel phases of chip_smoke.py use it too)."""
    v, f = icosphere(5)
    mesh = InferenceMesh(max_patch_size=20000, coarsening_steps=2, coarsening_levels=3,
                         k_faces=23, seed=0)
    mesh.add_mesh(add_vertex_noise(v, f, 0.2, np.random.default_rng(0)), f)
    return max(mesh.patches, key=lambda p: p.num_nodes)


# the 8 convs of the model at the served patch: name, level, input channels
CONVS = (("conv1", 0, 6), ("conv2", 1, 32), ("conv3", 2, 64), ("dconv3", 2, 128),
         ("upconv2", 1, 128), ("dconv2", 1, 128), ("upconv1", 0, 64), ("dconv1", 0, 64))


@pytest.mark.parametrize("name,level,c_in", CONVS)
def test_kernel_at_the_path_shapes(cuda, rng, served_patch, name, level, c_in):
    """K1 at each conv of a served patch's forward (its slot tables with pad
    slots and padded nodes, M = 9), against its plain version and bitwise
    repeatable, one launch a conv."""
    from facet_graph_convolution_torch.models.unet import graph_tensors

    adjs, mult_rows = graph_tensors(served_patch.adjs, cuda)
    adj_sm, rows = adjs[level], mult_rows[level][:, :, 0].contiguous()
    n_pad = adj_sm.shape[1]
    cat = rng.normal(size=(n_pad, c_in + 9)).astype(np.float32)
    cat[served_patch.adjs[level].shape[0]:] = 0.0
    args = [torch.as_tensor(cat, device=cuda),
            torch.as_tensor(rng.normal(size=(n_pad, 9)).astype(np.float32), device=cuda),
            adj_sm, rows, torch.as_tensor(rng.normal(size=(9,)).astype(np.float32), device=cuda)]
    before = k1.facet_conv_fwd.launches
    z = k1.facet_conv_fwd(*args)
    assert k1.facet_conv_fwd.launches == before + 1
    assert torch.equal(z, k1.facet_conv_fwd(*args))
    torch.testing.assert_close(z, k1.facet_conv_fwd_plain(*args), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("name,level,c_in", CONVS)
def test_backward_kernel_at_the_path_shapes(cuda, rng, served_patch, name, level, c_in):
    """K2 at each conv of a default train step's shapes (the served patch's
    slot tables, M = 9), against its plain version and bitwise repeatable."""
    from facet_graph_convolution_torch.models.unet import train_graph_tensors

    adjs, adj_ts, mult_rows = train_graph_tensors(served_patch.adjs, cuda)
    adj_sm, adj_t_sm = adjs[level], adj_ts[level]
    rows = mult_rows[level][:, :, 0].contiguous()
    n_pad = adj_sm.shape[1]
    m = 9
    cat = rng.normal(size=(n_pad, c_in + m)).astype(np.float32)
    cat[served_patch.adjs[level].shape[0]:] = 0.0
    args = [torch.as_tensor(cat, device=cuda), torch.as_tensor(
        rng.normal(size=(n_pad, m)).astype(np.float32), device=cuda), adj_sm, adj_t_sm, rows,
        torch.as_tensor(rng.normal(size=(m,)).astype(np.float32), device=cuda),
        torch.as_tensor(rng.normal(size=(n_pad, m * c_in)).astype(np.float32), device=cuda)]
    got = k1.facet_conv_bwd(*args)
    again = k1.facet_conv_bwd(*args)
    for a, b, ref in zip(got, again, k1.facet_conv_bwd_plain(*args)):
        assert torch.equal(a, b)
        torch.testing.assert_close(a, ref, atol=1e-5, rtol=1e-5)


def test_conv_on_card_keeps_its_gradient(cuda, rng):
    """The conv's output on the card has a grad_fn, and its gradients match
    the CPU's (slice 1 launched K1 outside autograd: the gradient stopped)."""
    from facet_graph_convolution_torch.ops.conv import facet_conv

    adj_sm, adj_t_sm, rows = _all_tables(rng, 500, 12)
    x = rng.normal(size=(500, 6)).astype(np.float32)
    layer = init_unet(3, device="cpu", **SMALL)["conv1"]
    grads = []
    for dev in ("cpu", cuda):
        p = {k: t.to(dev).requires_grad_() for k, t in layer.items()}
        xt = torch.as_tensor(x, device=dev).requires_grad_()
        y = facet_conv(p, xt, torch.as_tensor(adj_sm, device=dev),
                       torch.as_tensor(rows[:, :, None], device=dev),
                       adj_t_sm=torch.as_tensor(adj_t_sm, device=dev))
        assert y.grad_fn is not None
        names = sorted(p)
        g = torch.autograd.grad((y * y).sum(), [p[k] for k in names] + [xt])
        grads.append([t.cpu() for t in g])
    for g_cpu, g_card in zip(*grads):
        torch.testing.assert_close(g_card, g_cpu, atol=1e-4, rtol=1e-4)


def _train_step_on_card_matches_cpu(cuda, model, launches, loss_rtol=None, grad_atol=1e-4,
                                    counter="launches"):
    """One train step on the card against the same step on the CPU, with the
    same rotation and loss samples: its loss (within 1e-4, or ``loss_rtol``
    relative), its gradients (each scaled to max 1, within ``grad_atol``)
    and the kernels' ``launches`` ({wrapper: count a step} by the wrapper's
    ``counter``). The updated parameters are not compared: Adam's first
    update is ±lr for a gradient of any size, so a near-zero gradient summed
    in another order may flip it."""
    from facet_graph_convolution_torch.data.dataset import TrainingSet
    from facet_graph_convolution_torch.training.trainer import (
        create_train_state,
        make_normals_train_step,
        normals_loss,
        patch_tensors,
    )

    v, f = icosphere(3)
    ds = TrainingSet(max_patch_size=20000, coarsening_steps=2, coarsening_levels=3,
                     k_faces=23, seed=0)
    ds.add_mesh(add_vertex_noise(v, f, 0.2, np.random.default_rng(0)), f, gt_vertices=v)
    cfg = default_config().replace(
        model={"channels": SMALL["channels"], "num_filters": 4, "fc_channels": 32, **model},
        train={"loss_samples": 512})
    patch = ds.patches[0]
    rng = np.random.default_rng(1)
    rot = torch.as_tensor(np.linalg.qr(rng.normal(size=(3, 3)))[0].astype(np.float32))
    idx = torch.as_tensor(rng.integers(0, patch.num_nodes, size=512))
    out = []
    for dev in ("cpu", cuda):
        state = create_train_state(cfg, device=str(dev))
        tensors = patch_tensors(patch, str(dev))
        names = [(layer, k) for layer in sorted(state.params) for k in sorted(state.params[layer])]
        loss = normals_loss(state.params, cfg, *tensors, idx.to(dev), rot.to(dev))
        grads = torch.autograd.grad(loss, [state.params[a][b] for a, b in names])
        out.append((float(loss.detach()), [g.cpu() for g in grads]))
        before = {fn: getattr(fn, counter) for fn in launches}
        state, step_loss = make_normals_train_step(cfg)(state, *tensors, rot=rot,
                                                         sample_idx=idx)
        assert abs(float(step_loss) - float(loss.detach())) <= 1e-6 and state.step == 1
        if dev != "cpu":
            assert {fn: getattr(fn, counter) - before[fn] for fn in launches} == launches
    (loss_cpu, g_cpu), (loss_card, g_card) = out
    assert abs(loss_cpu - loss_card) < (1e-4 if loss_rtol is None else loss_rtol * abs(loss_cpu))
    for a, b in zip(g_card, g_cpu):
        scale = b.abs().max().clamp_min(1e-30)
        torch.testing.assert_close(a / scale, b / scale, atol=grad_atol, rtol=0)


def test_train_step_on_card_matches_cpu(cuda):
    _train_step_on_card_matches_cpu(cuda, {}, {k1.facet_conv_fwd: 8, k1.facet_conv_bwd: 8})


def test_rotinv_train_step_on_card_matches_cpu(cuda):
    """Under rotation invariance: conv1 through K3 and K3's backward once
    each a step, the other 7 convs through K1 and K2."""
    _train_step_on_card_matches_cpu(
        cuda, {"rotation_invariance": True},
        {k1.facet_conv_fwd: 7, k1.facet_conv_bwd: 7, k3.weighted_aggregate: 1,
         k3.weighted_aggregate_bwd: 1})


@pytest.mark.parametrize("rotation_invariance", [False, True])
def test_bf16_train_step_on_card_matches_cpu(cuda, rotation_invariance):
    """``compute_dtype="bfloat16"``: the step on the card (K1/K2 and K3 in
    their bfloat16 forms, counted by their bfloat16 counters) against the
    same bfloat16 step on the CPU (the plain versions), at the bfloat16
    bounds."""
    launches = ({k1.facet_conv_fwd: 7, k1.facet_conv_bwd: 7, k3.weighted_aggregate: 1,
                 k3.weighted_aggregate_bwd: 1}
                if rotation_invariance else {k1.facet_conv_fwd: 8, k1.facet_conv_bwd: 8})
    _train_step_on_card_matches_cpu(
        cuda, {"compute_dtype": "bfloat16", "rotation_invariance": rotation_invariance},
        launches, loss_rtol=2e-2, grad_atol=0.05, counter="launches_bf16")


# the train step's conv1 (a subdivision-5 icosphere bucketed to 25,600 nodes)
# and conv1 at the other input widths the rotation-invariant conv takes (the
# kernels' M = 9 forms at C = 3, 4, 6), the JAX kernel test's shape
# (tests/test_pallas.py), whole and partial chunks of the kernels' 8 channels
# a thread, tiles shrunk for wide rows, and M past 32
K3_SHAPES = [(13, 25600, 9, 6), (13, 700, 9, 3), (13, 600, 9, 4), (23, 512, 9, 64),
             (13, 700, 16, 37), (5, 300, 4, 130), (1, 77, 1, 1), (9, 1000, 9, 16),
             (2, 333, 3, 33), (13, 500, 33, 6)]


def _k3_inputs(cuda, rng, s, n, m, c, dtype=torch.float32):
    """Logits, multipliers (zeros where the tables pad), slots and dz."""
    rows = rng.uniform(0.0, 1.0, size=(s, n)).astype(np.float32)
    rows[rng.uniform(size=(s, n)) < 0.2] = 0.0
    logits, rows = (torch.as_tensor(a, device=cuda) for a in (
        (2.0 * rng.normal(size=(s, n, m))).astype(np.float32), rows))
    x, dz = (torch.as_tensor(rng.normal(size=shape).astype(np.float32), device=cuda).to(dtype)
             for shape in ((s, n, c), (n, m * c)))
    return logits, rows, x, dz


def _k3_check(cuda, rng, shape, dtype, close):
    """K3 and its backward (with and without dx) against their plain
    versions, each counted once a launch, the same bits launch to launch."""
    logits, rows, x, dz = _k3_inputs(cuda, rng, *shape, dtype)
    counter = "launches" if dtype == torch.float32 else "launches_bf16"
    before = getattr(k3.weighted_aggregate, counter)
    z = k3.weighted_aggregate(logits, rows, x)
    assert getattr(k3.weighted_aggregate, counter) == before + 1 and z.dtype == dtype
    close(z, k3.weighted_aggregate_plain(logits, rows, x), "z")
    assert torch.equal(z, k3.weighted_aggregate(logits, rows, x))        # no atomics
    for need_dx in (False, True):
        before = getattr(k3.weighted_aggregate_bwd, counter)
        dlogits, dx = k3.weighted_aggregate_bwd(logits, rows, x, dz, need_dx)
        assert getattr(k3.weighted_aggregate_bwd, counter) == before + 1
        ref_l, ref_x = k3.weighted_aggregate_bwd_plain(logits, rows, x, dz, need_dx)
        assert dlogits.dtype == torch.float32
        _f32_close(dlogits, ref_l, "dlogits")
        again = k3.weighted_aggregate_bwd(logits, rows, x, dz, need_dx)
        assert torch.equal(dlogits, again[0])
        if need_dx:
            assert dx.dtype == dtype
            close(dx, ref_x, "dx")
            assert torch.equal(dx, again[1])
        else:
            assert dx is None and again[1] is None


def _f32_close(got, want, what):
    """Within 1e-5 × max|plain| (the same f32 sums in another order)."""
    assert got.dtype == want.dtype, what
    scale = float(want.abs().max()) or 1.0
    err = float((got - want).abs().max())
    assert err <= 1e-5 * scale, f"{what}: {err} > 1e-5 × {scale}"


@pytest.mark.parametrize("s,n,m,c", K3_SHAPES)
def test_aggregate_kernel_matches_plain(cuda, rng, s, n, m, c):
    _k3_check(cuda, rng, (s, n, m, c), torch.float32, _f32_close)


def test_aggregate_kernel_refuses_what_it_does_not_take(cuda, rng):
    logits, rows, x, dz = _k3_inputs(cuda, rng, 3, 16, 4, 6)
    for fn, extra in ((k3.weighted_aggregate, ()), (k3.weighted_aggregate_bwd, (dz,))):
        with pytest.raises(TypeError):
            fn(logits.double(), rows, x.double(), *[t.double() for t in extra])
        with pytest.raises(TypeError):
            fn(logits, rows.double(), x, *extra)
        with pytest.raises(ValueError, match="contiguous"):
            fn(logits, rows, torch.randn(6, 16, 3, device=cuda).permute(2, 1, 0), *extra)
        with pytest.raises(ValueError, match="contiguous"):
            fn(logits.transpose(0, 1).contiguous().transpose(0, 1), rows, x, *extra)
        with pytest.raises(ValueError, match="differ"):
            fn(logits, rows, x[:, :15], *extra)
        with pytest.raises(ValueError, match="device|on"):
            fn(logits, rows, x.cpu(), *extra)
        with pytest.raises(ValueError, match="device|on"):
            fn(logits, rows.cpu(), x, *extra)
        # a one-node tile past the 227 KB of shared memory a block can use
        wide = torch.zeros(3, 16, 20000, device=cuda)
        with pytest.raises(ValueError, match="shared memory"):
            fn(logits, rows, wide, *[torch.zeros(16, 4 * 20000, device=cuda) for _ in extra])
    with pytest.raises(ValueError, match="dz"):
        k3.weighted_aggregate_bwd(logits, rows, x, dz[:, :20].contiguous())
    before = (k3.weighted_aggregate.launches, k3.weighted_aggregate_bwd.launches)
    empty = [t[:, :0].contiguous() for t in (logits, rows, x)]
    assert k3.weighted_aggregate(*empty).shape == (0, 24)
    dlogits, dx = k3.weighted_aggregate_bwd(*empty, dz[:0].contiguous())
    assert dlogits.shape == (3, 0, 4) and dx.shape == (3, 0, 6)
    assert (k3.weighted_aggregate.launches, k3.weighted_aggregate_bwd.launches) == before


def test_rotinv_conv_on_card_keeps_its_gradient(cuda, rng):
    """The rotation-invariant conv on the card launches K3 and its backward
    once each through ``WeightedAggregate``; its gradients reach u and c
    (and w, b, x: the backward's dx) and match the CPU's."""
    from facet_graph_convolution_torch.ops.conv import FacetConvVariant, facet_conv

    adj_sm, adj_t_sm, rows = _all_tables(rng, 500, 12)
    x = rng.normal(size=(500, 6)).astype(np.float32)
    x[:, :3] /= np.linalg.norm(x[:, :3], axis=1, keepdims=True)
    layer = init_unet(3, device="cpu", variant=FacetConvVariant.ROTATION_INVARIANT,
                      **SMALL)["conv1"]
    assert "v" not in layer
    grads = []
    for dev in ("cpu", cuda):
        p = {k: t.to(dev).requires_grad_() for k, t in layer.items()}
        xt = torch.as_tensor(x, device=dev).requires_grad_()
        before = (k3.weighted_aggregate.launches, k3.weighted_aggregate_bwd.launches)
        y = facet_conv(p, xt, torch.as_tensor(adj_sm, device=dev),
                       torch.as_tensor(rows[:, :, None], device=dev),
                       variant=FacetConvVariant.ROTATION_INVARIANT,
                       adj_t_sm=torch.as_tensor(adj_t_sm, device=dev))
        assert y.grad_fn is not None
        assert k3.weighted_aggregate.launches == before[0] + (dev != "cpu")
        names = sorted(p)
        g = torch.autograd.grad((y * y).sum(), [p[k] for k in names] + [xt])
        assert k3.weighted_aggregate_bwd.launches == before[1] + (dev != "cpu")
        assert all(float(g[names.index(k)].abs().max()) > 0 for k in ("u", "c"))
        grads.append([t.cpu() for t in g])
    for g_cpu, g_card in zip(*grads):
        torch.testing.assert_close(g_card, g_cpu, atol=1e-4, rtol=1e-4)


def _pool_input(rng, n, c, zeros=0.3):
    """Rows with zeros (a share ``zeros`` of them), all-zero rows and
    groups, and −0.0 rows."""
    x = rng.normal(size=(n, c)).astype(np.float32)
    x[rng.random(n) < zeros] = 0.0
    x[8:16] = 0.0
    x[1] = -0.0
    x[17, :] = 0.0
    x[17, -1] = -0.0
    return x


@pytest.mark.parametrize("steps", [0, 1, 2, 3, 5])
@pytest.mark.parametrize("c", [1, 3, 8, 9, 40, 130])
def test_tree_pool_kernel_matches_plain_bitwise(cuda, rng, c, steps):
    x = torch.as_tensor(_pool_input(rng, 32 * 37, c), device=cuda)
    before = k4.tree_pool_ignore_zeros.launches
    out = k4.tree_pool_ignore_zeros(x, steps)
    assert k4.tree_pool_ignore_zeros.launches == before + 1
    ref = k4.tree_pool_ignore_zeros_plain(x, steps)
    assert out.shape == ref.shape == (x.shape[0] >> steps, c)
    assert torch.equal(out, ref)
    assert torch.equal(torch.signbit(out), torch.signbit(ref))


def test_tree_pool_kernel_takes_a_stack_beyond_48_kb(cuda, rng):
    """(steps + 1)·C·4 bytes above 48 KB: the launch asks for more shared
    memory."""
    x = torch.as_tensor(_pool_input(rng, 64, 2100), device=cuda)
    assert torch.equal(k4.tree_pool_ignore_zeros(x, 5), k4.tree_pool_ignore_zeros_plain(x, 5))


def test_tree_pool_kernel_refuses_what_it_does_not_take(cuda):
    x = torch.randn(16, 3, device=cuda)
    with pytest.raises(TypeError):
        k4.tree_pool_ignore_zeros(x.double(), 2)
    with pytest.raises(ValueError, match="contiguous"):
        k4.tree_pool_ignore_zeros(torch.randn(3, 16, device=cuda).T, 2)
    with pytest.raises(ValueError, match="multiple"):
        k4.tree_pool_ignore_zeros(x, 5)
    with pytest.raises(ValueError, match="exceeds"):
        k4.tree_pool_ignore_zeros(torch.randn(16, 30000, device=cuda), 1)


def test_tree_pool_kernel_raises_under_grad(cuda):
    """Under grad K4 no longer raises: it runs the forward kernel and, in the
    backward, the backward kernel (one launch each); under no_grad the
    forward alone."""
    x = torch.randn(16, 3, device=cuda, requires_grad=True)
    before = (k4.tree_pool_ignore_zeros.launches, k4.tree_pool_ignore_zeros_bwd.launches)
    k4.tree_pool_ignore_zeros(x, 2).sum().backward()
    assert (k4.tree_pool_ignore_zeros.launches, k4.tree_pool_ignore_zeros_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    with torch.no_grad():
        assert k4.tree_pool_ignore_zeros(x, 2).shape == (4, 3)
    with pytest.raises(ValueError, match="exceeds"):
        k4.tree_pool_ignore_zeros_bwd(torch.randn(2048, 3, device=cuda),
                                      torch.randn(1, 3, device=cuda), 11)


@pytest.mark.parametrize("steps", [0, 1, 2, 4, 5, 6, 10])
@pytest.mark.parametrize("c", [1, 3, 9, 40])
def test_tree_pool_backward_kernel_matches_plain(cuda, rng, c, steps):
    """The backward kernel against autograd through the plain pool, on zero
    rows, zero groups and -0.0 rows: equal values (bit for bit up to the
    sign of a zero), and the same bits on a second launch; the lane kernel
    at C <= 8 up to 5 rounds, the team kernel's zero flags in a register (C
    > 8 up to 5 rounds) and in local memory (6 and 10)."""
    x = torch.as_tensor(_pool_input(rng, 3 * 1024, c), device=cuda)
    dy = torch.as_tensor(rng.normal(size=(x.shape[0] >> steps, c)).astype(np.float32),
                         device=cuda)
    before = k4.tree_pool_ignore_zeros_bwd.launches
    dx = k4.tree_pool_ignore_zeros_bwd(x, dy, steps)
    again = k4.tree_pool_ignore_zeros_bwd(x, dy, steps)
    assert k4.tree_pool_ignore_zeros_bwd.launches == before + 2
    ref = k4.tree_pool_ignore_zeros_bwd_plain(x, dy, steps)
    assert torch.equal(dx, ref) and torch.equal(dx, again)
    leaf = x.clone().requires_grad_()
    k4.TreePoolIgnoreZeros.apply(leaf, steps).backward(dy)
    assert torch.equal(leaf.grad, ref)


def _pool_checks(x, steps, dy):
    """K4 and its backward through the wrappers against the plain pool and
    autograd through it: bit for bit, the sign of zero included, one launch
    each, and the same bits on a second launch."""
    before = (k4.tree_pool_ignore_zeros.launches, k4.tree_pool_ignore_zeros_bwd.launches)
    out, again = k4.tree_pool_ignore_zeros(x, steps), k4.tree_pool_ignore_zeros(x, steps)
    dx, dx2 = k4.tree_pool_ignore_zeros_bwd(x, dy, steps), k4.tree_pool_ignore_zeros_bwd(x, dy,
                                                                                         steps)
    assert (k4.tree_pool_ignore_zeros.launches, k4.tree_pool_ignore_zeros_bwd.launches) == (
        before[0] + 2, before[1] + 2)
    ref = k4.tree_pool_ignore_zeros_plain(x, steps)
    dref = k4.tree_pool_ignore_zeros_bwd_plain(x, dy, steps)
    for got, want, twice in ((out, ref, again), (dx, dref, dx2)):
        assert got.shape == want.shape
        assert torch.equal(got, want) and torch.equal(got, twice)
        assert torch.equal(torch.signbit(got), torch.signbit(want))
        assert torch.equal(torch.signbit(got), torch.signbit(twice))


@pytest.mark.parametrize("c,steps", [(3, 2), (3, 4), (1, 0), (3, 1), (3, 5), (8, 5), (9, 5),
                                     (8, 6), (9, 6)])
def test_tree_pool_kernels_on_ragged_warps_and_blocks(cuda, rng, c, steps):
    """The main path's shapes (C = 3 at 4 and 2 rounds) and the dispatch's
    edge (C 8 / 9 at 5 / 6 rounds: the lane kernels on one side, the team
    kernels on the other), at N = 111 · 2^steps rows: groups end mid-warp
    below 5 rounds, and the last block is ragged."""
    x = torch.as_tensor(_pool_input(rng, 111 << steps, c), device=cuda)
    assert x.shape[0] % 256 and (steps >= 5 or x.shape[0] % 32)
    dy = torch.as_tensor(rng.normal(size=(111, c)).astype(np.float32), device=cuda)
    _pool_checks(x, steps, dy)


@pytest.mark.parametrize("zeros", [0.3, 0.002])
@pytest.mark.parametrize("steps", [4, 2])
def test_tree_pool_kernels_at_the_sharded_solve_size(cuda, rng, steps, zeros):
    """1,273,920 face centres, C = 3, as the sharded naive solver pools the
    1,048,576-face torus: zero rows (dense, or sparse so that most warps
    hold none and merge without the zero rule), zero groups, -0.0 rows."""
    x = torch.as_tensor(_pool_input(rng, 1_273_920, 3, zeros), device=cuda)
    x[4096:4096 + 64] = 0.0
    x[-5] = -0.0
    dy = torch.as_tensor(rng.normal(size=(x.shape[0] >> steps, 3)).astype(np.float32),
                         device=cuda)
    _pool_checks(x, steps, dy)


def _solver_patch():
    """A served patch of a noisy subdivision-3 icosphere (fake faces, −1
    pads) with random unit normals at each level, from a seed."""
    v, f = icosphere(3)
    mesh = InferenceMesh(max_patch_size=700, coarsening_steps=2, coarsening_levels=3,
                         k_faces=23, seed=0)
    mesh.add_mesh_with_vertices(add_vertex_noise(v, f, 0.2, np.random.default_rng(0)), f)
    p = max(mesh.patches, key=lambda q: q.num_nodes)
    return p.vertices, p.faces.astype(np.int32), p.v_faces


def _unit_normals(rng, n):
    fn = rng.normal(size=(n, 3)).astype(np.float32)
    return fn / np.linalg.norm(fn, axis=1, keepdims=True)


def _synthetic_solver_case(rng, num_vertices, num_faces):
    """Random faces over the vertices with fake faces (whole groups of 16 and
    single ones), a vertex without faces (λ = 0) and vertex 0 in more than
    K = 25 faces (a full row)."""
    # ids 1 .. V - 2: the last vertex has no faces
    faces = rng.integers(1, num_vertices - 1, size=(num_faces, 3)).astype(np.int32)
    faces[100:140, 0] = 0
    fake = rng.random(num_faces) < 0.1
    fake[32:64] = True
    fake[100:140] = False
    faces[fake] = -1
    v_f = vertex_faces(faces, 25, num_vertices)
    assert (v_f[0] >= 0).all() and (v_f[-1] < 0).all()
    x = rng.normal(size=(num_vertices, 3)).astype(np.float32)
    return x, faces, v_f


def _solver_check(cuda, rng, x, faces, v_f, scale, steps, iters):
    """The kernel against the plain scale on the card; returns the kernel's x."""
    args = [torch.as_tensor(a, device=cuda) for a in (x, faces, v_f)]
    fn = torch.as_tensor(_unit_normals(rng, faces.shape[0] >> (steps * scale)), device=cuda)
    before = ms.naive_scale.launches
    with torch.no_grad():
        out = ms.naive_scale(args[0], args[1], args[2], fn, scale, steps, iters)
        assert ms.naive_scale.launches == before + 1
        ref = ms.naive_scale_plain(args[0], args[1], args[2], fn, scale, steps, iters)
    torch.testing.assert_close(out, ref, atol=1e-5, rtol=0)
    return out


@pytest.mark.parametrize("iters", [1, 80])
@pytest.mark.parametrize("scale", [0, 1, 2])
def test_solver_kernel_matches_plain(cuda, rng, scale, iters):
    x, faces, v_f = _solver_patch()
    out = _solver_check(cuda, rng, x, faces, v_f, scale, 2, iters)
    assert float((out.cpu() - torch.as_tensor(x)).abs().max()) > 1e-4      # it moved


@pytest.mark.parametrize("scale", [0, 1, 2])
def test_solver_kernel_on_fake_faces_empty_and_full_rows(cuda, rng, scale):
    x, faces, v_f = _synthetic_solver_case(rng, 300, 16 * 64)
    out = _solver_check(cuda, rng, x, faces, v_f, scale, 2, 20)
    assert torch.equal(out[-1].cpu(), torch.as_tensor(x[-1]))             # λ = 0: unmoved


@pytest.mark.parametrize("steps,scale", [(3, 2), (4, 2)])
def test_solver_kernel_pools_more_leaves_than_a_warp(cuda, rng, steps, scale):
    """2^shift > 32 leaves a node: each lane pools its own leaves first."""
    x, faces, v_f = _synthetic_solver_case(rng, 300, 256 * 8)
    _solver_check(cuda, rng, x, faces, v_f, scale, steps, 5)


def test_solver_kernel_is_deterministic(cuda, rng):
    x, faces, v_f = _solver_patch()
    args = [torch.as_tensor(a, device=cuda) for a in (x, faces, v_f)]
    fn = torch.as_tensor(_unit_normals(rng, faces.shape[0] >> 4), device=cuda)
    first = ms.naive_scale(*args, fn, 2, 2, 80)
    assert torch.equal(ms.naive_scale(*args, fn, 2, 2, 80), first)


@pytest.mark.parametrize("shift", [2, 4, 6, 7])
def test_solver_phase_a_pools_bit_for_bit(cuda, rng, shift):
    """The kernel's level-s centres equal the plain K4 of its own level-0
    centroids, bit for bit; the centroids match the plain gather-mean."""
    x, faces, _ = _synthetic_solver_case(rng, 300, 256 * 8)
    xt, ft = torch.as_tensor(x, device=cuda), torch.as_tensor(faces, device=cuda)
    level0 = ms.scale_centers(xt, ft, 0)
    v_pad = torch.cat([xt.new_zeros(1, 3), xt])
    torch.testing.assert_close(level0, v_pad[ft.long() + 1].mean(dim=1), atol=1e-6, rtol=0)
    out = ms.scale_centers(xt, ft, shift)
    ref = k4.tree_pool_ignore_zeros_plain(level0, shift)
    assert out.shape == ref.shape == (faces.shape[0] >> shift, 3)
    assert torch.equal(out, ref) and torch.equal(torch.signbit(out), torch.signbit(ref))


def test_solver_kernel_raises_under_grad(cuda, rng):
    """Under grad the scale needs its adjoint kernel's maps: without them it
    raises, naming them; with them it runs and gives a gradient."""
    from facet_graph_convolution_torch.ops.vertex_update import build_naive_maps

    x, faces, v_f = _solver_patch()
    xt = torch.as_tensor(x, device=cuda).requires_grad_()
    ft, vt = torch.as_tensor(faces, device=cuda), torch.as_tensor(v_f, device=cuda)
    fn = torch.as_tensor(_unit_normals(rng, faces.shape[0]), device=cuda)
    with pytest.raises(ValueError, match="maps"):
        ms.naive_scale(xt, ft, vt, fn, 0, 2, 3)
    with torch.no_grad():
        assert ms.naive_scale(xt, ft, vt, fn, 0, 2, 3).shape == xt.shape
    maps = build_naive_maps(faces, v_f, 3, 2, device=cuda)
    out = ms.naive_scale(xt, ft, vt, fn, 0, 2, 3, face_slots=maps.face_slots[0],
                         corners=maps.corners)
    out.sum().backward()
    assert torch.isfinite(xt.grad).all() and float(xt.grad.abs().max()) > 0


def test_solver_kernel_refuses_what_it_does_not_take(cuda, rng):
    x, faces, v_f = _solver_patch()
    xt, ft = torch.as_tensor(x, device=cuda), torch.as_tensor(faces, device=cuda)
    vt = torch.as_tensor(v_f, device=cuda)
    fn = torch.as_tensor(_unit_normals(rng, faces.shape[0]), device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        ms.naive_scale(xt.T.contiguous().T, ft, vt, fn, 0, 2, 3)
    with pytest.raises(RuntimeError, match="cooperative launch"):
        ms.naive_scale(xt, ft, vt, fn, 0, 2, 3, grid=ms.max_grid(xt.device) + 1)
    # the refusal leaves no error behind for the next launch to report
    assert ms.naive_scale(xt, ft, vt, fn, 0, 2, 3).shape == xt.shape


def test_solver_kernel_grid_strides_over_a_million_faces(cuda, rng):
    """~1M faces and 2^19 vertices: more work than one wave of the grid's
    threads, so every grid-stride loop takes several passes."""
    x, faces, v_f = _synthetic_solver_case(rng, 1 << 19, 1 << 20)
    for scale in (0, 2):
        nodes = faces.shape[0] >> (2 * scale)
        grid = ms.default_grid(torch.device(cuda), x.shape[0], nodes, 2 * scale)
        assert grid * 1024 < 8 * x.shape[0]      # 1024-thread blocks, 8 lanes a vertex
        _solver_check(cuda, rng, x, faces, v_f, scale, 2, 3)


def _adjoint_check(cuda, rng, x, faces, v_f, scale, steps, iters):
    """The adjoint kernel at one scale against the plain adjoint on the same
    iterates (float32 and float64), and against itself; returns its grads."""
    from facet_graph_convolution_torch.ops.vertex_update import build_naive_maps

    xt, ft, vt = (torch.as_tensor(a, device=cuda) for a in (x, faces, v_f))
    fn = torch.as_tensor(_unit_normals(rng, faces.shape[0] >> (steps * scale)), device=cuda)
    maps = build_naive_maps(faces, v_f, 3, steps, device=cuda)
    g = torch.as_tensor(rng.normal(size=x.shape).astype(np.float32), device=cuda)
    xs = ms.naive_scale_plain(xt, ft, vt, fn, scale, steps, iters, store=True)
    before = ms.naive_scale_backward.launches
    kw = dict(face_slots=maps.face_slots[scale], corners=maps.corners)
    ours = ms.naive_scale_backward(xs, ft, vt, fn, scale, steps, g, **kw)
    assert ms.naive_scale_backward.launches == before + 1
    again = ms.naive_scale_backward(xs, ft, vt, fn, scale, steps, g, **kw)
    assert all(torch.equal(a, b) for a, b in zip(ours, again))          # no atomics
    for ref in (ms.naive_scale_backward_plain(xs, ft, vt, fn, scale, steps, g),
                ms.naive_scale_backward_plain(xs.double(), ft, vt, fn.double(), scale, steps,
                                              g.double())):
        for a, b in zip(ours, ref):
            scale_b = b.abs().max().clamp_min(1e-30)
            torch.testing.assert_close(a.double() / scale_b, b.double() / scale_b, atol=1e-5,
                                       rtol=0)
    return ours


@pytest.mark.parametrize("iters", [1, 80])
@pytest.mark.parametrize("scale", [0, 1, 2])
def test_solver_adjoint_kernel_matches_plain(cuda, rng, scale, iters):
    x, faces, v_f = _solver_patch()
    g_x, g_fn = _adjoint_check(cuda, rng, x, faces, v_f, scale, 2, iters)
    assert float(g_fn.abs().max()) > 0


@pytest.mark.parametrize("scale", [0, 1, 2])
def test_solver_adjoint_kernel_on_fake_faces_empty_and_full_rows(cuda, rng, scale):
    """Fake faces (their leaves take a share only beside other fake ones,
    and no vertex reads it), a vertex without faces (λ = 0: its cotangent
    passes through) and a vertex in more faces than K (its corner list
    keeps them all)."""
    x, faces, v_f = _synthetic_solver_case(rng, 300, 16 * 64)
    _adjoint_check(cuda, rng, x, faces, v_f, scale, 2, 20)


@pytest.mark.parametrize("steps,scale", [(3, 2), (4, 2)])
def test_solver_adjoint_kernel_pools_more_leaves_than_a_warp(cuda, rng, steps, scale):
    """2^shift > 32 leaves a node: each lane walks its block's tree."""
    x, faces, v_f = _synthetic_solver_case(rng, 300, 256 * 8)
    _adjoint_check(cuda, rng, x, faces, v_f, scale, steps, 5)


def test_solver_adjoint_kernel_grid_strides_over_a_million_faces(cuda, rng):
    x, faces, v_f = _synthetic_solver_case(rng, 1 << 19, 1 << 20)
    _adjoint_check(cuda, rng, x, faces, v_f, 2, 2, 3)


def _solve_leaves(cuda, rng):
    from facet_graph_convolution_torch.ops.vertex_update import build_naive_maps

    x, faces, v_f = _solver_patch()
    ft, vt = torch.as_tensor(faces, device=cuda), torch.as_tensor(v_f, device=cuda)
    normals = [torch.as_tensor(_unit_normals(rng, faces.shape[0] >> (2 * s)), device=cuda)
               for s in range(3)]
    leaves = [torch.as_tensor(x, device=cuda).requires_grad_()] + [
        n.requires_grad_() for n in normals]
    r = torch.as_tensor(rng.normal(size=x.shape).astype(np.float32), device=cuda)
    return leaves, ft, vt, build_naive_maps(faces, v_f, 3, 2, device=cuda), r


def test_naive_solver_gradients_launch_the_kernels_and_match_plain_autograd(cuda, rng):
    """The solve under autograd: 3 scale-kernel launches forward and 3
    adjoint launches backward (6 forward with the checkpoint, the same
    gradients bit for bit); the gradients against autograd through the
    plain loop on the card (atol 1e-4 scaled, the solver's bar)."""
    from facet_graph_convolution_torch.ops.vertex_update import update_positions_multiscale

    leaves, ft, vt, maps, r = _solve_leaves(cuda, rng)
    runs = []
    for ck in (False, True):
        before = (ms.naive_scale.launches, ms.naive_scale_backward.launches)
        out, _ = update_positions_multiscale(leaves[0], leaves[1:], ft, vt, 2, (80, 20, 20),
                                             checkpoint=ck, maps=maps)
        grads = torch.autograd.grad((out * r).sum(), leaves)
        runs.append(grads)
        assert (ms.naive_scale.launches - before[0],
                ms.naive_scale_backward.launches - before[1]) == ((6, 3) if ck else (3, 3))
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    plain = [t.detach().clone().requires_grad_() for t in leaves]
    kernels = (ms.naive_scale, k4.tree_pool_ignore_zeros)
    try:
        ms.naive_scale = lambda x, f, v, n, s, c, i, **kw: ms.naive_scale_plain(x, f, v, n, s, c,
                                                                                 i)
        k4.tree_pool_ignore_zeros = k4.tree_pool_ignore_zeros_plain
        out, _ = update_positions_multiscale(plain[0], plain[1:], ft, vt, 2, (80, 20, 20))
        ref = torch.autograd.grad((out * r).sum(), plain)
    finally:
        ms.naive_scale, k4.tree_pool_ignore_zeros = kernels
    for a, b in zip(runs[0], ref):
        scale = b.abs().max().clamp_min(1e-30)
        torch.testing.assert_close(a / scale, b / scale, atol=1e-4, rtol=0)


def test_naive_solver_forward_and_adjoint_capture_into_a_graph(cuda, rng):
    """Both cooperative launches inside a CUDA graph: a replay gives the
    eager gradients bit for bit, and the wrappers count the capture's
    launches only."""
    from facet_graph_convolution_torch.ops.vertex_update import update_positions_multiscale

    leaves, ft, vt, maps, r = _solve_leaves(cuda, rng)
    grads = [torch.zeros_like(t) for t in leaves]

    def solve():
        out, _ = update_positions_multiscale(leaves[0], leaves[1:], ft, vt, 2, (80, 20, 20),
                                             maps=maps)
        for buf, g in zip(grads, torch.autograd.grad((out * r).sum(), leaves)):
            buf.copy_(g)

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        solve()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    eager = [g.clone() for g in grads]
    graph = torch.cuda.CUDAGraph()
    before = (ms.naive_scale.launches, ms.naive_scale_backward.launches)
    with torch.cuda.graph(graph):
        solve()
    for g in grads:
        g.zero_()
    graph.replay()
    graph.replay()
    torch.cuda.synchronize()
    assert (ms.naive_scale.launches - before[0], ms.naive_scale_backward.launches - before[1]) == (
        3, 3)
    assert all(torch.equal(a, b) for a, b in zip(grads, eager))


@pytest.mark.parametrize("solver", ["operator", "naive"])
def test_vertex_request_on_card_matches_cpu(cuda, solver):
    v, f = icosphere(3)
    mesh = InferenceMesh(max_patch_size=700, coarsening_steps=2, coarsening_levels=3,
                         k_faces=23, seed=0)
    mesh.add_mesh_with_vertices(add_vertex_noise(v, f, 0.2, np.random.default_rng(0)), f)
    cfg = default_config().replace(eval={"vertex_solver": solver})
    params = init_unet(0, device="cpu", multi_scale=True, **SMALL)
    on_card = {layer: {k: t.to(cuda) for k, t in p.items()} for layer, p in params.items()}
    before = (k1.facet_conv_fwd.launches, k4.tree_pool_ignore_zeros.launches,
              ms.naive_scale.launches)
    out = infer_with_vertices(mesh, cfg, params=on_card)
    patches = len(mesh.patches)
    assert k1.facet_conv_fwd.launches == before[0] + 8 * patches
    # the naive solver: one solver-kernel launch a scale, no standalone K4
    assert k4.tree_pool_ignore_zeros.launches == before[1]
    scales = 3 * patches if solver == "naive" else 0
    assert ms.naive_scale.launches == before[2] + scales
    ref = infer_with_vertices(mesh, cfg, params=params, device="cpu")
    for key, value in ref.items():
        np.testing.assert_allclose(out[key], value, atol=1e-4, err_msg=key)


def _vertex_training_case(solver="operator"):
    from facet_graph_convolution_torch.data.dataset import TrainingSet

    v, f = icosphere(2)
    ds = TrainingSet(max_patch_size=20000, coarsening_steps=2, coarsening_levels=3,
                     k_faces=23, seed=0)
    ds.add_mesh_with_vertices(add_vertex_noise(v, f, 0.2, np.random.default_rng(0)), f,
                              gt_vertices=v)
    cfg = default_config().replace(
        model={"channels": SMALL["channels"], "num_filters": 4, "fc_channels": 32},
        train={"chamfer_samples": 64}, eval={"vertex_solver": solver})
    return ds, cfg


def test_vertex_train_step_through_kernels_matches_plain(cuda):
    """One vertex step on the card (operator solver, K1 8 and K2 8 a step)
    against the same step with the plain K1/K2 swapped in, same draws: the
    loss and the gradients scaled to max 1 (atol 1e-4); and against the
    same step on the CPU."""
    from facet_graph_convolution_torch.training.trainer import (
        create_train_state,
        make_vertex_train_step,
        vertex_loss,
        vertex_patch_tensors,
    )

    ds, cfg = _vertex_training_case()
    patch = ds.patches[0]
    rng = np.random.default_rng(1)
    rot = torch.as_tensor(np.linalg.qr(rng.normal(size=(3, 3)))[0].astype(np.float32))
    idx0 = torch.as_tensor(rng.integers(0, patch.vertices.shape[0], size=64))
    idx1 = torch.as_tensor(rng.integers(0, patch.gt_vertices.shape[0], size=64))

    def loss_and_grads(dev, plain=False):
        state = create_train_state(cfg, device=str(dev), multi_scale=True)
        tensors = vertex_patch_tensors(cfg, patch, str(dev))
        leaves = [state.params[a][b] for a in sorted(state.params) for b in sorted(state.params[a])]
        kernels = (k1.facet_conv_fwd, k1.facet_conv_bwd)
        try:
            if plain:
                k1.facet_conv_fwd, k1.facet_conv_bwd = (k1.facet_conv_fwd_plain,
                                                        k1.facet_conv_bwd_plain)
            loss = vertex_loss(state.params, cfg, tensors, rot.to(dev), idx0.to(dev),
                               idx1.to(dev))
            grads = torch.autograd.grad(loss, leaves)
        finally:
            k1.facet_conv_fwd, k1.facet_conv_bwd = kernels
        return float(loss.detach()), [g.cpu() for g in grads], state, tensors

    before = (k1.facet_conv_fwd.launches, k1.facet_conv_bwd.launches)
    loss, grads, state, tensors = loss_and_grads(cuda)
    assert (k1.facet_conv_fwd.launches - before[0], k1.facet_conv_bwd.launches - before[1]) == (
        8, 8)
    for other in (loss_and_grads(cuda, plain=True), loss_and_grads("cpu")):
        assert abs(other[0] - loss) <= 1e-4 * max(1.0, abs(loss))
        for a, b in zip(grads, other[1]):
            assert torch.isfinite(a).all()
            scale = b.abs().max().clamp_min(1e-30)
            torch.testing.assert_close(a / scale, b / scale, atol=1e-4, rtol=0)
    state, step_loss = make_vertex_train_step(cfg)(state, tensors, rot, idx0, idx1)
    assert state.step == 1 and abs(float(step_loss) - loss) <= 1e-6 * max(1.0, abs(loss))


def test_operator_solver_gradients_on_card_match_cpu(cuda, rng):
    """The operator solver under autograd on CUDA tensors (its gathers'
    transpose-map backward) against the same on the CPU."""
    from facet_graph_convolution_torch.ops.vertex_update import (
        build_solver_tables,
        update_positions_multiscale_operator,
    )

    ds, _ = _vertex_training_case()
    p = ds.patches[0]
    normals = []
    for n in (p.num_nodes, p.num_nodes // 4, p.num_nodes // 16):
        nrm = rng.normal(size=(n, 3)).astype(np.float32)
        normals.append(nrm / np.linalg.norm(nrm, axis=1, keepdims=True))
    r = rng.normal(size=p.vertices.shape).astype(np.float32)
    out = []
    for dev in ("cpu", cuda):
        leaves = [torch.tensor(a, device=dev, requires_grad=True) for a in (p.vertices, *normals)]
        tables = build_solver_tables(p.v_faces, [a.shape[0] for a in p.adjs], p.vertices.shape[0],
                                     2, faces=p.faces, device=dev)
        x, _ = update_positions_multiscale_operator(
            leaves[0], leaves[1:], torch.as_tensor(p.faces, device=dev),
            torch.as_tensor(p.v_faces, device=dev), tables)
        grads = torch.autograd.grad((x * torch.as_tensor(r, device=dev)).sum(), leaves)
        out.append((x.detach().cpu(), [g.cpu() for g in grads]))
    (x_cpu, g_cpu), (x_card, g_card) = out
    torch.testing.assert_close(x_card, x_cpu, atol=1e-5, rtol=1e-4)
    for a, b in zip(g_card, g_cpu):
        scale = b.abs().max().clamp_min(1e-30)
        torch.testing.assert_close(a / scale, b / scale, atol=1e-4, rtol=0)


def test_train_with_vertices_trains_the_naive_solver_on_card(cuda, tmp_path):
    """train_with_vertices under the naive solver on the card: finite
    losses, the scale kernel 3 and its adjoint 3 launches a step, and a
    written checkpoint."""
    from facet_graph_convolution_torch.training.checkpoint import CheckpointManager
    from facet_graph_convolution_torch.training.trainer import train_with_vertices

    ds, cfg = _vertex_training_case("naive")
    cfg = cfg.replace(train={"network_path": str(tmp_path) + "/", "save_every": 2})
    before = (ms.naive_scale.launches, ms.naive_scale_backward.launches)
    state, hist = train_with_vertices(cfg, ds, num_iterations=3, device=str(cuda))
    assert (ms.naive_scale.launches - before[0], ms.naive_scale_backward.launches - before[1]) == (
        9, 9)
    assert state.step == 3 and hist.shape == (3, 2) and np.isfinite(hist[:, 0]).all()
    assert CheckpointManager(cfg.train.network_path, cfg.train.net_name).steps() == [2, 3]


# ---------------------------------------------------------------------------
# multi-step train calls: a train step captured as a CUDA graph
# ---------------------------------------------------------------------------

def optax_adam_reference(param, mu, nu, count, grad, lr, b1=0.9, b2=0.999, eps=1e-8):
    """One ``optax.adam(lr)`` update in float32 numpy, as optax's
    ``scale_by_adam`` and ``scale_by_learning_rate`` write it (held against
    optax itself in tests/test_torch_scanned.py, where JAX is present):
    returns ``(param, mu, nu, count)`` after it."""
    f = np.float32
    mu = (f(1 - b1) * grad + f(b1) * mu).astype(f)
    nu = (f(1 - b2) * grad * grad + f(b2) * nu).astype(f)
    count = count + 1
    mu_hat = mu / f(1 - f(b1) ** f(count))
    nu_hat = nu / f(1 - f(b2) ** f(count))
    update = mu_hat / (np.sqrt(nu_hat) + f(eps))
    return (param + f(-lr) * update).astype(f), mu, nu, count


def _graph_case(model=None):
    from facet_graph_convolution_torch.data.dataset import TrainingSet

    v, f = icosphere(3)
    ds = TrainingSet(max_patch_size=20000, coarsening_steps=2, coarsening_levels=3,
                     k_faces=23, seed=0)
    ds.add_mesh(add_vertex_noise(v, f, 0.2, np.random.default_rng(0)), f, gt_vertices=v)
    cfg = default_config().replace(
        model={"channels": SMALL["channels"], "num_filters": 4, "fc_channels": 32,
               **(model or {})},
        train={"loss_samples": 512})
    return ds, cfg


def _same_state(a, b):
    from facet_graph_convolution_torch.training.trainer import _leaves

    for p, q in zip(_leaves(a.params), _leaves(b.params)):
        assert torch.equal(p, q)
        sa, sb = a.optimizer.state[p], b.optimizer.state[q]
        for key in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(sa[key], sb[key]), key


@pytest.mark.parametrize("kind", ["default", "rotation_invariant", "vertex", "vertex_naive",
                                  "default_bf16", "rotation_invariant_bf16"])
def test_graph_call_equals_eager_steps(cuda, kind):
    """Two calls of 5 steps through the captured graph (the first: one eager
    warm-up step, the capture, 4 replays; the second: 5 replays, with no
    host synchronisation inside the call) against 10 steps of the eager
    train step with the same capturable Adam and the same draws: the
    losses, parameters and Adam state bit for bit (K1-K3 and the rest of
    the step are repeatable). K1/K2 (and K3) run inside the graph: the
    wrappers counted their launches at the warm-up and the capture only."""
    from facet_graph_convolution_torch.training.trainer import (
        create_train_state,
        make_normals_train_step,
        make_scanned_train_step,
        make_vertex_train_step,
        normals_draws,
        patch_tensors,
        stack_patch_tensors,
        vertex_patch_tensors,
    )

    if kind.startswith("vertex"):
        ds, cfg = _vertex_training_case("naive" if kind == "vertex_naive" else "operator")
        patch = ds.patches[0]
        tensors = vertex_patch_tensors(cfg, patch, str(cuda))
        step = make_vertex_train_step(cfg, generator=torch.Generator().manual_seed(7))
        graph_state = create_train_state(cfg, device=str(cuda), multi_scale=True)
        eager_state = create_train_state(cfg, device=str(cuda), multi_scale=True)
        scanned = step.scanned(graph_state, tensors, 5)
        calls = [step.draw(tensors, 5) for _ in range(2)]

        def eager(state, d, j):
            return step(state, tensors, d["rot"][j], d["idx0"][j], d["idx1"][j])
    else:
        ds, cfg = _graph_case({"rotation_invariance": kind.startswith("rotation_invariant"),
                               "compute_dtype": "bfloat16" if kind.endswith("bf16")
                               else "float32"})
        patch = ds.patches[0]
        graph_state = create_train_state(cfg, device=str(cuda))
        eager_state = create_train_state(cfg, device=str(cuda))
        scanned = make_scanned_train_step(graph_state, cfg,
                                          stack_patch_tensors([patch], str(cuda)), 5)
        gen = torch.Generator().manual_seed(7)
        calls = [normals_draws(cfg, gen, [0] * 5, patch.num_nodes) for _ in range(2)]
        tensors = patch_tensors(patch, str(cuda))
        normals_step = make_normals_train_step(cfg)

        def eager(state, d, j):
            return normals_step(state, *tensors, rot=d["rot"][j], sample_idx=d["sample_idx"][j])

    counters = [k1.facet_conv_fwd, k1.facet_conv_bwd, k3.weighted_aggregate,
                k3.weighted_aggregate_bwd, ms.naive_scale, ms.naive_scale_backward]
    before = [fn.launches for fn in counters]
    before_bf16 = [getattr(fn, "launches_bf16", 0) for fn in counters]
    _, first = scanned(graph_state, calls[0])
    after_capture = [fn.launches for fn in counters]
    bf16 = [getattr(fn, "launches_bf16", 0) - b for fn, b in zip(counters, before_bf16)]
    torch.cuda.set_sync_debug_mode("error")
    try:
        _, second = scanned(graph_state, calls[1])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert [fn.launches for fn in counters] == after_capture     # replays count nothing
    per_step = {"default": [8, 8, 0, 0, 0, 0], "rotation_invariant": [7, 7, 1, 1, 0, 0],
                "vertex": [8, 8, 0, 0, 0, 0], "vertex_naive": [8, 8, 0, 0, 3, 3]}
    launched = [a - b for a, b in zip(after_capture, before)]
    assert launched == [2 * n for n in per_step[kind.replace("_bf16", "")]]
    # every launch of a bfloat16 step is a bfloat16 one, and none of a float32 step
    assert bf16 == (launched if kind.endswith("bf16") else [0] * len(counters))
    graph_losses = np.concatenate([first.numpy(), second.numpy()])
    eager_losses = []
    for d in calls:
        for j in range(5):
            eager_state, loss = eager(eager_state, d, j)
            eager_losses.append(float(loss))
    assert graph_state.step == eager_state.step == 10
    np.testing.assert_array_equal(graph_losses, np.asarray(eager_losses, np.float32))
    _same_state(graph_state, eager_state)
    assert scanned.capture_s > 0 and scanned.graph_bytes > 0


@pytest.mark.parametrize("kind", ["default", "vertex"])
def test_profiled_replays_show_the_step_marks_in_order(cuda, kind):
    """A call of 4 steps replayed from the captured graph, under
    torch.profiler: the device marks of every step, in order, once a step
    (a vertex step's solver marks inside its forward and its backward); the
    host spans of the call's stages around them."""
    from torch.profiler import ProfilerActivity, profile

    from facet_graph_convolution_torch.training.trainer import (
        create_train_state,
        make_scanned_train_step,
        make_vertex_train_step,
        normals_draws,
        stack_patch_tensors,
        vertex_patch_tensors,
    )

    if kind == "vertex":
        ds, cfg = _vertex_training_case()
        tensors = vertex_patch_tensors(cfg, ds.patches[0], str(cuda))
        step = make_vertex_train_step(cfg, generator=torch.Generator().manual_seed(7))
        state = create_train_state(cfg, device=str(cuda), multi_scale=True)
        scanned = step.scanned(state, tensors, 4)
        calls = [step.draw(tensors, 4) for _ in range(2)]
        marks = ["step_begin", "solver_begin", "solver_end", "fwd_end", "solver_bwd_begin",
                 "solver_bwd_end", "bwd_end", "opt_end"]
    else:
        ds, cfg = _graph_case()
        patch = ds.patches[0]
        state = create_train_state(cfg, device=str(cuda))
        scanned = make_scanned_train_step(state, cfg, stack_patch_tensors([patch], str(cuda)), 4)
        gen = torch.Generator().manual_seed(7)
        calls = [normals_draws(cfg, gen, [0] * 4, patch.num_nodes) for _ in range(2)]
        marks = ["step_begin", "fwd_end", "bwd_end", "opt_end"]
    scanned(state, calls[0])[1].numpy()             # the warm-up step and the capture
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        scanned(state, calls[1])[1].numpy()
        torch.cuda.synchronize()
    events = sorted(prof.events(), key=lambda e: e.time_range.start)
    seen = [e.name for e in events if e.device_type == torch.autograd.DeviceType.CUDA
            and e.name.startswith("fgc_mark_")]
    assert seen == ["fgc_mark_" + m for m in marks] * 4
    host = [e.name for e in events if e.device_type != torch.autograd.DeviceType.CUDA
            and e.name.startswith("fgc.")]
    assert host == ["fgc.loop.stage_draws", "fgc.loop.replay", "fgc.loop.read_losses"]


def _stream_case(tmp_path, seeds, max_patch_size=100):
    """Noisy subdivision-2 icospheres (one a seed) cut into patches of at
    most ``max_patch_size`` faces, in streaming shards of 3, and the small
    config."""
    from facet_graph_convolution_torch.data.dataset import TrainingSet
    from facet_graph_convolution_torch.data.stream import save_sharded

    v, f = icosphere(2)
    ds = TrainingSet(max_patch_size=max_patch_size, coarsening_steps=2, coarsening_levels=3,
                     k_faces=23, seed=0)
    for s in seeds:
        ds.add_mesh(add_vertex_noise(v, f, 0.2, np.random.default_rng(s)), f, gt_vertices=v)
    save_sharded(ds, str(tmp_path / "shards"), patches_per_shard=3)
    cfg = default_config().replace(
        model={"channels": SMALL["channels"], "num_filters": 4, "fc_channels": 32},
        train={"loss_samples": 256, "network_path": str(tmp_path / "net") + "/"})
    return ds, str(tmp_path / "shards"), cfg


def test_streaming_window_through_the_graph_equals_eager_steps(cuda, tmp_path):
    """A streaming window of 4 patches (padded to one bucket and to their
    largest slot widths, copied into WindowBuffers) through the captured
    step, while a PrefetchLoader thread builds host tables from the same
    shards during the capture, against 4 eager steps on the same patches
    and draws: losses, parameters and Adam state bit for bit."""
    import time

    from facet_graph_convolution_torch.data.dataset import bucket_size, pad_patch_to
    from facet_graph_convolution_torch.data.stream import PrefetchLoader, ShardedDataset
    from facet_graph_convolution_torch.training import trainer

    ds, shards, cfg = _stream_case(tmp_path, (3,))
    target = bucket_size(max(p.num_nodes for p in ds.patches), 64)
    tensors = [trainer.patch_tensors(pad_patch_to(p, target), str(cuda)) for p in ds.patches[:4]]
    dims = tuple(tuple(max(w) for w in zip(*lvl))
                 for lvl in zip(*(trainer._slot_dims(t) for t in tensors)))
    tensors = [trainer._pad_to_dims(t, dims) for t in tensors]
    buffers = trainer.WindowBuffers(4)
    buffers.load(tensors)
    graph_state = trainer.create_train_state(cfg, device=str(cuda))
    eager_state = trainer.create_train_state(cfg, device=str(cuda))
    window = trainer.make_scanned_train_step(graph_state, cfg, buffers, 4)
    draws = trainer.normals_draws(cfg, torch.Generator().manual_seed(3), range(4), target)

    prepared = []

    def prepare(patch, idx):
        arrays = trainer.patch_arrays(pad_patch_to(patch, target))
        prepared.append(time.perf_counter())
        return arrays

    loader = PrefetchLoader(ShardedDataset(shards), prepare, depth=10**5, num_items=10**5)
    try:
        t0 = time.perf_counter()
        _, losses = window(graph_state, draws)
        graph_losses = losses.numpy()
        t1 = time.perf_counter()
    finally:
        loader.close()
    assert window.captures == 1
    assert any(t0 < t < t1 for t in prepared)          # the loader ran during the capture
    step = trainer.make_normals_train_step(cfg)
    eager_losses = []
    for j in range(4):
        eager_state, loss = step(eager_state, *tensors[j], rot=draws["rot"][j],
                                 sample_idx=draws["sample_idx"][j])
        eager_losses.append(float(loss))
    np.testing.assert_array_equal(graph_losses, np.asarray(eager_losses, np.float32))
    _same_state(graph_state, eager_state)


def test_streaming_trainer_on_card_equals_single_steps(cuda, tmp_path, capsys):
    """train_normals_streaming on the card: on a one-patch set, 7 steps at
    3 a window (one capture, windows 3, 3, 1) and 7 eager steps give the same
    state bit for bit; on eight patches whose slot widths grow in the middle
    of the run (seed 5, windows of 2), the graph is captured once more for
    each growth and K1/K2 launch only at the warm-up steps and captures."""
    import json

    from facet_graph_convolution_torch.training import trainer

    def summary():
        line = [x for x in capsys.readouterr().out.splitlines()
                if x.startswith("streaming summary: ")]
        return json.loads(line[-1].split(": ", 1)[1])

    _, one_shards, cfg = _stream_case(tmp_path / "one", (3,), max_patch_size=20000)
    runs = []
    for spc in (3, 1):
        c = cfg.replace(train={"network_path": str(tmp_path / f"net{spc}") + "/",
                               "eval_every": 1})
        runs.append(trainer.train_normals_streaming(c, one_shards, num_iterations=7,
                                                    bucket_align=64, steps_per_call=spc,
                                                    device=str(cuda))[0])
        assert summary()["captures"] == (1 if spc == 3 else 0)
    assert runs[0].step == runs[1].step == 7
    _same_state(runs[0], runs[1])

    _, shards, _ = _stream_case(tmp_path / "multi", (3, 4))
    c = cfg.replace(train={"network_path": str(tmp_path / "netw") + "/", "seed": 5,
                           "eval_every": 2})
    before = [k1.facet_conv_fwd.launches, k1.facet_conv_bwd.launches]
    state, hist = trainer.train_normals_streaming(c, shards, num_iterations=16, bucket_align=64,
                                                  steps_per_call=2, device=str(cuda))
    got = summary()
    assert got["growths"] >= 1 and got["captures"] == 1 + got["growths"]
    launched = [k1.facet_conv_fwd.launches - before[0], k1.facet_conv_bwd.launches - before[1]]
    assert launched == [16 * got["captures"]] * 2
    assert state.step == 16 and np.isfinite(hist[:, 0]).all()


@pytest.mark.parametrize("steps_per_call", [1, 2])
def test_streaming_device_memory_stays_flat_past_the_memo(cuda, tmp_path, capsys,
                                                          monkeypatch, steps_per_call):
    """train_normals_streaming on the card over more patches than it keeps
    (MAX_PREPARED cut to 3 against eight patches, 40 steps, so that evicted
    patches are uploaded again): the device memory allocated at the windows
    after the first epoch stays within one window's uploads (and the
    allocator's rounding, 512 B a tensor) of its value at the first."""
    import json

    from facet_graph_convolution_torch.training import trainer

    monkeypatch.setattr(trainer, "MAX_PREPARED", 3)
    _, shards, cfg = _stream_case(tmp_path, (3, 4))
    trainer.train_normals_streaming(cfg, shards, num_iterations=40, bucket_align=64,
                                    steps_per_call=steps_per_call, device=str(cuda))
    line = [x for x in capsys.readouterr().out.splitlines()
            if x.startswith("streaming summary: ")]
    got = json.loads(line[-1].split(": ", 1)[1])
    first, _, most = got["after"]["allocated"]
    assert got["after"]["windows"] == 32 // steps_per_call
    assert got["after"]["h2d_windows"] > 3
    assert most - first <= got["h2d_bytes_max"] + 512 * 64, got


def test_capturable_adam_matches_optax(cuda):
    """The card's Adam (capturable, a tensor learning rate) from an optax
    state loaded by adam_state_from_optax, fed the same gradients for three
    updates, against optax's update (the numpy reference above) within 1e-7,
    the CPU Adam's bar in tests/test_torch_train.py."""
    from facet_graph_convolution_torch.training.trainer import (
        _leaves,
        adam_state_from_optax,
        adam_update,
        create_train_state,
    )

    _, cfg = _graph_case()
    state = create_train_state(cfg, device=str(cuda))
    group = state.optimizer.param_groups[0]
    assert group["capturable"] and torch.is_tensor(group["lr"])
    rng = np.random.default_rng(4)
    shapes = {layer: {n: tuple(t.shape) for n, t in leaves.items()}
              for layer, leaves in state.params.items()}
    mu = {a: {n: rng.normal(size=s).astype(np.float32) * 1e-2 for n, s in ls.items()}
          for a, ls in shapes.items()}
    nu = {a: {n: np.abs(rng.normal(size=s)).astype(np.float32) * 1e-4 for n, s in ls.items()}
          for a, ls in shapes.items()}
    adam_state_from_optax(state, mu, nu, 4)
    leaves = _leaves(state.params)
    ref = [(p.detach().cpu().numpy(), m, v, 4)
           for p, m, v in zip(leaves, _leaves(mu), _leaves(nu))]
    assert all(state.optimizer.state[p]["step"].device.type == "cuda" for p in leaves)
    for _ in range(3):
        grads = [rng.normal(size=p.shape).astype(np.float32) for p in leaves]
        for p, g in zip(leaves, grads):
            p.grad = torch.as_tensor(g, device=cuda)
        adam_update(state)
        ref = [optax_adam_reference(*r, g, cfg.train.learning_rate) for r, g in zip(ref, grads)]
    for p, r in zip(leaves, ref):
        np.testing.assert_allclose(p.detach().cpu().numpy(), r[0], atol=1e-7)
    assert state.step == 7


def test_card_checkpoint_resumes_on_card_and_loads_on_cpu(cuda, tmp_path):
    """A checkpoint written by train_normals(steps_per_call=2) on the card
    restores into the card's capturable Adam (update counts on the device)
    and into the CPU's plain Adam (counts on the CPU, a float learning
    rate); training resumes from it on the card and on the CPU."""
    from facet_graph_convolution_torch.training.checkpoint import CheckpointManager
    from facet_graph_convolution_torch.training.trainer import (
        _leaves,
        create_train_state,
        train_normals,
    )

    ds, cfg = _graph_case()
    cfg = cfg.replace(train={"network_path": str(tmp_path) + "/"})
    state, _ = train_normals(cfg, ds, num_iterations=4, steps_per_call=2, device=str(cuda))
    mgr = CheckpointManager(cfg.train.network_path, cfg.train.net_name)
    assert mgr.steps() == [4]
    for dev in (str(cuda), "cpu"):
        restored, step = mgr.restore(create_train_state(cfg, device=dev))
        group = restored.optimizer.param_groups[0]
        assert step == 4 and group["capturable"] == (dev != "cpu")
        for p, q in zip(_leaves(restored.params), _leaves(state.params)):
            assert torch.equal(p.cpu(), q.cpu())
            s = restored.optimizer.state[p]
            assert s["step"].device.type == torch.device(dev).type and int(s["step"]) == 4
            assert torch.equal(s["exp_avg"].cpu(), state.optimizer.state[q]["exp_avg"].cpu())
    more, _ = train_normals(cfg, ds, num_iterations=2, steps_per_call=2, device=str(cuda))
    assert more.step == 6
    last, _ = train_normals(cfg, ds, num_iterations=1, device="cpu")
    assert last.step == 7 and mgr.latest_step() == 7


def test_capture_that_synchronises_raises(cuda):
    """A step that reads a value on the host cannot be captured: the call
    raises (there is no eager fallback on the card)."""
    from facet_graph_convolution_torch.training.graph_step import GraphStep
    from facet_graph_convolution_torch.training.trainer import create_train_state

    _, cfg = _graph_case()
    state = create_train_state(cfg, device=str(cuda))
    w = state.params["fc1"]["w"]

    def loss_fn(params, scale):
        loss = (w * scale).square().mean()
        if float(loss.detach()) < 0:    # a host read: legal eagerly, not in a capture
            raise AssertionError
        return loss

    step = GraphStep(state, loss_fn, 3)
    with pytest.raises(RuntimeError):
        step(state, {"scale": torch.ones(3, 1)})
    assert step.graph is None
    torch.cuda.synchronize()


def test_vertex_graphs_beyond_a_budget_are_evicted_and_recaptured(cuda, tmp_path):
    """train_with_vertices through the graph on three patches with a budget
    of about two graphs: the cache evicts and captures patches again, what
    it holds stays within the budget (past it only by a newcomer larger than
    every graph before), the card's reserved memory within the budget plus
    the eager run's, and the trained state equals the same chunks' draws
    run as eager steps, bit for bit."""
    from facet_graph_convolution_torch.data.dataset import TrainingSet
    from facet_graph_convolution_torch.training.graph_step import GraphCache
    from facet_graph_convolution_torch.training.trainer import (
        create_train_state,
        make_vertex_train_step,
        train_with_vertices,
        vertex_patch_tensors,
    )

    v, f = icosphere(2)
    ds = TrainingSet(max_patch_size=200, coarsening_steps=2, coarsening_levels=3, k_faces=23,
                     seed=0)
    ds.add_mesh_with_vertices(add_vertex_noise(v, f, 0.2, np.random.default_rng(1)), f,
                              gt_vertices=v)
    assert len(ds.patches) == 3
    _, cfg = _vertex_training_case("naive")
    iters, spc = 24, 2

    def run(name, **kw):
        c = cfg.replace(train={"network_path": str(tmp_path / name) + "/", "save_every": 1000})
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_reserved()
        state, _ = train_with_vertices(c, ds, num_iterations=iters, device=str(cuda), **kw)
        torch.cuda.synchronize()
        return state, torch.cuda.max_memory_reserved() - base

    probe = GraphCache()
    run("probe", steps_per_call=spc, graph_cache=probe)
    probe.observe()
    graph = probe.largest
    _, eager_bytes = run("eager")
    cache = GraphCache(budget_bytes=2 * graph + graph // 2)
    state, graph_run_bytes = run("bounded", steps_per_call=spc, graph_cache=cache)
    cache.observe()
    distinct = len(probe.entries)
    assert distinct == 3 and cache.evictions >= 1 and cache.captures > distinct
    assert cache.peak_held <= cache.budget_bytes
    assert graph_run_bytes <= eager_bytes + cache.budget_bytes

    ref = create_train_state(cfg, num_steps=iters, device=str(cuda), multi_scale=True)
    step = make_vertex_train_step(cfg, generator=torch.Generator().manual_seed(cfg.train.seed))
    arrays = [vertex_patch_tensors(cfg, p, str(cuda)) for p in ds.patches]
    rng = np.random.default_rng(cfg.train.seed)
    for _ in range(iters // spc):
        t = arrays[int(rng.integers(len(arrays)))]
        d = step.draw(t, spc)
        for j in range(spc):
            ref, _ = step(ref, t, d["rot"][j], d["idx0"][j], d["idx1"][j])
    _same_state(state, ref)


def _served_meshes():
    rng = np.random.default_rng(0)
    v, f = icosphere(2)
    v2, f2 = icosphere(3)
    return [(add_vertex_noise(v, f, 0.1, rng), f), (add_vertex_noise(v2, f2, 0.1, rng), f2)]


def test_server_replays_one_batched_forward_and_matches_cpu(cuda):
    """A batch's first call captures its forward (K1 8 launches, as the graph
    records them) and replays it; the second replays the same graph (no
    launch through the wrapper) with the same bits; both match the server
    on the CPU."""
    from facet_graph_convolution_torch.inference.serving import InferenceServer

    cfg = default_config().replace(eval={"solver_iterations": 5})
    params = init_unet(0, device=str(cuda), **SMALL)
    meshes = _served_meshes()
    server = InferenceServer(cfg, params=params, bucket_align=256, device=str(cuda))
    k1.facet_conv_fwd.launches = 0
    first = server.denoise_batch(meshes)
    assert k1.facet_conv_fwd.launches == 8 and server._cache.captures == 1
    k1.facet_conv_fwd.launches = 0
    second = server.denoise_batch(meshes)
    assert k1.facet_conv_fwd.launches == 0 and server._cache.captures == 1
    cpu_params = {layer: {n: t.cpu() for n, t in leaves.items()}
                  for layer, leaves in params.items()}
    ref = InferenceServer(cfg, params=cpu_params, bucket_align=256,
                          device="cpu").denoise_batch(meshes)
    for (a, b), (c, d), (e, g) in zip(first, second, ref):
        assert np.array_equal(a, c) and np.array_equal(b, d)
        np.testing.assert_allclose(b, g, atol=1e-4)
        np.testing.assert_allclose(a, e, atol=1e-4)


def test_server_cache_releases_its_graphs_past_max_compiled(cuda):
    from facet_graph_convolution_torch.inference.serving import InferenceServer

    cfg = default_config().replace(eval={"solver_iterations": 5})
    server = InferenceServer(cfg, params=init_unet(0, device=str(cuda), **SMALL),
                             bucket_align=256, max_compiled=1, device=str(cuda))
    mesh = _served_meshes()[:1]
    first = server.denoise_batch(mesh)
    entry = next(iter(server._compiled.values()))
    server.denoise_batch(mesh * 2)
    assert entry.graph is None and entry.held_bytes == 0 and server._cache.evictions == 1
    again = server.denoise_batch(mesh)
    assert server._cache.captures == 3
    np.testing.assert_allclose(again[0][1], first[0][1], atol=1e-6)


def test_exported_forward_launches_k1_on_card(cuda):
    """The exported program runs the registered K1 operator on the card
    (8 launches) and matches the direct forward on the CPU."""
    from facet_graph_convolution_torch.inference.serving import export_forward, load_forward
    from facet_graph_convolution_torch.models.unet import graph_tensors, unet_apply
    from facet_graph_convolution_torch.ops.normalization import normalize_tensor

    params = init_unet(0, device=str(cuda), **SMALL)
    fn = load_forward(export_forward(default_config(), params, 256, (23, 23, 23)),
                      device=str(cuda))
    rng = np.random.default_rng(0)
    x = rng.normal(size=(1, 256, 6)).astype(np.float32)
    adjs = []
    for n in (256, 64, 16):
        a = np.zeros((1, n, 23), np.int32)
        a[0, :, 0] = np.arange(n) + 1
        a[0, :, 1] = (np.arange(n) + 1) % n + 1
        adjs.append(a)
    k1.facet_conv_fwd.launches = 0
    y = fn(params, x, *adjs)
    torch.cuda.synchronize()
    assert k1.facet_conv_fwd.launches == 8 and y.device.type == "cuda"
    cpu_params = {layer: {n: t.cpu() for n, t in leaves.items()}
                  for layer, leaves in params.items()}
    t_adjs, t_rows = graph_tensors([a[0] for a in adjs], "cpu")
    with torch.no_grad():
        ref = normalize_tensor(unet_apply(cpu_params, torch.as_tensor(x[0]), t_adjs, t_rows))
    np.testing.assert_allclose(y[0].cpu().numpy(), ref.numpy(), atol=1e-4)


# ---------------------------------------------------------------------------
# bfloat16: the bf16 forms of K1, K2 and K3 against their plain versions
# ---------------------------------------------------------------------------

BF16_TOL = 2.0 ** -8    # of the plain output's largest magnitude (module docstring)


def _bf16_close(got, want, what):
    assert got.dtype == want.dtype, what
    scale = float(want.float().abs().max()) or 1.0
    err = float((got.float() - want.float()).abs().max())
    assert err <= BF16_TOL * scale, f"{what}: {err} > 2^-8 × {scale}"


def _to_bf16(args, names):
    """``args`` with the tensors at the positions of ``names`` (cat, ux, dz
    for K1/K2; all for K3) rounded to bfloat16."""
    return [a.to(torch.bfloat16) if i in names else a for i, a in enumerate(args)]


def _bf16_pair_check(cuda, args):
    """K1 and K2 in bfloat16 on K2's ``args`` (cat, ux, dz rounded): each
    against its plain version, bitwise repeatable, one bfloat16 launch each."""
    args = _to_bf16(args, (0, 1, 6))
    cat, ux, adj, adj_t, rows, c, dz = args
    before = (k1.facet_conv_fwd.launches_bf16, k1.facet_conv_bwd.launches_bf16)
    z = k1.facet_conv_fwd(cat, ux, adj, rows, c)
    got = k1.facet_conv_bwd(*args)
    assert (k1.facet_conv_fwd.launches_bf16, k1.facet_conv_bwd.launches_bf16) == (
        before[0] + 1, before[1] + 1)
    assert z.dtype == got[0].dtype == torch.bfloat16 and got[1].dtype == torch.float32
    assert torch.equal(z, k1.facet_conv_fwd(cat, ux, adj, rows, c))
    _bf16_close(z, k1.facet_conv_fwd_plain(cat, ux, adj, rows, c), "z")
    for a, b, ref, what in zip(got, k1.facet_conv_bwd(*args), k1.facet_conv_bwd_plain(*args),
                               ("dcat", "dux")):
        assert torch.equal(a, b), what
        _bf16_close(a, ref, what)


@pytest.mark.parametrize("name,level,c_in", CONVS)
def test_bf16_kernels_at_the_path_shapes(cuda, rng, served_patch, name, level, c_in):
    """K1 and K2 in bfloat16 at each conv of a default train step (the
    served patch's slot tables, M = 9)."""
    from facet_graph_convolution_torch.models.unet import train_graph_tensors

    adjs, adj_ts, mult_rows = train_graph_tensors(served_patch.adjs, cuda)
    n_pad = adjs[level].shape[1]
    cat = rng.normal(size=(n_pad, c_in + 9)).astype(np.float32)
    cat[served_patch.adjs[level].shape[0]:] = 0.0
    _bf16_pair_check(cuda, [
        torch.as_tensor(cat, device=cuda),
        torch.as_tensor(rng.normal(size=(n_pad, 9)).astype(np.float32), device=cuda),
        adjs[level], adj_ts[level], mult_rows[level][:, :, 0].contiguous(),
        torch.as_tensor(rng.normal(size=(9,)).astype(np.float32), device=cuda),
        torch.as_tensor(rng.normal(size=(n_pad, 9 * c_in)).astype(np.float32), device=cuda)])


@pytest.mark.parametrize("c_in", [6, 37, 64, 256])
@pytest.mark.parametrize("m", [4, 9, 33, 64])
def test_bf16_kernels_take_any_m(cuda, rng, c_in, m):
    """Ragged widths (C + M odd: unaligned bf16 rows), every pass-A class
    and, past M = 32, K2's general pass A."""
    _bf16_pair_check(cuda, _bwd_args(cuda, rng, 400, 14, c_in, m))


@pytest.mark.parametrize("c_in,k", [(41, 45), (6, 300)])
def test_bf16_kernels_walk_more_than_32_slots(cuda, rng, c_in, k):
    _bf16_pair_check(cuda, _bwd_args(cuda, rng, 350, k, c_in, 9))


def test_bf16_forward_runs_channel_chunks(cuda, rng):
    """A conv wider than one K1 launch (1024 channels) in bfloat16: two
    launches, one z."""
    args = _to_bf16(_bwd_args(cuda, rng, 200, 9, 1100, 4), (0, 1))
    cat, ux, adj, _, rows, c, _ = args
    before = k1.facet_conv_fwd.launches_bf16
    z = k1.facet_conv_fwd(cat, ux, adj, rows, c)
    assert k1.facet_conv_fwd.launches_bf16 == before + 2
    _bf16_close(z, k1.facet_conv_fwd_plain(cat, ux, adj, rows, c), "z")


@pytest.mark.parametrize("s,n,m,c", K3_SHAPES + [(40, 300, 9, 6)])
def test_bf16_aggregate_kernel_matches_plain(cuda, rng, s, n, m, c):
    """K3 and its backward on bfloat16 slots and dz (q rounded to bfloat16,
    z and dx rounded once, dlogits f32), against their plain versions and
    bitwise repeatable; 40 slots walks past 32."""
    _k3_check(cuda, rng, (s, n, m, c), torch.bfloat16, _bf16_close)


def test_bf16_kernels_refuse_mixed_dtypes(cuda, rng):
    cat, ux, adj, adj_t, rows, c, dz = _bwd_args(cuda, rng, 64, 6, 9, 4)
    with pytest.raises(TypeError):
        k1.facet_conv_fwd(cat.to(torch.bfloat16), ux, adj, rows, c)
    with pytest.raises(TypeError):
        k1.facet_conv_bwd(cat.to(torch.bfloat16), ux.to(torch.bfloat16), adj, adj_t, rows, c, dz)
    with pytest.raises(TypeError):
        k1.facet_conv_fwd(cat.half(), ux.half(), adj, rows, c)
    with pytest.raises(TypeError):
        k3.weighted_aggregate(torch.zeros(3, 8, 4, device=cuda, dtype=torch.bfloat16),
                              torch.ones(3, 8, device=cuda),
                              torch.zeros(3, 8, 6, device=cuda, dtype=torch.bfloat16))
    with pytest.raises(TypeError):
        k3.weighted_aggregate_bwd(torch.zeros(3, 8, 4, device=cuda), torch.ones(3, 8, device=cuda),
                                  torch.zeros(3, 8, 6, device=cuda, dtype=torch.bfloat16),
                                  torch.zeros(8, 24, device=cuda))


# ---------------------------------------------------------------------------
# Halo-extended sources (parallel/halo.py): cat holds N_src > N rows
# ---------------------------------------------------------------------------

def _halo_tables(rng, n, n_src, k):
    """Slot tables of N nodes whose neighbours are any of N_src ≥ N source
    rows (a shard's owned rows, then its halo), with duplicate slots, and
    the transpose map over all N_src."""
    from facet_graph_convolution_torch.graph.convert import fused_mult_rows, transpose_adjacency

    adj = np.zeros((n, k), np.int32)
    adj[:, 0] = np.arange(n) + 1
    for i in range(n):
        deg = int(rng.integers(0, k - 1))
        adj[i, 1:1 + deg] = rng.choice(n_src, size=deg, replace=True) + 1
    nbr, m_n, s_m = split_self_klist(*dedupe_klist(adj))
    adj_sm = np.ascontiguousarray(nbr.T)
    return adj_sm, transpose_adjacency(adj_sm, num_targets=n_src), fused_mult_rows(m_n, s_m)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c_in", [6, 64, 128])
def test_kernels_take_halo_extended_sources(cuda, rng, c_in, dtype):
    """K1 and K2 with N_src = N + 40%: against their plain versions (f32
    1e-5; bf16 2^-8 × max|plain|) and bitwise repeatable; dcat has N_src
    rows, the halo rows summing only the slots that read them."""
    n, n_src, m = 1500, 2100, 9
    adj_sm, adj_t_sm, rows = _halo_tables(rng, n, n_src, 14)
    t = [torch.as_tensor(a, device=cuda) for a in (
        rng.normal(size=(n_src, c_in + m)).astype(np.float32),
        rng.normal(size=(n, m)).astype(np.float32), adj_sm, adj_t_sm, rows,
        rng.normal(size=(m,)).astype(np.float32),
        rng.normal(size=(n, m * c_in)).astype(np.float32))]
    cat, ux, dz = t[0].to(dtype), t[1].to(dtype), t[6].to(dtype)
    fwd = (cat, ux, t[2], t[4], t[5])
    bwd = (cat, ux, t[2], t[3], t[4], t[5], dz)
    z = k1.facet_conv_fwd(*fwd)
    dcat, dux = k1.facet_conv_bwd(*bwd)
    assert z.shape == (n, m * c_in) and dcat.shape == (n_src, c_in + m)
    assert torch.equal(z, k1.facet_conv_fwd(*fwd))
    assert all(torch.equal(a, b) for a, b in zip((dcat, dux), k1.facet_conv_bwd(*bwd)))
    for got, ref in zip((z, dcat, dux), (k1.facet_conv_fwd_plain(*fwd),
                                         *k1.facet_conv_bwd_plain(*bwd))):
        if dtype == torch.float32:
            torch.testing.assert_close(got, ref, atol=1e-5, rtol=1e-5)
        else:
            assert float((got.float() - ref.float()).abs().max()) <= (
                2.0 ** -8 * float(ref.float().abs().max()))


def test_kernels_past_32_bit_element_offsets(cuda, rng):
    """N = 3,801,088 nodes, C = 64, M = 9: z has N·M·C and K2's scratch
    (K'+1)·N·80 elements, both past 2^31. The graph is 928 copies of one
    4,096-node graph with the same inputs, so every copy's rows of z, dcat
    and dux must equal the first copy's bit for bit, and the first copy's
    the plain versions' on the 4,096-node tables."""
    n0, copies, c_in, m, k = 4096, 928, 64, 9, 14
    adj_sm0, _, rows0 = _all_tables(rng, n0, k)
    k_nbr = adj_sm0.shape[0]
    n = n0 * copies
    assert n * m * c_in > 2**31 and (k_nbr + 1) * n * 80 > 2**31
    offs = np.repeat(np.arange(copies, dtype=np.int64) * n0, n0)
    adj_sm = np.where(np.tile(adj_sm0, copies) > 0, np.tile(adj_sm0, copies) + offs, 0)
    from facet_graph_convolution_torch.graph.convert import transpose_adjacency

    adj_t_sm = transpose_adjacency(adj_sm.astype(np.int32), num_targets=n)
    small = [rng.normal(size=s).astype(np.float32) for s in (
        (n0, c_in + m), (n0, m), (m,), (n0, m * c_in))]
    cat, ux, dz = (torch.as_tensor(a, device=cuda).repeat(copies, 1)
                   for a in (small[0], small[1], small[3]))
    c = torch.as_tensor(small[2], device=cuda)
    tables = [torch.as_tensor(a, device=cuda) for a in (
        adj_sm.astype(np.int32), adj_t_sm, np.tile(rows0, copies))]
    z = k1.facet_conv_fwd(cat, ux, tables[0], tables[2], c)
    dcat, dux = k1.facet_conv_bwd(cat, ux, tables[0], tables[1], tables[2], c, dz)
    for t in (z, dcat, dux):
        assert torch.equal(t[-n0:], t[:n0])
    del cat, ux, dz, tables
    s = [torch.as_tensor(a, device=cuda) for a in (
        small[0], small[1], adj_sm0, transpose_adjacency(adj_sm0, num_targets=n0), rows0,
        small[2], small[3])]
    torch.testing.assert_close(z[:n0], k1.facet_conv_fwd_plain(*s[:3], *s[4:6]),
                               atol=1e-5, rtol=1e-5)
    for got, ref in zip((dcat[:n0], dux[:n0]), k1.facet_conv_bwd_plain(*s)):
        torch.testing.assert_close(got, ref, atol=1e-5, rtol=1e-5)


def test_sharded_step_at_one_rank_equals_flat_step(cuda):
    """The halo path at one rank (no process group, no exchange) against the
    flat train step from the same state and draws on the card: loss and
    every gradient within 1e-5 relative."""
    from facet_graph_convolution_torch.data.dataset import TrainingSet, bucket_size, pad_patch_to
    from facet_graph_convolution_torch.parallel.halo import (
        build_partition,
        make_sharded_train_step,
        sample_mask_from,
        shard_rows,
    )
    from facet_graph_convolution_torch.parallel.mesh import GraphGroup
    from facet_graph_convolution_torch.training.trainer import (
        _leaves,
        create_train_state,
        make_normals_train_step,
        patch_tensors,
    )

    v, f = icosphere(3)
    ds = TrainingSet(max_patch_size=10**9, coarsening_steps=2, coarsening_levels=3,
                     k_faces=23, seed=0)
    ds.add_mesh(add_vertex_noise(v, f, 0.1, np.random.default_rng(1)), f, gt_vertices=v)
    patch = pad_patch_to(ds.patches[0], bucket_size(ds.patches[0].num_nodes, 1024))
    cfg = default_config().replace(model={"channels": (8, 16, 32), "num_filters": 4,
                                          "fc_channels": 32}, train={"loss_samples": 512})
    group = GraphGroup(0, 1, cuda)
    rng = np.random.default_rng(2)
    idx = np.unique(rng.integers(0, patch.num_nodes, 512))
    rot = torch.as_tensor(np.linalg.qr(rng.normal(size=(3, 3)))[0].astype(np.float32))
    a, b = (create_train_state(cfg, device="cuda") for _ in range(2))
    step = make_sharded_train_step(cfg, build_partition(patch.adjs, 1), group)
    a, loss = step(a, shard_rows(patch.inputs, group), shard_rows(patch.gt_normals, group),
                   sample_mask_from(idx, patch.num_nodes, group), rot=rot)
    b, ref = make_normals_train_step(cfg)(b, *patch_tensors(patch, "cuda"), rot=rot,
                                          sample_idx=torch.as_tensor(idx))
    assert abs(float(loss) - float(ref)) <= 1e-5 * abs(float(ref))
    for p, q in zip(_leaves(a.params), _leaves(b.params)):
        torch.testing.assert_close(p.grad, q.grad, atol=1e-5 * float(q.grad.abs().max()),
                                   rtol=0)


def _banded_window_case(rng, n, halo, c_in, out, dtype, device, block=512, k=12, m=9):
    """K5's arguments on a banded K-list (neighbours within ±96 rows, a fifth
    of the slots pads; with ``halo``, a tenth of the live slots read one of
    ``halo`` rows after the n): its windowed tables, random inputs and a
    cotangent ``gy``."""
    from facet_graph_convolution_torch.graph.convert import windowed_lane_tables
    from facet_graph_convolution_torch.ops.windowed_conv import window_tensors

    adj = np.clip(np.arange(n)[:, None] + rng.integers(-96, 97, size=(n, k)), 0, n - 1) + 1
    adj[rng.random((n, k)) < 0.2] = 0
    if halo:
        to_tail = (rng.random(adj.shape) < 0.1) & (adj > 0)
        adj = np.where(to_tail, rng.integers(n + 1, n + halo + 1, size=adj.shape), adj)
    wt = windowed_lane_tables(adj.astype(np.int32), num_sources=n + halo, block=block, align=64)
    mult = np.where(adj.T > 0, rng.uniform(0.5, 2.0, size=(k, n)), 0.0)
    rows = np.concatenate([np.ones((1, n)), mult]) / (1.0 + mult.sum(0))

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    args = (wt.geometry, t(rng.normal(size=(n + halo, c_in + m))).to(dtype),
            t(rng.normal(size=(n, m))), t(rng.normal(size=(out, m * c_in)) * 0.1),
            t(rng.normal(size=(m,))), t(rows), window_tensors(wt.arrays, device))
    return args, t(rng.normal(size=(n, out)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("halo", [0, 160])
@pytest.mark.parametrize("c_in,out", [(6, 32), (64, 32), (128, 64)])
def test_windowed_kernels_match_plain(cuda, rng, c_in, out, halo, dtype):
    """K5 and its backward against their plain versions (f32 1e-5 × max|plain|,
    bf16 2^-8 × max|plain|, per output) and bit for bit launch to launch, on
    4,352 rows (the last slab overlapping its predecessor), with and without
    halo rows."""
    from facet_graph_convolution_torch.ops import windowed_conv as k5

    args, gy = _banded_window_case(rng, 4352, halo, c_in, out, dtype, cuda)
    y, grads = k5.windowed_conv_fwd(*args), k5.windowed_conv_bwd(*args, gy)
    assert torch.equal(y, k5.windowed_conv_fwd(*args))
    assert all(torch.equal(a, b) for a, b in zip(grads, k5.windowed_conv_bwd(*args, gy)))
    assert grads[0].shape == (4352 + halo, c_in + 9) and grads[0].dtype == dtype
    refs = (k5.windowed_fused_conv_fwd_plain(*args), *k5.windowed_fused_conv_bwd_plain(*args, gy))
    tol = 1e-5 if dtype == torch.float32 else 2.0 ** -8
    for got, ref in zip((y, *grads), refs):
        assert got.dtype == ref.dtype
        assert float((got.float() - ref.float()).abs().max()) <= tol * float(
            ref.float().abs().max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,c_in,out", [(33, 16, 256), (9, 64, 256), (4, 5, 6), (9, 32, 48),
                                        (9, 32, 40)])
def test_windowed_kernels_take_wide_convs(cuda, rng, m, c_in, out, dtype):
    """K5 and its backward past their first limits (M <= 32, out <= 128):
    M = 33 (the any-M path) and M = 9 at out = 256 (two out tiles in the
    forward, four in pass W); M = 4, C = 5, out = 6, whose weight rows the
    wrapper pads to 16 bytes for the forward's cp.async; and out = 48 and
    40 at M·C = 288, which pass W takes in one 64-column out tile (a 48-
    column tile would leave warps without an m16 tile and dW columns
    unwritten), against the plain versions at the same bounds as the
    model's convs, bit for bit launch to launch, with halo rows."""
    from facet_graph_convolution_torch.ops import windowed_conv as k5

    args, gy = _banded_window_case(rng, 4352, 160, c_in, out, dtype, cuda, m=m)
    y, grads = k5.windowed_conv_fwd(*args), k5.windowed_conv_bwd(*args, gy)
    assert torch.equal(y, k5.windowed_conv_fwd(*args))
    assert all(torch.equal(a, b) for a, b in zip(grads, k5.windowed_conv_bwd(*args, gy)))
    assert y.shape == (4352, out) and grads[2].shape == (out, m * c_in)
    refs = (k5.windowed_fused_conv_fwd_plain(*args), *k5.windowed_fused_conv_bwd_plain(*args, gy))
    tol = 1e-5 if dtype == torch.float32 else 2.0 ** -8
    for got, ref in zip((y, *grads), refs):
        assert got.dtype == ref.dtype
        assert float((got.float() - ref.float()).abs().max()) <= tol * float(
            ref.float().abs().max())


def test_windowed_kernels_refuse_what_does_not_fit(cuda, rng):
    """An M whose 16-row softmax tile passes a block's 227 KB of shared
    memory is refused with its cause, forward and backward, and launches
    nothing."""
    from facet_graph_convolution_torch.ops import windowed_conv as k5

    args, gy = _banded_window_case(rng, 1024, 0, 2, 8, torch.float32, cuda, block=256, m=1200)
    before = (k5.windowed_conv_fwd.launches, k5.windowed_conv_bwd.launches)
    with pytest.raises(ValueError, match="shared memory"):
        k5.windowed_conv_fwd(*args)
    with pytest.raises(ValueError, match="shared memory"):
        k5.windowed_conv_bwd(*args, gy)
    assert (k5.windowed_conv_fwd.launches, k5.windowed_conv_bwd.launches) == before


def test_windowed_sharded_step_at_one_rank_equals_flat_step(cuda, monkeypatch):
    """The one-rank sharded step with its two finest levels windowed (K5;
    windows forced from 64 rows in slabs of 128) against the same step flat
    (K1/K2) on the card: loss within 1e-5 relative, every gradient within
    1e-4 of its largest magnitude (the same sums in another order)."""
    from facet_graph_convolution_torch.data.dataset import TrainingSet, bucket_size, pad_patch_to
    from facet_graph_convolution_torch.ops import windowed_conv as k5
    from facet_graph_convolution_torch.parallel import halo
    from facet_graph_convolution_torch.parallel.mesh import GraphGroup
    from facet_graph_convolution_torch.training.trainer import _leaves, create_train_state

    v, f = icosphere(3)
    ds = TrainingSet(max_patch_size=10**9, coarsening_steps=2, coarsening_levels=3,
                     k_faces=23, seed=0)
    ds.add_mesh(add_vertex_noise(v, f, 0.1, np.random.default_rng(1)), f, gt_vertices=v)
    patch = pad_patch_to(ds.patches[0], bucket_size(ds.patches[0].num_nodes, 1024))
    cfg = default_config().replace(model={"channels": (8, 16, 32), "num_filters": 4,
                                          "fc_channels": 32}, train={"loss_samples": 512})
    group = GraphGroup(0, 1, cuda)
    rng = np.random.default_rng(2)
    mask = halo.sample_mask_from(np.unique(rng.integers(0, patch.num_nodes, 512)),
                                 patch.num_nodes, group)
    rot = torch.as_tensor(np.linalg.qr(rng.normal(size=(3, 3)))[0].astype(np.float32))
    x, gt = halo.shard_rows(patch.inputs, group), halo.shard_rows(patch.gt_normals, group)
    out = []
    for min_nodes in (64, 10**9):
        monkeypatch.setattr(halo, "WINDOWED_MIN_NODES", min_nodes)
        monkeypatch.setattr(halo, "WINDOWED_BLOCK", 128)
        k5.windowed_conv_fwd.launches = 0
        state = create_train_state(cfg, device="cuda")
        step = halo.make_sharded_train_step(cfg, halo.build_partition(patch.adjs, 1), group)
        state, loss = step(state, x, gt, mask, rot=rot)
        out.append((float(loss), [p.grad for p in _leaves(state.params)],
                    k5.windowed_conv_fwd.launches))
    (loss, grads, launches), (ref, ref_grads, none) = out
    assert launches >= 3 and none == 0
    assert abs(loss - ref) <= 1e-5 * abs(ref)
    for g, r in zip(grads, ref_grads):
        torch.testing.assert_close(g, r, atol=1e-4 * float(r.abs().max()), rtol=0)
