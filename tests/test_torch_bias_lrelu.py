"""The bias + lrelu kernel pair (``ops/bias_lrelu_kernel.py``,
``csrc/bias_lrelu.cu``) against autograd through the chain it replaces,
``lrelu(y + b)``, bit for bit.

On the CPU (no card needed): the kernels' rule, written here in torch
(:func:`_class_codes` and :func:`_dz_from_codes`, the class of z and dz
from dh and the class alone), gives autograd's dz through the chain bit
for bit, signed zeros, denormals, infinities and NaN included, with and
without a bias, at C = 3, 32 and 1024 and odd N; the gradient is +0 at
z = ±0; :func:`bias_lrelu` is the chain on the CPU and its operator has a
fake; the launchers refuse CPU tensors and other dtypes; the counters stay
0 on the CPU, through a U-Net's forward and backward too.

On the card (skipped without one; ``python -m pytest
tests/test_torch_bias_lrelu.py -q -m cuda --noconftest``): the kernels
against the chain on the card bit for bit (h, the codes, dz and db) at the
torus's fine-head shape [1,273,920 × 1024], the patch's, and odd shapes
whose N·C is not a multiple of 4 or whose rows are not 16-byte aligned;
views and 3-D inputs through the kernels too, float64 refused; two
launches give the same bits; a captured CUDA graph of a layer's forward
and backward gives the eager bits; 7 forward and 7 backward launches a
normals train step (eager, through the captured graph, and the one-rank
sharded step), 9 and 9 a vertex step (with ``fc_mid`` and ``fc_coarse``);
the exported forward on the card equals the eager forward.
"""

import numpy as np
import pytest
import torch

from facet_graph_convolution_torch.ops import bias_lrelu_kernel as bl
from facet_graph_convolution_torch.ops.normalization import lrelu

SPECIALS = [0.0, -0.0, 1e-45, -1e-45, 1e-39, -1e-39, float("inf"), -float("inf"),
            float("nan"), -float("nan"), 3e38, -3e38, 1e-30, -1e-30]
SMALL_MODEL = {"channels": (8, 16, 32), "num_filters": 4, "fc_channels": 32}
# the classes of z in the forward kernel's codes
ZERO, POS, NEG, NAN = 0, 1, 2, 3


def _class_codes(z):
    """The class of each element of z, uint8: POS where z > 0, NEG where
    z < 0, NAN, else ZERO (±0)."""
    code = torch.full(z.shape, ZERO, dtype=torch.uint8, device=z.device)
    return (code.masked_fill_(z > 0, POS).masked_fill_(z < 0, NEG)
            .masked_fill_(torch.isnan(z), NAN))


def _dz_from_codes(dh, code, alpha=0.1):
    """The backward kernel's rule: dz from dh and the class of z, the sums
    autograd accumulates at z through the chain (relu's backward gives +0
    where it blocks, the neg after the second relu −0)."""
    through_neg = -((-dh) * alpha)
    pzero = torch.zeros_like(dh)
    nzero = torch.full_like(dh, -0.0)
    return torch.where(code == POS, dh + nzero,
                       torch.where(code == NEG, pzero + through_neg,
                                   torch.where(code == NAN, dh + through_neg, pzero + nzero)))


def _bits(t):
    return t.detach().contiguous().view(torch.int32)


def _same_bits(a, b, what):
    assert a.shape == b.shape and a.dtype == b.dtype, what
    assert torch.equal(_bits(a), _bits(b)), what


def _inputs(n, c, bias, device="cpu", seed=0):
    """y [n, c] with every special value in it (and in b, dh), normal values
    elsewhere at three scales."""
    gen = torch.Generator().manual_seed(seed)
    y = torch.randn(n, c, generator=gen) * 3.0
    flat = y.view(-1)
    specials = torch.tensor(SPECIALS)
    flat[:min(len(specials), flat.numel())] = specials[:flat.numel()]
    flat[-len(specials):] = specials[-flat.numel():] * 1e-3
    b = None
    if bias:
        b = torch.randn(c, generator=gen) * 0.5
        b[0] = -0.0
        # columns whose bias cancels some y exactly, so z = ±0 away from the specials
        y[1::5, -1] = -b[-1]
    dh = torch.randn(n, c, generator=gen)
    gflat = dh.view(-1)
    gflat[::7] = float("nan")
    gflat[1::11] = -0.0
    gflat[2::13] = 1e-45
    gflat[3::17] = -float("inf")
    move = (lambda t: None if t is None else t.to(device))
    return move(y), move(b), move(dh)


def _chain(y, b, dh, alpha=0.1):
    """h, dy and db by autograd through the chain as the U-Net ran it."""
    y = y.clone().requires_grad_()
    b = None if b is None else b.clone().requires_grad_()
    h = lrelu(y if b is None else y + b, alpha)
    grads = torch.autograd.grad(h, [y] + ([] if b is None else [b]), dh)
    return h.detach(), grads[0], (grads[1] if b is not None else None)


# ---------------------------------------------------------------------------
# CPU: the rule and the plain path
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,c", [(37, 3), (101, 32), (13, 1024)])
@pytest.mark.parametrize("bias", [False, True])
def test_plain_rule_matches_chain_bitwise(n, c, bias):
    """The kernels' rule, from z alone: the codes and dz from them give
    autograd's dz through the chain; db its sum over the rows; the plain
    forward the chain's h."""
    before = (bl.bias_lrelu_fwd.launches, bl.bias_lrelu_bwd.launches)
    y, b, dh = _inputs(n, c, bias)
    h, dy, db = _chain(y, b, dh)
    z = y if b is None else y + b
    code = _class_codes(z)
    assert code.dtype == torch.uint8
    assert set(code.unique().tolist()) == {ZERO, POS, NEG, NAN}
    dz = _dz_from_codes(dh, code)
    _same_bits(dz, dy, "dz")
    if bias:
        _same_bits(dz.sum(0), db, "db")
    _same_bits(bl.bias_lrelu_plain(y, b), h, "h")
    assert (bl.bias_lrelu_fwd.launches, bl.bias_lrelu_bwd.launches) == before


def test_gradient_is_zero_at_zero():
    """z = ±0 takes gradient +0 whatever dh is (F.leaky_relu would give α);
    the class rule for every value of one row."""
    z = torch.tensor([[0.0, -0.0, 2.0, -2.0, float("nan"), 1e-45, -1e-45, float("inf")]])
    dh = torch.tensor([[float("nan"), -3.0, -0.0, 5.0, 2.0, 1.0, 1.0, -0.0]])
    code = _class_codes(z)
    assert code.tolist() == [[ZERO, ZERO, POS, NEG, NAN, POS, NEG, POS]]
    dz = _dz_from_codes(dh, code)
    _same_bits(dz[0, :2], torch.zeros(2), "dz at ±0")
    _same_bits(dz, _chain(z, None, dh)[1], "dz")
    assert float(dz[0, 3]) == np.float32(5.0) * np.float32(0.1)


@pytest.mark.parametrize("bias", [False, True])
def test_helper_on_the_cpu_is_the_chain(bias):
    """:func:`bias_lrelu` under autograd and under ``no_grad`` (the
    operator) gives the chain's bits on the CPU and launches nothing."""
    before = (bl.bias_lrelu_fwd.launches, bl.bias_lrelu_bwd.launches)
    y, b, dh = _inputs(41, 32, bias)
    h, dy, db = _chain(y, b, dh)
    yg = y.clone().requires_grad_()
    bg = None if b is None else b.clone().requires_grad_()
    out = bl.bias_lrelu(yg, bg, 0.1)
    grads = torch.autograd.grad(out, [yg] + ([] if bg is None else [bg]), dh)
    _same_bits(out, h, "h")
    _same_bits(grads[0], dy, "dy")
    if bias:
        _same_bits(grads[1], db, "db")
    with torch.no_grad():
        _same_bits(bl.bias_lrelu(y, b, 0.1), h, "h, no_grad")
    _same_bits(bl.bias_lrelu_op(y, b, 0.1), h, "operator")
    assert (bl.bias_lrelu_fwd.launches, bl.bias_lrelu_bwd.launches) == before


def test_operator_fake_gives_h_shape():
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        y = torch.empty(5, 7)
        h = bl.bias_lrelu_op(y, torch.empty(7), 0.1)
        assert tuple(h.shape) == (5, 7) and h.dtype == torch.float32


def test_backward_refuses_codes_of_another_shape():
    with pytest.raises(ValueError, match="one shape"):
        bl.bias_lrelu_bwd(torch.zeros(3, 4), torch.zeros(3, 5, dtype=torch.uint8))
    with pytest.raises(ValueError, match="uint8"):
        bl.bias_lrelu_bwd(torch.zeros(3, 4), torch.zeros(3, 4))


def test_launchers_take_cuda_float32_only():
    """The kernels' launchers and Function refuse what has no kernel (the
    helper and the operator run the chain on CPU tensors instead)."""
    y = torch.zeros(4, 8)
    with pytest.raises(ValueError, match="no kernel for device cpu"):
        bl.bias_lrelu_fwd(y, None)
    with pytest.raises(TypeError, match="float32"):
        bl.bias_lrelu_fwd(y.double(), None)
    with pytest.raises(ValueError, match="no kernel for device cpu"):
        bl.bias_lrelu_bwd(y, torch.zeros(4, 8, dtype=torch.uint8))
    with pytest.raises(ValueError, match="no kernel for device cpu"):
        bl.BiasLrelu.apply(y.requires_grad_(), None, 0.1)


def test_cpu_unet_backward_launches_nothing():
    """A U-Net forward and backward on the CPU runs the chain: no launch."""
    from facet_graph_convolution_torch.models.unet import init_unet, train_graph_tensors, unet_apply

    params = init_unet(seed=0, device="cpu", multi_scale=True, **SMALL_MODEL)
    for leaves in params.values():
        for t in leaves.values():
            t.requires_grad_()
    rng = np.random.default_rng(0)
    raw = []
    for n in (64, 16, 4):
        a = np.zeros((n, 4), np.int32)
        a[:, 0] = np.arange(n) + 1
        a[:, 1] = rng.integers(1, n + 1, size=n)
        raw.append(a)
    adjs, adj_ts, rows = train_graph_tensors(raw, "cpu")
    x = torch.as_tensor(rng.normal(size=(64, 6)).astype(np.float32))
    before = (bl.bias_lrelu_fwd.launches, bl.bias_lrelu_bwd.launches)
    heads = unet_apply(params, x, adjs, rows, adj_ts=adj_ts, multi_scale=True)
    sum(h.square().sum() for h in heads).backward()
    assert (bl.bias_lrelu_fwd.launches, bl.bias_lrelu_bwd.launches) == before
    assert all(torch.isfinite(p.grad).all() for leaves in params.values() for p in leaves.values())


# ---------------------------------------------------------------------------
# The card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _check_kernel(cuda, y, b, dh, full_chain=True, rows=131072):
    """The kernels on (y, b, dh) against the chain on the card: h, codes and
    dz bit for bit, chunk by chunk of ``rows`` rows; db against autograd's
    over the whole tensor when ``full_chain``. Each kernel counted once."""
    before = (bl.bias_lrelu_fwd.launches, bl.bias_lrelu_bwd.launches)
    h, code = bl.bias_lrelu_fwd(y, b, 0.1, need_code=True)
    dz = bl.bias_lrelu_bwd(dh, code, 0.1)
    assert (bl.bias_lrelu_fwd.launches, bl.bias_lrelu_bwd.launches) == (before[0] + 1,
                                                                      before[1] + 1)
    for r0 in range(0, y.shape[0], rows):
        part = slice(r0, r0 + rows)
        hc, dyc, _ = _chain(y[part], b, dh[part])
        _same_bits(h[part], hc, f"h rows {r0}+")
        assert torch.equal(code[part], _class_codes(y[part] if b is None else y[part] + b))
        _same_bits(dz[part], dyc, f"dz rows {r0}+")
        del hc, dyc
    if full_chain and b is not None:
        _same_bits(dz.sum(0), _chain(y, b, dh)[2], "db")
    return h, code, dz


CARD_SHAPES = [(25600, 1024, True), (25600, 32, False), (1001, 3, True), (777, 33, False),
               (513, 64, True), (7, 1, True), (1, 5, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("n,c,bias", CARD_SHAPES)
def test_kernel_matches_chain_bitwise(cuda, n, c, bias):
    y, b, dh = _inputs(n, c, bias, cuda, seed=n + c)
    _check_kernel(cuda, y, b, dh)


@pytest.mark.cuda
def test_kernel_matches_chain_at_the_torus_fine_head(cuda):
    """fc1's output at the torus's 1,273,920 level-0 rows, 1024 wide."""
    y, b, dh = _inputs(1273920, 1024, True, cuda, seed=3)
    _check_kernel(cuda, y, b, dh, full_chain=False)


@pytest.mark.cuda
@pytest.mark.parametrize("bias", [False, True])
def test_kernel_on_rows_not_16_byte_aligned(cuda, bias):
    """A contiguous view one element into its storage: every element one a
    thread."""
    y, b, dh = _inputs(300, 12, bias, cuda, seed=5)
    ys = torch.empty(y.numel() + 1, device=cuda)[1:].view_as(y).copy_(y)
    dhs = torch.empty(dh.numel() + 1, device=cuda)[1:].view_as(dh).copy_(dh)
    assert ys.is_contiguous() and ys.data_ptr() % 16
    h, code, dz = _check_kernel(cuda, ys, b, dhs)
    _same_bits(h, bl.bias_lrelu_fwd(y, b, 0.1)[0], "aligned h")


@pytest.mark.cuda
def test_kernel_takes_views_and_3d_and_refuses_float64(cuda):
    """A transposed view and a [B, N, C] activation go through the kernels
    (counted), with the chain's bits for h, dy and db; float64 on the card
    is refused, under autograd and without."""
    y, b, dh = _inputs(640, 48, True, cuda, seed=11)
    for view, grad in ((y.t().contiguous().t(), dh), (y.reshape(4, 160, 48),
                                                      dh.reshape(4, 160, 48))):
        assert not view.is_contiguous() or view.dim() == 3
        h, dy, db = _chain(view, b, grad)
        before = _counts()
        yg, bg = view.clone().requires_grad_(), b.clone().requires_grad_()
        out = bl.bias_lrelu(yg, bg, 0.1)
        got = torch.autograd.grad(out, [yg, bg], grad)
        assert _counts() == (before[0] + 1, before[1] + 1)
        _same_bits(out, h, "h")
        _same_bits(got[0], dy, "dy")
        _same_bits(got[1], db, "db")
    with pytest.raises(TypeError, match="float32"):
        bl.bias_lrelu(y.double().requires_grad_(), None, 0.1)
    with pytest.raises(TypeError, match="float32"), torch.no_grad():
        bl.bias_lrelu(y.double(), None, 0.1)


@pytest.mark.cuda
def test_kernel_is_repeatable_and_writes_no_code_without_gradient(cuda):
    y, b, dh = _inputs(4099, 128, True, cuda, seed=9)
    h1, c1 = bl.bias_lrelu_fwd(y, b, 0.1, need_code=True)
    h2, c2 = bl.bias_lrelu_fwd(y, b, 0.1, need_code=True)
    h3, c3 = bl.bias_lrelu_fwd(y, b, 0.1)
    assert c3 is None
    _same_bits(h1, h2, "h")
    _same_bits(h1, h3, "h without codes")
    assert torch.equal(c1, c2)
    _same_bits(bl.bias_lrelu_bwd(dh, c1, 0.1), bl.bias_lrelu_bwd(dh, c2, 0.1), "dz")
    before = bl.bias_lrelu_fwd.launches
    with torch.no_grad():
        _same_bits(bl.bias_lrelu(y.requires_grad_(), b, 0.1), h1, "no_grad")
    assert bl.bias_lrelu_fwd.launches == before + 1


@pytest.mark.cuda
def test_captured_layer_equals_eager(cuda):
    """A dense layer's bias_lrelu forward and backward captured into a CUDA
    graph and replayed: the eager bits; the wrappers count the capture's
    launches only."""
    gen = torch.Generator().manual_seed(4)
    x = torch.randn(2048, 32, generator=gen).to(cuda)
    w = (torch.randn(32, 1024, generator=gen) * 0.2).to(cuda).requires_grad_()
    b = (torch.randn(1024, generator=gen) * 0.1).to(cuda).requires_grad_()
    w_out = (torch.randn(1024, 3, generator=gen) * 0.05).to(cuda)

    def step():
        h = bl.bias_lrelu(x @ w, b, 0.1)
        loss = (h @ w_out).square().sum()
        gw, gb = torch.autograd.grad(loss, [w, b])
        return loss.detach(), gw, gb

    eager = step()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = (bl.bias_lrelu_fwd.launches, bl.bias_lrelu_bwd.launches)
    with torch.cuda.graph(graph):
        captured = step()
    assert (bl.bias_lrelu_fwd.launches, bl.bias_lrelu_bwd.launches) == (before[0] + 1,
                                                                      before[1] + 1)
    for _ in range(3):
        graph.replay()
    torch.cuda.synchronize()
    assert (bl.bias_lrelu_fwd.launches, bl.bias_lrelu_bwd.launches) == (before[0] + 1,
                                                                      before[1] + 1)
    for a, e, what in zip(captured, eager, ("loss", "dw", "db")):
        _same_bits(a, e, what)


def _counts():
    return (bl.bias_lrelu_fwd.launches, bl.bias_lrelu_bwd.launches)


def _train_counts(cuda, kind, monkeypatch):
    """Kernel launches (forward, backward) a train step: one eager step
    (``normals``, ``vertex``), the one-rank sharded step flat or with its
    two finest levels windowed (``sharded``, ``sharded_windowed``), or the
    captured graph's (``graph``: a call of 5 steps launches the warm-up
    step and the capture, 2 steps; a second call replays and launches
    nothing)."""
    from facet_graph_convolution_torch.config import default_config
    from facet_graph_convolution_torch.data.dataset import TrainingSet, bucket_size, pad_patch_to
    from facet_graph_convolution_torch.data.synthetic import add_vertex_noise, icosphere
    from facet_graph_convolution_torch.ops import windowed_conv as k5
    from facet_graph_convolution_torch.parallel import halo
    from facet_graph_convolution_torch.parallel.mesh import GraphGroup
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

    vertex = kind == "vertex"
    v, f = icosphere(3)
    ds = TrainingSet(max_patch_size=20000, coarsening_steps=2, coarsening_levels=3,
                     k_faces=23, seed=0)
    noisy = add_vertex_noise(v, f, 0.2, np.random.default_rng(0))
    (ds.add_mesh_with_vertices if vertex else ds.add_mesh)(noisy, f, gt_vertices=v)
    cfg = default_config().replace(model=SMALL_MODEL,
                                   train={"chamfer_samples": 64, "loss_samples": 128})
    patch = ds.patches[0]
    rng = np.random.default_rng(1)
    rot = torch.as_tensor(np.linalg.qr(rng.normal(size=(3, 3)))[0].astype(np.float32))
    state = create_train_state(cfg, device=str(cuda), multi_scale=vertex)
    idx = rng.integers(0, patch.num_nodes, size=128)
    if kind.startswith("sharded"):
        patch = pad_patch_to(patch, bucket_size(patch.num_nodes, 1024))
        group = GraphGroup(0, 1, cuda)
        if kind == "sharded_windowed":
            monkeypatch.setattr(halo, "WINDOWED_MIN_NODES", 64)
            monkeypatch.setattr(halo, "WINDOWED_BLOCK", 128)
        step = halo.make_sharded_train_step(cfg, halo.build_partition(patch.adjs, 1), group)
        args = (halo.shard_rows(patch.inputs, group), halo.shard_rows(patch.gt_normals, group),
                halo.sample_mask_from(np.unique(idx), patch.num_nodes, group))
    before = _counts()
    if vertex:
        tensors = vertex_patch_tensors(cfg, patch, str(cuda))
        n_v = patch.vertices.shape[0]
        make_vertex_train_step(cfg)(state, tensors, rot, torch.as_tensor(rng.integers(0, n_v, 64)),
                                    torch.as_tensor(rng.integers(0, n_v, 64)))
    elif kind == "graph":
        scanned = make_scanned_train_step(state, cfg, stack_patch_tensors([patch], str(cuda)), 5)
        gen = torch.Generator().manual_seed(7)
        scanned(state, normals_draws(cfg, gen, [0] * 5, patch.num_nodes))
        captured = _counts()
        scanned(state, normals_draws(cfg, gen, [0] * 5, patch.num_nodes))
        torch.cuda.synchronize()
        assert _counts() == captured                  # replays count nothing
    elif kind.startswith("sharded"):
        k5_before = k5.windowed_conv_fwd.launches
        step(state, *args, rot=rot)
        assert (k5.windowed_conv_fwd.launches > k5_before) == (kind == "sharded_windowed")
    else:
        make_normals_train_step(cfg)(state, *patch_tensors(patch, str(cuda)), rot=rot,
                                     sample_idx=torch.as_tensor(idx))
    after = _counts()
    return (after[0] - before[0], after[1] - before[1])


@pytest.mark.cuda
@pytest.mark.parametrize("kind,count", [("normals", 7), ("vertex", 9), ("graph", 14),
                                        ("sharded", 7), ("sharded_windowed", 7)])
def test_launches_a_train_step(cuda, kind, count, monkeypatch):
    """conv1, conv2, conv3, dconv3, dconv2, dconv1, fc1 (and fc_mid,
    fc_coarse in the vertex step's three heads), each once each way, on
    every path the train step takes (the graph: its warm-up step and its
    capture)."""
    assert _train_counts(cuda, kind, monkeypatch) == (count, count)


@pytest.mark.cuda
def test_exported_forward_on_card_equals_eager(cuda):
    """``export_forward`` traced on the card, ``load_forward`` on the card:
    the eager forward's bits, the kernel launched 7 times a call."""
    from facet_graph_convolution_torch.config import default_config
    from facet_graph_convolution_torch.inference.exported import load_forward
    from facet_graph_convolution_torch.inference.serving import batched_forward, export_forward
    from facet_graph_convolution_torch.graph.convert import batched_level_tables
    from facet_graph_convolution_torch.models.unet import init_unet

    cfg = default_config()
    params = init_unet(seed=0, device=str(cuda))
    rng = np.random.default_rng(0)
    x = rng.normal(size=(1, 256, 6)).astype(np.float32)
    adjs = []
    for n in (256, 64, 16):
        a = np.zeros((1, n, 23), np.int32)
        a[0, :, 0] = np.arange(n) + 1
        a[0, :, 1] = rng.integers(1, n + 1, size=n)
        adjs.append(a)
    fn = load_forward(export_forward(cfg, params, num_nodes=256, adj_widths=(23, 23, 23)),
                      device=str(cuda))
    before = bl.bias_lrelu_fwd.launches
    y = fn(params, x, *adjs)
    assert bl.bias_lrelu_fwd.launches == before + 7
    tables = batched_level_tables(adjs, fn.meta["group"], fn.meta["widths"])
    t_adjs = [torch.as_tensor(a, device=cuda) for a, _ in tables]
    t_rows = [torch.as_tensor(r, device=cuda) for _, r in tables]
    with torch.no_grad():
        ref = batched_forward(params, torch.as_tensor(x, device=cuda), t_adjs, t_rows,
                              coarsening_steps=cfg.model.coarsening_steps,
                              alpha=cfg.model.lrelu_alpha)
    _same_bits(y, ref, "exported forward")
