"""The port's CUDA kernel on the card, against its plain PyTorch version.

These tests need an NVIDIA GPU with ``nvcc`` (they build ``csrc/``) and skip
without one; run them on the card with

    python -m pytest tests/test_torch_cuda.py -q -m cuda --noconftest

(``--noconftest``: the suite's conftest imports JAX, which a card machine
running only the port may not have.)

Tolerances, float32 with TF32 off: K1 atol 1e-5 + rtol 1e-5 (the same sums
in another order); the U-Net forward and inference atol 1e-4.
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
from facet_graph_convolution_torch.inference.driver import infer_normals
from facet_graph_convolution_torch.models.unet import init_unet
from facet_graph_convolution_torch.ops import facet_conv as k1

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


def _tables(rng, n, k):
    adj = np.zeros((n, k), np.int32)
    adj[:, 0] = np.arange(n) + 1
    for i in range(n):
        deg = int(rng.integers(0, k - 1))
        adj[i, 1:1 + deg] = rng.choice(n, size=deg, replace=True) + 1
    a_u, mult = dedupe_klist(adj)
    adj_sm, _, rows = slot_major_arrays(*split_self_klist(a_u, mult))
    return adj_sm, rows[:, :, 0]


@pytest.mark.parametrize("c_in", [6, 32, 37, 64, 128])
@pytest.mark.parametrize("m", [4, 9, 16])
def test_kernel_matches_plain(cuda, rng, c_in, m):
    adj_sm, rows = _tables(rng, 700, 14)
    n = adj_sm.shape[1]
    args = [torch.as_tensor(a, device=cuda) for a in (
        rng.normal(size=(n, c_in + m)).astype(np.float32),
        rng.normal(size=(n, m)).astype(np.float32), adj_sm, rows,
        rng.normal(size=(m,)).astype(np.float32))]
    before = k1.facet_conv_fwd.launches
    z = k1.facet_conv_fwd(*args)
    assert k1.facet_conv_fwd.launches == before + 1
    torch.testing.assert_close(z, k1.facet_conv_fwd_plain(*args), atol=1e-5, rtol=1e-5)


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
    with pytest.raises(ValueError, match="exceed"):
        k1.facet_conv_fwd(torch.randn(n, 133, device=cuda), ux, adj, r, c)


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
