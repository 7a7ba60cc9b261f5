"""K3 with the softmax·mult fused in, and its backward, against the JAX
package on the CPU.

On CPU tensors the wrappers ``weighted_aggregate`` and
``weighted_aggregate_bwd`` run their plain versions, so these tests hold
those versions (the math the CUDA kernels compute, ``csrc/
weighted_aggregate.cu``) against the JAX rotation-invariant conv's
composition: ``jax.nn.softmax`` of the f32 logits times the slots'
multipliers, cast to the compute dtype, then ``_aggregate_nminor``
(``facet_graph_convolution_tpu/ops/conv.py:361-382, 509-515``), and
against ``jax.vjp`` of it. Inputs are drawn from a numpy seed.

Tolerances: float32 atol 1e-5 (the same sums in another order); bfloat16 at
the bounds of ``tests/test_variant_matrix.py``, 0.03 of the reference's
largest magnitude for values and 0.05 for gradients (JAX rounds every slot
product to bfloat16, the port rounds z once); the plain backward against
autograd through the plain forward in float64 atol 1e-12; the rotation
products written out against ``torch.einsum`` / ``@`` atol 1e-6 (float32,
three-term sums in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facet_graph_convolution_tpu.ops import conv as jconv
from facet_graph_convolution_torch.ops import aggregate as k3
from facet_graph_convolution_torch.ops import conv, cuda_library

BF16 = torch.bfloat16
VALUE_TOL, GRAD_TOL = 0.03, 0.05   # tests/test_variant_matrix.py:197-231
SHAPES = [(13, 300, 9, 6), (13, 200, 4, 6), (23, 64, 9, 64), (5, 40, 16, 37), (1, 30, 1, 3)]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small tensors: one intra-op thread, so that parallel test workers do
    not oversubscribe the CPU."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs(rng, s, n, m, c):
    """Logits [S, N, M], multipliers [S, N] with zeros where the tables pad,
    slots [S, N, C] and a cotangent dz [N, M·C], float32."""
    logits = (2.0 * rng.normal(size=(s, n, m))).astype(np.float32)
    rows = rng.uniform(0.0, 1.0, size=(s, n)).astype(np.float32)
    rows[rng.uniform(size=(s, n)) < 0.2] = 0.0
    x = rng.normal(size=(s, n, c)).astype(np.float32)
    dz = rng.normal(size=(n, m * c)).astype(np.float32)
    return logits, rows, x, dz


def _jax_k3(rows, dtype):
    """JAX's conv composition as a function of (logits, x_slots) → z [N, M·C]
    in ``dtype``, slot-major operands as the port's."""
    def k3_of(logits, x):
        _, n, m = logits.shape
        c = x.shape[2]
        q = jax.nn.softmax(logits.astype(jnp.float32), axis=-1)
        q_t = (jnp.transpose(q, (2, 0, 1)) * rows[None]).astype(dtype)     # [M, S, N]
        z_t = jconv._aggregate_nminor(q_t, jnp.transpose(x, (2, 0, 1)).astype(dtype))
        return jnp.transpose(z_t.astype(dtype), (2, 0, 1)).reshape(n, m * c)
    return k3_of


def _scaled_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1e-3)


@pytest.mark.parametrize("s,n,m,c", SHAPES)
def test_plain_forward_and_backward_match_jax(rng, s, n, m, c):
    """float32: z against JAX's softmax·rows then ``_aggregate_nminor``;
    dlogits and dx against ``jax.vjp`` of that composition; without dx the
    backward gives the same dlogits and no dx."""
    logits, rows, x, dz = _inputs(rng, s, n, m, c)
    z_j, vjp = jax.vjp(_jax_k3(jnp.asarray(rows), jnp.float32), jnp.asarray(logits),
                       jnp.asarray(x))
    dlogits_j, dx_j = vjp(jnp.asarray(dz))
    args = [torch.as_tensor(a) for a in (logits, rows, x)]
    z = k3.weighted_aggregate_plain(*args)
    assert z.shape == (n, m * c) and z.dtype == torch.float32
    np.testing.assert_allclose(z.numpy(), np.asarray(z_j), atol=1e-5)
    dlogits, dx = k3.weighted_aggregate_bwd_plain(*args, torch.as_tensor(dz))
    assert dlogits.dtype == dx.dtype == torch.float32
    np.testing.assert_allclose(dlogits.numpy(), np.asarray(dlogits_j), atol=1e-5)
    np.testing.assert_allclose(dx.numpy(), np.asarray(dx_j), atol=1e-5)
    only, none = k3.weighted_aggregate_bwd_plain(*args, torch.as_tensor(dz), need_dx=False)
    assert none is None and torch.equal(only, dlogits)


@pytest.mark.parametrize("s,n,m,c", SHAPES[:4])
def test_plain_bf16_matches_jax_bf16_composition(rng, s, n, m, c):
    """bfloat16 slots (the JAX package's production compute dtype): z in
    bfloat16 against JAX's bfloat16 composition within VALUE_TOL; dlogits
    (f32) and dx (bfloat16) against its VJP within GRAD_TOL."""
    logits, rows, x, dz = _inputs(rng, s, n, m, c)
    x = np.asarray(torch.as_tensor(x).to(BF16).float())
    dz = np.asarray(torch.as_tensor(dz).to(BF16).float())
    z_j, vjp = jax.vjp(_jax_k3(jnp.asarray(rows), jnp.bfloat16), jnp.asarray(logits),
                       jnp.asarray(x, jnp.bfloat16))
    dlogits_j, dx_j = vjp(jnp.asarray(dz, jnp.bfloat16))
    args = (torch.as_tensor(logits), torch.as_tensor(rows), torch.as_tensor(x).to(BF16))
    z = k3.weighted_aggregate_plain(*args)
    assert z.dtype == BF16
    assert _scaled_err(z.float(), np.asarray(z_j, np.float32)) <= VALUE_TOL
    dlogits, dx = k3.weighted_aggregate_bwd_plain(*args, torch.as_tensor(dz).to(BF16))
    assert dlogits.dtype == torch.float32 and dx.dtype == BF16
    assert _scaled_err(dlogits, np.asarray(dlogits_j, np.float32)) <= GRAD_TOL
    assert _scaled_err(dx.float(), np.asarray(dx_j, np.float32)) <= GRAD_TOL


@pytest.mark.parametrize("need_dx", [False, True])
def test_plain_backward_is_autograd_of_the_plain_forward(rng, need_dx):
    """In float64 the written-out backward (dq kept apart, the softmax's
    backward by its formula) equals autograd through the plain forward;
    ``WeightedAggregate`` on the CPU gives the same, rows no gradient."""
    logits, rows, x, dz = (torch.as_tensor(a).double() for a in _inputs(rng, 13, 120, 9, 6))
    lt, xt = logits.clone().requires_grad_(), x.clone().requires_grad_(need_dx)
    z = k3.weighted_aggregate_plain(lt, rows, xt)
    want = torch.autograd.grad(z, [lt, xt] if need_dx else [lt], dz)
    dlogits, dx = k3.weighted_aggregate_bwd_plain(logits, rows, x, dz, need_dx)
    torch.testing.assert_close(dlogits, want[0], atol=1e-12, rtol=0)
    if need_dx:
        torch.testing.assert_close(dx, want[1], atol=1e-12, rtol=0)
    else:
        assert dx is None
    rt = rows.clone().requires_grad_()
    lt2, xt2 = logits.clone().requires_grad_(), x.clone().requires_grad_(need_dx)
    z2 = k3.WeightedAggregate.apply(lt2, rt, xt2)
    assert torch.equal(z2, z.detach())
    z2.backward(dz)
    assert rt.grad is None and torch.equal(lt2.grad, dlogits)
    assert (xt2.grad is None) if not need_dx else torch.equal(xt2.grad, dx)


def test_wrappers_do_not_load_the_cuda_library_on_the_cpu(rng, monkeypatch):
    """CPU tensors take the plain versions without building or loading the
    CUDA library, forward, backward and through the Function; no launch is
    counted."""
    def refuse(name):
        raise AssertionError(f"the CUDA library {name} was loaded for CPU tensors")

    monkeypatch.setattr(cuda_library, "load", refuse)
    monkeypatch.setattr(cuda_library, "build", lambda *a, **k: refuse("build"))
    logits, rows, x, dz = (torch.as_tensor(a) for a in _inputs(rng, 13, 50, 9, 6))
    before = (k3.weighted_aggregate.launches, k3.weighted_aggregate_bwd.launches)
    z = k3.weighted_aggregate(logits, rows, x)
    assert torch.equal(z, k3.weighted_aggregate_plain(logits, rows, x))
    for need_dx in (False, True):
        got = k3.weighted_aggregate_bwd(logits, rows, x, dz, need_dx)
        want = k3.weighted_aggregate_bwd_plain(logits, rows, x, dz, need_dx)
        assert all(a is b is None or torch.equal(a, b) for a, b in zip(got, want))
    lt = logits.clone().requires_grad_()
    k3.WeightedAggregate.apply(lt, rows, x).backward(dz)
    assert torch.equal(lt.grad, k3.weighted_aggregate_bwd_plain(logits, rows, x, dz)[0])
    assert (k3.weighted_aggregate.launches, k3.weighted_aggregate_bwd.launches) == before


def test_wrappers_refuse_what_does_not_go_together():
    """On every device: rows or dz of another shape, dz of another dtype
    than the slots, logits of another dtype than the slots' float32 (or
    float64) compute."""
    logits, rows, x = torch.zeros(3, 8, 4), torch.ones(3, 8), torch.zeros(3, 8, 6)
    with pytest.raises(ValueError, match="differ"):
        k3.weighted_aggregate_bwd(logits, torch.ones(2, 8), x, torch.zeros(8, 24))
    with pytest.raises(ValueError, match="dz"):
        k3.weighted_aggregate_bwd(logits, rows, x, torch.zeros(8, 23))
    with pytest.raises(TypeError, match="dz"):
        k3.weighted_aggregate_bwd(logits, rows, x, torch.zeros(8, 24, dtype=torch.float64))
    with pytest.raises(TypeError, match="logits must be torch.float32"):
        k3.weighted_aggregate(logits.double(), rows, x)
    with pytest.raises(TypeError, match="logits must be torch.float64"):
        k3.weighted_aggregate(logits, rows, x.double())


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-6), (torch.float64, 1e-14)])
def test_rotation_products_written_out_match_the_batched_products(rng, dtype, atol):
    """The rotation features' 3×3 products, written as broadcast
    multiply-and-sum (no cuBLAS batched GEMV on the card), against
    ``torch.einsum`` and ``@``."""
    normals = torch.as_tensor(rng.normal(size=(200, 3))).to(dtype)
    normals = normals / normals.norm(dim=1, keepdim=True)
    normals[0] = torch.tensor([0.0, 0.0, -1.0])
    v = torch.as_tensor(rng.normal(size=(7, 200, 3))).to(dtype)
    rot = conv.rotation_to_axis(normals)
    torch.testing.assert_close(conv._rotate(rot, v), torch.einsum("nij,knj->kni", rot, v),
                               atol=atol, rtol=0)
    torch.testing.assert_close(rot @ normals[:, :, None], torch.tensor(
        [0.0, 0.0, 1.0], dtype=dtype).expand(200, 3)[:, :, None].where(
        normals[:, 2:3, None] > -1, normals[:, :, None]), atol=10 * atol, rtol=0)
