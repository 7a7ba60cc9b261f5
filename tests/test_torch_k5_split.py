"""A CPU model of K5's split-precision tensor-core products
(``facet_graph_convolution_torch/csrc/windowed_conv.cuh``): the numbers the
card computes, emulated in torch, against a float64 product of the same
operands.

The kernels multiply on the tensor cores with ``mma.sync``: in float32 each
operand is split ``a = hi + lo`` with ``hi = tf32(a)``, ``lo = tf32(a - hi)``
(``cvt.rna.tf32.f32``: 10 mantissa bits, round to nearest, ties away from
zero) and a k-step of 8 sums ``lo·hi``, ``hi·lo``, ``hi·hi`` into a fresh
fragment that joins the f32 accumulator (3xTF32); in bfloat16 the
backward's ``gy`` stays float32 and is split, while its partner (``wf`` or
``z``) is a bfloat16 value, exact in TF32, so two products a step suffice
(2xTF32). The model takes the products exactly and rounds to f32 as each
term joins the step's fragment and as the fragment joins the accumulator,
in the kernel's order of k: the forward ``y = z · wfᵀ`` over chunks of 8
channels (``kk = m·cw + cc``, padded to a multiple of 8), the backward's
``dz = gy · wf`` over out, and ``dW = gyᵀ · z`` over rows.

At the torus's windowed convs' depths (M·C = 54, 576, 1152) and widths (out
32, 64), on seeded numpy inputs:

- 3xTF32 stays within ``chip_smoke.py``'s f32 bound, 1e-5 × max|product|,
  for all three products; plain TF32 (one product a step) does not;
- 2xTF32 with an exact bfloat16 operand stays within the bfloat16 bound
  (2^-8 × max) and within the f32 one;
- rounding ``gy`` to bfloat16 instead (a bf16 ``mma``) moves ``dz`` by
  ~2e-3 × max, past the f32 bound the plain version's arithmetic meets,
  and the bfloat16 slot rows that the kernel writes from it (``dx``) then
  round differently from the plain version's in ~40% of their values
  (against < 0.1% under 2xTF32). On these inputs its largest error stays
  near 2^-8 × max, on either side of it, so the test asserts the share.
"""

import numpy as np
import pytest
import torch

F32_TOL = 1e-5          # chip_smoke.py's K5_TOL, × max|plain|
BF16_TOL = 2.0 ** -8    # chip_smoke.py's BF16_KERNEL_TOL, × max|plain|
M = 9
DEPTHS = (54, 576, 1152)     # M·C of conv1, upconv1/dconv1 (level 0), upconv2/dconv2 (level 1)
WIDTHS = (32, 64)
ROWS = 512
CW = 8                       # the forward's channels a chunk at these shapes


def tf32(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32``: the low 13 mantissa bits dropped, rounded to
    nearest with ties away from zero (a carry may reach the exponent)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split(x: torch.Tensor):
    hi = tf32(x)
    return hi, tf32(x - hi)


def bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def mma_sum(terms, k_step=8) -> torch.Tensor:
    """``sum_k a[:, k] b[k, :]`` as the kernels' mma steps: for each k-step
    the terms ``(a part, b part)`` summed into a fresh f32 fragment (the
    products exact, a rounding as each term joins it), which is then added
    to the f32 accumulator (``mma_split``)."""
    a0, b0 = terms[0]
    acc = torch.zeros((a0.shape[0], b0.shape[1]), dtype=torch.float32)
    for k0 in range(0, a0.shape[1], k_step):
        step = torch.zeros_like(acc)
        for a, b in terms:
            step = (step.double() + a[:, k0:k0 + k_step].double() @ b[k0:k0 + k_step].double()
                    ).float()
        acc = acc + step
    return acc


def three_tf32(a, b):
    (ah, al), (bh, bl) = split(a), split(b)
    return mma_sum([(al, bh), (ah, bl), (ah, bh)])


def two_tf32(a, b_exact):
    ah, al = split(a)
    return mma_sum([(al, b_exact), (ah, b_exact)])


def chunk_order(depth):
    """The forward's k order: chunks of CW channels, ``kk = m·cw + cc``
    within a chunk, padded to a multiple of 8 (-1: a zero column)."""
    c = depth // M
    order = []
    for c0 in range(0, c, CW):
        cw = min(CW, c)
        chunk = [m * c + c0 + cc if c0 + cc < c else -1 for m in range(M) for cc in range(cw)]
        order += chunk + [-1] * (-len(chunk) % 8)
    return torch.tensor(order)


def take_k(a, b, order):
    """a [rows, K], b [K, n] with k reordered (zeros where order is -1)."""
    pad_a = torch.cat([a, a.new_zeros(a.shape[0], 1)], dim=1)
    pad_b = torch.cat([b, b.new_zeros(1, b.shape[1])], dim=0)
    idx = torch.where(order < 0, a.shape[1], order)
    return pad_a[:, idx], pad_b[idx]


def operands(product, depth, out, seed=0):
    """(a, b) of one of the kernels' products in k-major form (a [rows, K],
    b [K, n]) and the k order the kernel takes, from seeded normals: the
    forward ``z · wfᵀ`` (wf scaled by (M·C)^-1/2), the backward's ``gy · wf``
    and ``gyᵀ · z``."""
    rng = np.random.default_rng(seed + depth + out)

    def t(*shape, scale=1.0):
        return torch.tensor((rng.normal(size=shape) * scale).astype(np.float32))

    if product == "fwd":
        z, wf = t(ROWS, depth), t(out, depth, scale=depth ** -0.5)
        return take_k(z, wf.t().contiguous(), chunk_order(depth))
    if product == "dz":
        return t(ROWS, out), t(out, depth, scale=depth ** -0.5)
    gy, z = t(ROWS, out), t(ROWS, depth)
    return gy.t().contiguous(), z


def rel_err(got, ref):
    return float((got.double() - ref).abs().max() / ref.abs().max())


def test_tf32_rounding_is_round_to_nearest_ties_away():
    one = 1.0
    half_ulp = 2.0 ** -11        # half of TF32's ulp at 1
    x = torch.tensor([one + half_ulp, -(one + half_ulp), one + half_ulp - 2.0 ** -23,
                      one + 3 * half_ulp, 2.0 - half_ulp], dtype=torch.float32)
    want = torch.tensor([one + 2 * half_ulp, -(one + 2 * half_ulp), one, one + 4 * half_ulp, 2.0])
    assert torch.equal(tf32(x), want)
    v = torch.tensor(np.random.default_rng(1).normal(size=4096).astype(np.float32))
    hi, lo = split(v)
    assert torch.equal(tf32(hi), hi) and torch.equal(tf32(lo), lo)
    assert float(((hi.double() + lo.double() - v.double()).abs() / v.double().abs()).max()) \
        <= 2.0 ** -21


@pytest.mark.parametrize("out", WIDTHS)
@pytest.mark.parametrize("depth", DEPTHS)
@pytest.mark.parametrize("product", ["fwd", "dz", "dw"])
def test_3xtf32_within_f32_bound(product, depth, out):
    a, b = operands(product, depth, out)
    ref = a.double() @ b.double()
    assert rel_err(three_tf32(a, b), ref) <= F32_TOL


@pytest.mark.parametrize("depth", DEPTHS)
@pytest.mark.parametrize("product", ["fwd", "dz", "dw"])
def test_plain_tf32_misses_f32_bound(product, depth):
    a, b = operands(product, depth, 32)
    ref = a.double() @ b.double()
    assert rel_err(mma_sum([(tf32(a), tf32(b))]), ref) > 10 * F32_TOL


@pytest.mark.parametrize("out", WIDTHS)
@pytest.mark.parametrize("depth", DEPTHS)
@pytest.mark.parametrize("product", ["dz", "dw"])
def test_2xtf32_with_exact_bf16_operand(product, depth, out):
    """bf16 backward: ``gy`` f32 split, ``wf`` (dz) or ``z`` (dW) bfloat16."""
    a, b = operands(product, depth, out)
    b = bf16(b)
    ref = a.double() @ b.double()
    err = rel_err(two_tf32(a, b), ref)
    assert err <= BF16_TOL and err <= F32_TOL


@pytest.mark.parametrize("out", WIDTHS)
@pytest.mark.parametrize("depth", DEPTHS)
def test_rounding_gy_to_bf16_departs_from_plain(depth, out):
    """dz = gy · wf_bf16 and one slot's bf16 row dx = T(sum_m dz[m] q[m]) on
    8,192 rows: the plain version (an f32 product of the f32 gy), 2xTF32,
    and a bf16 mma of a rounded gy."""
    rows, c = 8192, depth // M
    rng = np.random.default_rng(depth * out)
    gy = torch.tensor(rng.normal(size=(rows, out)).astype(np.float32))
    wf = bf16(torch.tensor((rng.normal(size=(out, depth)) * depth ** -0.5).astype(np.float32)))
    q = bf16(torch.softmax(torch.tensor(rng.normal(size=(rows, M)).astype(np.float32)), -1))
    ref = gy.double() @ wf.double()
    plain = gy @ wf

    def dx(dz):
        return bf16((dz.view(rows, M, c) * q[:, :, None]).sum(1, dtype=torch.float32))

    split_dz, rounded_dz = two_tf32(gy, wf), mma_sum([(bf16(gy), wf)])
    assert rel_err(split_dz, ref) <= F32_TOL
    assert rel_err(rounded_dz, ref) > 100 * F32_TOL
    want = dx(plain)
    flipped_split = float((dx(split_dz) != want).float().mean())
    flipped_rounded = float((dx(rounded_dz) != want).float().mean())
    assert flipped_split < 1e-3 < 0.2 < flipped_rounded
    assert rel_err(dx(split_dz), want.double()) <= BF16_TOL
