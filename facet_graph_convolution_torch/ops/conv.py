"""Facet graph convolution (FeaStNet-style soft-assignment conv).

Semantics of the reference ``custom_conv2d`` (model.py:427-504):

    y_i = bias + (1/|N(i)|) Σ_{j∈N(i)} Σ_m q_ijm · (W_m x_j)
    q_ij = softmax_M(u·x_i + v·x_j + c)        (default)
    q_ij = softmax_M(u·(x_i − x_j) + c)        (translation-invariant: v = −u)
    q_ij = softmax_M(u·R_i·x_j + c)            (rotation-invariant, model.py:186-377)

:func:`facet_conv` is the counterpart of
``facet_graph_convolution_tpu/ops/pallas_conv.py::facet_conv_pallas`` for the
default and translation-invariant variants, and of ``_facet_conv_nminor_rotinv``
(``ops/conv.py:472-521``) for the rotation-invariant one, over the port's
slot-major tables. The projections and the final ``z @ W_flat.T`` are matmuls
under autograd (the JAX package leaves them to XLA). The aggregation into
``z`` is, on every device, an autograd Function over the hand-written
kernels: K1 and K2 (:mod:`facet_graph_convolution_torch.ops.facet_conv_kernel`) for
the first two variants, K3 (:mod:`facet_graph_convolution_torch.ops.
aggregate`) for the rotation-invariant one, whose assignment K1 cannot form.

``compute_dtype=torch.bfloat16`` is the JAX package's ``compute_dtype=
bfloat16`` (its production training configuration): the parameters stay
float32 and only the conv's interiors are bfloat16. ``x @ proj.T`` and
``x @ u.T`` are computed in f32 and rounded; ``cat``, ``ux``, the gathered
rows and ``z`` are bfloat16 (K1/K2 or K3 in their bfloat16 forms, f32
inside); ``y = z @ W_flat.T`` takes ``W_flat`` rounded to bfloat16 and sums
in f32 into an f32 ``y`` (:class:`Bf16Matmul`, JAX's
``preferred_element_type=float32``). The rotation-invariant conv computes
its features and logits in f32 and rounds the slots; K3 takes the softmax
in f32 and rounds q before its sums.

The row-major functions over raw one-indexed K-lists ``adj`` [N, K] are plain
PyTorch, as in the JAX package: :func:`assignment_weights`,
:func:`facet_conv_rowmajor` (the JAX ``facet_conv`` without tables, which
its row-major ``unet_apply`` runs), the :func:`facet_conv_gather` oracle and
the position-for-assignment convs (model.py:610-760).
"""

from __future__ import annotations

import enum
from typing import Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch

from facet_graph_convolution_torch.ops.aggregate import WeightedAggregate
from facet_graph_convolution_torch.ops.facet_conv_kernel import facet_conv_epilogue
from facet_graph_convolution_torch.ops.gather import (
    gather_neighbors,
    gather_slots,
    neighbor_counts,
)
from facet_graph_convolution_torch.utils.profiling import mark_grad


class FacetConvVariant(str, enum.Enum):
    DEFAULT = "default"
    TRANSLATION_INVARIANT = "translation_invariant"
    ROTATION_INVARIANT = "rotation_invariant"


def per_conv_variants(variant: FacetConvVariant) -> Tuple[FacetConvVariant, FacetConvVariant]:
    """(first conv's variant, remaining convs' variant): rotation invariance
    reaches only the first conv (reference model.py:858; every other conv
    passes ``rotation_invariance=False``, model.py:870-930), translation
    invariance every conv."""
    variant = FacetConvVariant(variant)
    rest = (variant if variant == FacetConvVariant.TRANSLATION_INVARIANT
            else FacetConvVariant.DEFAULT)
    return variant, rest


def linear(params: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """Per-node dense layer, ``w`` [in, out] (reference ``custom_lin``,
    model.py:763-769)."""
    return x @ params["w"] + params["b"]


# ---------------------------------------------------------------------------
# Rotation-invariant assignment features
# ---------------------------------------------------------------------------

def _filled(like: torch.Tensor, values, shape) -> torch.Tensor:
    """A tensor of ``shape + (len(values),)`` holding ``values`` along its
    last axis, made on ``like``'s device without a copy from the host (a
    CUDA graph capture of the train step allows none)."""
    out = like.new_zeros(*shape, len(values))
    for i, value in enumerate(values):
        if value:
            out[..., i] = value
    return out


def rotation_to_axis(normals: torch.Tensor) -> torch.Tensor:
    """Per-face rotation [..., 3, 3] aligning each normal with +z by the
    Rodrigues formula (reference ``getRotationToAxis``, model.py:128-183,
    with the intended per-face ``sin²``, as the JAX package computes it).
    Where ``sin² ≤ 1e-12`` (a normal parallel or antiparallel to z, or zero)
    the quadratic term is dropped, R = I + S ≈ I: an antiparallel normal
    keeps R = I, as in the JAX package."""
    ref = _filled(normals, (0.0, 0.0, 1.0), normals.shape[:-1])
    cross = torch.linalg.cross(normals, ref, dim=-1)
    sin2 = torch.sum(cross * cross, dim=-1)
    cos = normals[..., 2]
    zeros = torch.zeros_like(cos)
    ssm = torch.stack([
        torch.stack([zeros, -cross[..., 2], cross[..., 1]], dim=-1),
        torch.stack([cross[..., 2], zeros, -cross[..., 0]], dim=-1),
        torch.stack([-cross[..., 1], cross[..., 0], zeros], dim=-1),
    ], dim=-2)
    eye = torch.eye(3, dtype=normals.dtype, device=normals.device)
    coef = torch.where(sin2 > 1e-12, (1.0 - cos) / torch.clamp_min(sin2, 1e-12),
                       torch.zeros_like(sin2))
    ssm2 = torch.sum(ssm[..., :, :, None] * ssm[..., None, :, :], dim=-2)   # ssm @ ssm
    return eye + ssm + ssm2 * coef[..., None, None]


def _rotate(rot: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``rot`` [N, 3, 3] applied to ``v`` [K, N, 3], as a broadcast multiply
    and a sum. The batched 3×3 products (this and ``ssm @ ssm``) are written
    out: on the card cuBLAS runs them as strided-batched GEMVs
    (``gemmSN_TN``), 0.229 ms a rotation-invariant step on an H100 at conv1
    of a 25,600-node patch, for work of one elementwise pass."""
    return torch.sum(rot * v[..., None, :], dim=-1)


_SELF_FEATS = {3: (0.0, 0.0, 1.0), 4: (0.0, 0.0, 1.0, 1.0), 6: (0.0, 0.0, 1.0, 0.0, 0.0, 0.0)}


def _rotation_invariant_feats(x: torch.Tensor, x_nbr: torch.Tensor,
                              self_slot: bool) -> torch.Tensor:
    """Rotation-invariant assignment features, slot-major: ``x`` [N, C] and
    its gathered neighbours ``x_nbr`` [K, N, C] → [K, N, C], or [K+1, N, C]
    with ``self_slot`` (the JAX package's ``_rotation_invariant_feats``,
    ``ops/conv.py:164-205``, with the slot axis first). Channel layouts
    follow the reference (model.py:452-460): 3 = normals; 4 = normals + area
    (the neighbour's area over the node's, 0 where the node's area is
    |a| ≤ 1e-12, e.g. a fake node); 6 = normals + position (relative,
    rotated). Neighbour normals and relative positions are rotated by the
    node's :func:`rotation_to_axis`.

    ``self_slot`` prepends the analytic self slot of a self-split graph:
    the node's own rotated normal is +z and its relative position 0, so its
    features are ``[0, 0, 1]`` (+ area ratio 1, or + position 0) and nothing
    is gathered or rotated for it."""
    in_ch = x.shape[-1]
    if in_ch not in _SELF_FEATS:
        raise ValueError(f"rotation-invariant assignment needs 3/4/6 channels, got {in_ch}")
    rot = rotation_to_axis(x[:, :3])                                  # [N, 3, 3]
    feats = [_rotate(rot, x_nbr[..., :3])]
    if in_ch == 4:
        center = x[None, :, 3:]
        ok = torch.abs(center) > 1e-12
        safe = torch.where(ok, center, torch.ones_like(center))
        feats.append(torch.where(ok, x_nbr[..., 3:] / safe, torch.zeros_like(x_nbr[..., 3:])))
    elif in_ch == 6:
        feats.append(_rotate(rot, x_nbr[..., 3:] - x[None, :, 3:]))
    feats = torch.cat(feats, dim=-1)
    if self_slot:
        self_row = _filled(x, _SELF_FEATS[in_ch], (1, x.shape[0]))
        feats = torch.cat([self_row, feats], dim=0)
    return feats


# ---------------------------------------------------------------------------
# The conv over the slot-major kernel tables
# ---------------------------------------------------------------------------

def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` of two bfloat16 matrices, summed and written in float32,
    with no rounding of the sum to bfloat16: on the card cuBLAS's bf16
    product with an f32 output (``torch.mm(..., out_dtype=torch.float32)``,
    the tensor cores), on the CPU the f32 product of the same values (each
    product of two bf16 values is exact in f32). One form a device, chosen
    by the device alone. Its output is f32, so PyTorch's
    ``allow_bf16_reduced_precision_reduction`` (left at its default) cannot
    round a partial sum to bf16 here."""
    if a.device.type == "cuda":
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


class Bf16Matmul(torch.autograd.Function):
    """``y = z @ w.T`` in f32 from bfloat16 ``z`` [N, K] and ``w`` [out, K]
    (JAX's ``einsum(z, w, preferred_element_type=float32)``). PyTorch has
    no derivative for the f32-output bf16 product (``aten::mm.dtype``), so
    the backward is written out, in the same form: the f32 cotangent is
    rounded to bfloat16 (the product's operands are bf16, as on the TPU's
    matrix unit), then ``dz = dy @ w`` rounded to z's dtype and ``dw = dy.T
    @ z`` in f32, which autograd rounds to w's dtype (the cotangent of the
    bf16 cast of the f32 parameter, as in JAX)."""

    @staticmethod
    def forward(ctx, z, w):
        ctx.save_for_backward(z, w)
        return _mm_f32(z, w.t())

    @staticmethod
    def backward(ctx, dy):
        z, w = ctx.saved_tensors
        g = dy.to(z.dtype)
        dz = _mm_f32(g, w).to(z.dtype) if ctx.needs_input_grad[0] else None
        dw = _mm_f32(g.t(), z).to(w.dtype) if ctx.needs_input_grad[1] else None
        return dz, dw


def _facet_conv_rotinv(params, x, adj_sm, adj_t_sm, rows, compute_dtype, src):
    """The rotation-invariant conv on the padded ``x`` [N', C] (JAX
    ``_facet_conv_nminor_rotinv``): the neighbours are gathered once from
    the source rows ``src`` (``x``, or ``x`` halo-extended), with zeros in
    pad slots, and serve both the features and K3. The features and the
    logits are in x's dtype; K3 takes the logits and the slots' multipliers
    and computes the softmax·mult and the slot sums in one launch, with the
    slots in ``compute_dtype`` (None: x's).

    The conv's own work lies between the device marks ``rotinv_begin`` and
    ``rotinv_end`` (the gather, the features, the logits and K3) and, in
    the backward, ``rotinv_bwd_begin`` (z's cotangent in) and
    ``rotinv_bwd_end`` (the assignment's ``u`` and ``c`` gradients in: K3's
    backward and the logits'); ``utils/profiling.py::mark_grad``. Where x
    takes a gradient too, its last part may follow ``rotinv_bwd_end``."""
    u, c = mark_grad([params["u"], params["c"]], "rotinv_begin", "rotinv_bwd_end")
    x_slots = torch.cat([x[None], gather_slots(src, adj_sm, adj_t_sm)], dim=0)  # [S, N', C]
    feats = _rotation_invariant_feats(x, x_slots[1:], self_slot=True)          # [S, N', C]
    logits = feats @ u.T + c                                                   # [S, N', M]
    if compute_dtype is not None:
        x_slots = x_slots.to(compute_dtype)
    z = WeightedAggregate.apply(logits.contiguous(), rows.contiguous(), x_slots)
    (z,) = mark_grad([z], "rotinv_end", "rotinv_bwd_begin")
    return z


def facet_conv(
    params: Dict[str, torch.Tensor],
    x: torch.Tensor,
    adj_sm: torch.Tensor,
    mult_rows: torch.Tensor,
    variant: FacetConvVariant = FacetConvVariant.DEFAULT,
    adj_t_sm: Optional[torch.Tensor] = None,
    compute_dtype: Optional[torch.dtype] = None,
    extend: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
) -> torch.Tensor:
    """Facet conv ``x`` [N, C] → [N, out] over the kernel tables of
    :func:`facet_graph_convolution_torch.graph.convert.slot_major_arrays`:
    ``adj_sm`` [K', N'] int32 and ``mult_rows`` [K'+1, N', 1] f32, with the
    node axis padded to N' ≥ N, and ``adj_t_sm`` [N', K_t] int32, the
    transpose map that the backward needs (None when no gradient is taken).
    ``params`` holds ``w`` [M, out, C], ``b`` [out], ``u`` [M, C], ``c`` [M]
    and, for the default variant, ``v`` [M, C]. The rotation-invariant
    variant takes 3, 4 or 6 input channels. ``compute_dtype`` (float32 or
    bfloat16; None keeps x's dtype, float64 in the plain checks) is the
    dtype of the conv's interiors (module docstring); under bfloat16 the
    output is f32.

    ``extend`` (a shard of a partitioned graph, :mod:`..parallel.halo`)
    maps the N owned source rows to N_src ≥ N: it is applied to ``cat``
    (in ``compute_dtype``) or, under the rotation-invariant variant, to
    ``x``, before the gather, and the tables index into the N_src rows
    (``adj_t_sm`` has N_src rows; ``mult_rows`` N columns, no padding)."""
    if compute_dtype not in (None, torch.float32, torch.bfloat16):
        raise ValueError(f"facet_conv: compute_dtype {compute_dtype}, needs torch.float32 or "
                         "torch.bfloat16")
    variant = FacetConvVariant(variant)
    u, c, w, b = params["u"], params["c"], params["w"], params["b"]
    n, in_ch = x.shape
    m, out_ch, _ = w.shape

    # padded destinations have all-zero mult rows → zero z rows
    pad = mult_rows.shape[1] - n
    if pad and extend is not None:
        raise ValueError(f"facet_conv: mult_rows has {mult_rows.shape[1]} columns for {n} "
                         "rows; a halo-extended conv takes unpadded tables")
    if pad:
        x = torch.nn.functional.pad(x, (0, 0, 0, pad))
    rows = mult_rows[:, :, 0]
    if variant == FacetConvVariant.ROTATION_INVARIANT:
        z = _facet_conv_rotinv(params, x, adj_sm, adj_t_sm, rows, compute_dtype,
                               x if extend is None else extend(x))
    else:
        proj = -u if variant == FacetConvVariant.TRANSLATION_INVARIANT else params["v"]
        cat, ux = torch.cat([x, x @ proj.T], dim=-1), x @ u.T
        if compute_dtype is not None:
            cat, ux = cat.to(compute_dtype), ux.to(compute_dtype)
        if extend is not None:
            cat = extend(cat)
        z = facet_conv_epilogue(cat.contiguous(), ux.contiguous(), c, adj_sm, adj_t_sm, rows)
    # z columns are m-major (m·C + ch)
    w_flat = w.permute(1, 0, 2).reshape(out_ch, m * in_ch)
    if compute_dtype == torch.bfloat16:
        y = Bf16Matmul.apply(z, w_flat.to(compute_dtype))
    else:
        y = z @ w_flat.T
    gate = (rows.sum(dim=0) > 0).to(y.dtype)
    y = y + b[None, :] * gate[:, None]
    return y[:n] if pad else y


# ---------------------------------------------------------------------------
# Row-major convs over raw one-indexed K-lists (plain PyTorch)
# ---------------------------------------------------------------------------

def assignment_weights(params, x, adj, variant=FacetConvVariant.DEFAULT) -> torch.Tensor:
    """Per-edge soft assignment q [N, K, M]: softmax over M of the variant's
    logits; pad slots get logits as if x_j = 0 (the zero-row gather,
    model.py:383-385). The rotation-invariant variant gathers the self slot
    like any other (``self_slot=False``)."""
    variant = FacetConvVariant(variant)
    u, c = params["u"], params["c"]
    if variant == FacetConvVariant.ROTATION_INVARIANT:
        x_nbr = gather_neighbors(x, adj).transpose(0, 1)                # [K, N, C]
        feats = _rotation_invariant_feats(x, x_nbr, self_slot=False).transpose(0, 1)
        logits = feats @ u.T + c
    else:
        ux = x @ u.T
        proj = params["v"] if variant == FacetConvVariant.DEFAULT else -u
        logits = ux[:, None, :] + gather_neighbors(x @ proj.T, adj) + c
    return torch.softmax(logits, dim=-1)


def _add_bias(y, b, deg, bias_mask: bool) -> torch.Tensor:
    """``y + b``, only where deg > 0 when ``bias_mask`` (reference biasMask,
    model.py:496-500)."""
    return torch.where((deg > 0)[:, None], y + b, y) if bias_mask else y + b


def _inv_degree(deg, dtype) -> torch.Tensor:
    return torch.where(deg > 0, 1.0 / torch.clamp_min(deg, 1).to(dtype),
                       torch.zeros((), dtype=dtype, device=deg.device))


def _finish_conv(q, x, adj, w, b, bias_mask: bool) -> torch.Tensor:
    """Aggregate, then transform (JAX ``_finish_conv``, ``ops/conv.py:218-
    247``): ``y = W·(Σ_k q·x_k)/deg + b``, the bias masked per
    ``bias_mask``."""
    deg = neighbor_counts(adj)
    z = torch.einsum("nkm,nkc->nmc", q, gather_neighbors(x, adj))
    y = torch.einsum("nmc,moc->no", z * _inv_degree(deg, x.dtype)[:, None, None], w)
    return _add_bias(y, b, deg, bias_mask)


def facet_conv_rowmajor(params, x, adj, variant=FacetConvVariant.DEFAULT,
                        bias_mask: bool = True) -> torch.Tensor:
    """The conv over a raw one-indexed K-list ``adj`` [N, K] (slot 0 = self,
    0 = pad): the JAX package's ``facet_conv`` without transpose map or
    multiplicities, which its row-major ``unet_apply`` runs."""
    q = assignment_weights(params, x, adj, variant)
    return _finish_conv(q, x, adj, params["w"], params["b"], bias_mask)


def facet_conv_gather(params, x, adj, variant=FacetConvVariant.DEFAULT,
                      bias_mask: bool = True) -> torch.Tensor:
    """The reference-shaped oracle (JAX ``facet_conv_gather``, ``ops/conv.py:
    524-546``; model.py:466-493): gathers the transformed neighbours
    [N, K, M·out] instead of aggregating in input space."""
    w, b = params["w"], params["b"]
    m, out_ch, in_ch = w.shape
    q = assignment_weights(params, x, adj, variant)
    wx = x @ w.reshape(m * out_ch, in_ch).T
    wx_nbr = gather_neighbors(wx, adj).reshape(x.shape[0], adj.shape[1], m, out_ch)
    deg = neighbor_counts(adj)
    y = torch.einsum("nkm,nkmo->no", q, wx_nbr) * _inv_degree(deg, x.dtype)[:, None]
    return _add_bias(y, b, deg, bias_mask)


# ---------------------------------------------------------------------------
# Position-for-assignment convs (reference model.py:610-760): the last 3
# channels (position) take part in the assignment only; W sees the others.
# ---------------------------------------------------------------------------

def _normal(rng, shape, std, device):
    return torch.as_tensor(rng.normal(size=shape).astype(np.float32) * np.float32(std),
                           device=device)


def init_facet_conv(
    in_channels: int, out_channels: int, num_filters: int,
    variant: FacetConvVariant = FacetConvVariant.DEFAULT,
    std_dev: float = 0.05, std_dev_bias: float = 0.01,
    seed: Union[int, np.random.Generator] = 0, device: str = "cuda",
) -> Dict[str, torch.Tensor]:
    """Parameters of :func:`facet_conv` (the JAX package's keys and layouts,
    ``ops/conv.py:53-71``): ``w`` [M, out, in], ``b`` [out], ``u`` [M, in],
    ``c`` [M], and ``v`` [M, in] under the default variant only. Drawn in
    that order from ``seed``, a numpy seed or a generator that the caller
    goes on drawing from (:func:`..models.unet.init_unet`); the numbers
    differ from the JAX package's."""
    rng = np.random.default_rng(seed)
    params = {
        "w": _normal(rng, (num_filters, out_channels, in_channels), std_dev, device),
        "b": _normal(rng, (out_channels,), std_dev_bias, device),
        "u": _normal(rng, (num_filters, in_channels), std_dev, device),
        "c": _normal(rng, (num_filters,), std_dev, device),
    }
    if variant == FacetConvVariant.DEFAULT:
        params["v"] = _normal(rng, (num_filters, in_channels), std_dev, device)
    return params


def init_linear(
    in_channels: int, out_channels: int, std_dev: float = 0.05, std_dev_bias: float = 0.01,
    seed: Union[int, np.random.Generator] = 0, device: str = "cuda",
) -> Dict[str, torch.Tensor]:
    """Parameters of :func:`linear` (``ops/conv.py:74-85`` there): ``w``
    [in, out] and ``b`` [out], drawn in that order from ``seed`` as
    :func:`init_facet_conv` draws."""
    rng = np.random.default_rng(seed)
    return {"w": _normal(rng, (in_channels, out_channels), std_dev, device),
            "b": _normal(rng, (out_channels,), std_dev_bias, device)}


def init_facet_conv_pos_assignment(
    in_channels: int, out_channels: int, num_filters: int,
    translation_invariance: bool = False, seed: int = 0, std_dev: float = 0.05,
    std_dev_bias: float = 0.01, device: str = "cuda",
) -> Dict[str, torch.Tensor]:
    """Parameters of :func:`facet_conv_pos_assignment` from a numpy seed
    (the JAX package's keys and layouts, ``ops/conv.py:556-575``):
    ``in_channels`` counts the 3 trailing position channels."""
    rng = np.random.default_rng(seed)
    in_w = in_channels - 3
    params = {
        "w": _normal(rng, (num_filters, out_channels, in_w), std_dev, device),
        "b": _normal(rng, (out_channels,), std_dev_bias, device),
        "u": _normal(rng, (num_filters, in_channels), std_dev, device),
        "c": _normal(rng, (num_filters,), std_dev, device),
    }
    if not translation_invariance:
        params["v_n"] = _normal(rng, (num_filters, in_w), std_dev, device)
    return params


def facet_conv_pos_assignment(params, x, adj, bias_mask: bool = True) -> torch.Tensor:
    """Reference ``custom_conv2d_pos_for_assignment`` (model.py:610-696):
    the position block of the assignment is translation-invariant
    (v_pos = −u_pos), the rest uses ``v_n`` (or −u_n without it)."""
    u, c = params["u"], params["c"]
    in_w = u.shape[1] - 3
    v_n = params["v_n"] if "v_n" in params else -u[:, :in_w]
    v = torch.cat([v_n, -u[:, in_w:]], dim=-1)
    q = torch.softmax((x @ u.T)[:, None, :] + gather_neighbors(x @ v.T, adj) + c, dim=-1)
    return _finish_conv(q, x[:, :in_w], adj, params["w"], params["b"], bias_mask)


def init_facet_conv_only_pos_assignment(
    in_channels: int, out_channels: int, num_filters: int,
    translation_invariance: bool = False, seed: int = 0, std_dev: float = 0.05,
    std_dev_bias: float = 0.01, device: str = "cuda",
) -> Dict[str, torch.Tensor]:
    """Parameters of :func:`facet_conv_only_pos_assignment` from a numpy
    seed (the JAX package's keys and layouts, ``ops/conv.py:600-619``)."""
    rng = np.random.default_rng(seed)
    params = {
        "w": _normal(rng, (num_filters, out_channels, in_channels - 3), std_dev, device),
        "b": _normal(rng, (out_channels,), std_dev_bias, device),
        "u": _normal(rng, (num_filters, 3), std_dev, device),
        "c": _normal(rng, (num_filters,), std_dev, device),
    }
    if not translation_invariance:
        params["v"] = _normal(rng, (num_filters, 3), std_dev, device)
    return params


def facet_conv_only_pos_assignment(params, x, adj) -> torch.Tensor:
    """Reference ``custom_conv2d_only_pos_for_assignment`` (model.py:699-
    760): the assignment from the position block only, W on the other
    channels, the bias unmasked."""
    u, c = params["u"], params["c"]
    in_w = x.shape[-1] - 3
    xp = x[:, in_w:]
    up_x = xp @ u.T
    nbr = gather_neighbors(xp @ params["v"].T if "v" in params else -up_x, adj)
    q = torch.softmax(up_x[:, None, :] + nbr + c, dim=-1)
    return _finish_conv(q, x[:, :in_w], adj, params["w"], params["b"], bias_mask=False)
