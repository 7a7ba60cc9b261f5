"""Facet graph convolution (FeaStNet-style soft-assignment conv), forward.

Semantics of the reference ``custom_conv2d`` (model.py:427-504):

    y_i = bias + (1/|N(i)|) Σ_{j∈N(i)} Σ_m q_ijm · (W_m x_j)
    q_ij = softmax_M(u·x_i + v·x_j + c)        (default)
    q_ij = softmax_M(u·(x_i − x_j) + c)        (translation-invariant: v = −u)

:func:`facet_conv` is the counterpart of
``facet_graph_convolution_tpu/ops/pallas_conv.py::facet_conv_pallas``: the
projections and the final ``z @ W_flat.T`` are matmuls under autograd (the
JAX package leaves them to XLA), the aggregation into ``z`` is the autograd
Function over K1 and K2 (:mod:`facet_graph_convolution_torch.ops.facet_conv`),
on every device.
"""

from __future__ import annotations

import enum
from typing import Dict, Optional

import torch

from facet_graph_convolution_torch.ops.facet_conv import FacetConvEpilogue


class FacetConvVariant(str, enum.Enum):
    DEFAULT = "default"
    TRANSLATION_INVARIANT = "translation_invariant"
    ROTATION_INVARIANT = "rotation_invariant"


def linear(params: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """Per-node dense layer, ``w`` [in, out] (reference ``custom_lin``,
    model.py:763-769)."""
    return x @ params["w"] + params["b"]


def facet_conv(
    params: Dict[str, torch.Tensor],
    x: torch.Tensor,
    adj_sm: torch.Tensor,
    mult_rows: torch.Tensor,
    variant: FacetConvVariant = FacetConvVariant.DEFAULT,
    adj_t_sm: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Facet conv ``x`` [N, C] → [N, out] over the kernel tables of
    :func:`facet_graph_convolution_torch.graph.convert.slot_major_arrays`:
    ``adj_sm`` [K', N'] int32 and ``mult_rows`` [K'+1, N', 1] f32, with the
    node axis padded to N' ≥ N, and ``adj_t_sm`` [N', K_t] int32, the
    transpose map that the backward needs (None when no gradient is taken).
    ``params`` holds ``w`` [M, out, C], ``b`` [out], ``u`` [M, C], ``c`` [M]
    and, for the default variant, ``v`` [M, C]."""
    if variant not in (FacetConvVariant.DEFAULT, FacetConvVariant.TRANSLATION_INVARIANT):
        raise NotImplementedError(f"facet_conv: variant {variant} is not ported yet")
    u, c, w, b = params["u"], params["c"], params["w"], params["b"]
    n, in_ch = x.shape
    m, out_ch, _ = w.shape

    # padded destinations have all-zero mult rows → zero z rows
    pad = mult_rows.shape[1] - n
    if pad:
        x = torch.nn.functional.pad(x, (0, 0, 0, pad))
    proj = -u if variant == FacetConvVariant.TRANSLATION_INVARIANT else params["v"]
    cat = torch.cat([x, x @ proj.T], dim=-1).contiguous()
    rows = mult_rows[:, :, 0]
    z = FacetConvEpilogue.apply(cat, (x @ u.T).contiguous(), c, adj_sm, adj_t_sm, rows)
    # z columns are m-major (m·C + ch)
    w_flat = w.permute(1, 0, 2).reshape(out_ch, m * in_ch)
    y = z @ w_flat.T
    gate = (rows.sum(dim=0) > 0).to(y.dtype)
    y = y + b[None, :] * gate[:, None]
    return y[:n] if pad else y
