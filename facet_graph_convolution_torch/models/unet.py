"""Three-level facet-graph U-Net, forward (reference
``get_model_reg_multi_scale``, model.py:837-946):

    L0: conv1 → lrelu → max tree-pool (4:1)
    L1: conv2 → lrelu → max tree-pool (4:1)
    L2: conv3 → lrelu → dconv3 → lrelu
        [multi-scale head: fc_coarse → lrelu → out2]
    L1: unpool → upconv2 → concat skip → dconv2 → lrelu
        [multi-scale head: fc_mid → lrelu → out1]
    L0: unpool → upconv1 → concat skip → dconv1 → lrelu → fc1 → lrelu → out0

:func:`unet_apply` is the counterpart of
``facet_graph_convolution_tpu/models/unet.py::unet_apply_pallas`` (the
repo's kernel configuration of the forward) for the default and
translation-invariant variants, and of ``unet_apply_nminor`` for the
rotation-invariant one: conv1 rotation-invariant (through K3), the other 7
convs default (through K1 and K2), per :func:`..ops.conv.per_conv_variants`.
:func:`unet_apply_rowmajor` is the JAX package's row-major ``unet_apply``
over raw one-indexed K-lists, in plain PyTorch: the port's own oracle.
Parameters are a plain dict of tensors with the JAX package's keys and
layouts (:mod:`..params`).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.utils.checkpoint

from facet_graph_convolution_torch.graph.convert import (
    batched_level_tables,
    dedupe_klist,
    level_tables,
    slot_major_arrays,
    split_self_klist,
)
from facet_graph_convolution_torch.ops.conv import (
    FacetConvVariant,
    facet_conv,
    facet_conv_rowmajor,
    init_facet_conv,
    init_linear,
    linear,
    per_conv_variants,
)
from facet_graph_convolution_torch.ops.normalization import lrelu
from facet_graph_convolution_torch.ops.pooling import tree_pool, tree_unpool

Output = Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]


def init_unet(
    seed: int = 0,
    in_channels: int = 6,
    channels: Sequence[int] = (32, 64, 128),
    num_filters: int = 9,
    fc_channels: int = 1024,
    out_channels: int = 3,
    multi_scale: bool = False,
    std_dev: float = 0.05,
    std_dev_bias: float = 0.01,
    variant: FacetConvVariant = FacetConvVariant.DEFAULT,
    device: str = "cuda",
) -> Dict[str, Dict[str, torch.Tensor]]:
    """Random parameters from a numpy seed (reference init: N(0, 0.05)
    weights, N(0, 0.01) biases, model.py:31-44); ``multi_scale`` adds the
    mid and coarse heads (``fc_mid``, ``out1``, ``fc_coarse``, ``out2``).
    A conv has ``v`` where its variant (:func:`per_conv_variants`) is the
    default: under rotation invariance every conv but conv1. The numbers
    differ from the JAX package's ``init_unet`` for the same seed; the keys
    and layouts are the same."""
    rng = np.random.default_rng(seed)
    c0, c1, c2 = channels
    v_first, v_rest = per_conv_variants(variant)

    def conv(cin, cout, var=v_rest):
        return init_facet_conv(cin, cout, num_filters, var, std_dev, std_dev_bias, rng, device)

    def lin(cin, cout):
        return init_linear(cin, cout, std_dev, std_dev_bias, rng, device)

    params = {
        "conv1": conv(in_channels, c0, v_first),
        "conv2": conv(c0, c1),
        "conv3": conv(c1, c2),
        "dconv3": conv(c2, c2),
        "upconv2": conv(c2, c1),
        "dconv2": conv(2 * c1, c1),
        "upconv1": conv(c1, c0),
        "dconv1": conv(2 * c0, c0),
        "fc1": lin(c0, fc_channels),
        "out0": lin(fc_channels, out_channels),
    }
    if multi_scale:
        params["fc_mid"] = lin(c1, fc_channels)
        params["out1"] = lin(fc_channels, out_channels)
        params["fc_coarse"] = lin(c2, fc_channels)
        params["out2"] = lin(fc_channels, out_channels)
    return params


def _no_record(name: str, t: torch.Tensor) -> None:
    pass


def _fine_head(fc1, out0, d1, alpha):
    return linear(out0, lrelu(linear(fc1, d1), alpha))


def _network(params: Dict, x: torch.Tensor, conv: Callable, levels: int,
             coarsening_steps: int, alpha: float, multi_scale: bool,
             record: Callable[[str, torch.Tensor], None] = _no_record,
             remat_head: bool = False) -> Output:
    """The U-Net of the module docstring around ``conv(name, h, level)``;
    ``record(name, t)`` sees the intermediates of the fine path under the
    reference's scope names (``evaluation/parity.py``). ``remat_head`` runs
    the fine fc head (3-level network) under ``torch.utils.checkpoint``, so
    that its [N, fc] activations are recomputed in the backward rather than
    kept (``record`` then does not see ``fc1``)."""
    if levels == 1 and multi_scale:
        raise ValueError("multi_scale heads need the 3-level pyramid; got a single "
                         "adjacency level (the reference hard-codes 3 levels, settings.py:32)")
    h1 = lrelu(conv("conv1", x, 0), alpha)
    record("conv1_act", h1)
    if levels == 1:
        h = lrelu(linear(params["fc1"], h1), alpha)
        return linear(params["out0"], h)

    p1 = tree_pool(h1, steps=coarsening_steps)
    record("pool1", p1)
    h2 = lrelu(conv("conv2", p1, 1), alpha)
    p2 = tree_pool(h2, steps=coarsening_steps)
    record("pool2", p2)
    h3 = lrelu(conv("conv3", p2, 2), alpha)
    d3 = lrelu(conv("dconv3", h3, 2), alpha)

    u2 = tree_unpool(d3, steps=coarsening_steps)
    record("upsamp2", u2)
    u2 = conv("upconv2", u2, 1)
    d2 = lrelu(conv("dconv2", torch.cat([u2, h2], dim=-1), 1), alpha)

    u1 = tree_unpool(d2, steps=coarsening_steps)
    record("upsamp1", u1)
    u1 = conv("upconv1", u1, 0)
    d1 = lrelu(conv("dconv1", torch.cat([u1, h1], dim=-1), 0), alpha)

    if remat_head:
        y_fine = torch.utils.checkpoint.checkpoint(
            _fine_head, params["fc1"], params["out0"], d1, alpha, use_reentrant=False)
    else:
        h = lrelu(linear(params["fc1"], d1), alpha)
        record("fc1", h)
        y_fine = linear(params["out0"], h)
    record("out0", y_fine)
    if not multi_scale:
        return y_fine
    y_mid = linear(params["out1"], lrelu(linear(params["fc_mid"], d2), alpha))
    y_coarse = linear(params["out2"], lrelu(linear(params["fc_coarse"], d3), alpha))
    return y_fine, y_mid, y_coarse


def unet_apply(
    params: Dict,
    x: torch.Tensor,
    adjs: Sequence[torch.Tensor],
    mult_rows: Sequence[torch.Tensor],
    coarsening_steps: int = 2,
    alpha: float = 0.1,
    variant: FacetConvVariant = FacetConvVariant.DEFAULT,
    adj_ts: Optional[Sequence[torch.Tensor]] = None,
    multi_scale: bool = False,
    compute_dtype: Optional[torch.dtype] = None,
) -> Output:
    """Forward pass: ``x`` [N, C] → [N, out]. ``adjs`` are the per-level
    slot-major [K', N'] neighbour lists and ``mult_rows`` the [K'+1, N', 1]
    rows of :func:`facet_graph_convolution_torch.graph.convert.
    slot_major_arrays`, fine level first (1 or 3 levels); ``adj_ts`` their
    transpose maps, which the backward needs (:func:`train_graph_tensors`).
    ``multi_scale`` returns ``(y_fine, y_mid, y_coarse)``, one output per
    pyramid level (3 levels needed). ``compute_dtype`` is every conv's
    (``unet_apply_pallas(compute_dtype=...)``; None keeps x's dtype): under
    bfloat16 the convs' interiors are bfloat16 and their outputs f32, and
    lrelu, the pools and the dense layers stay f32
    (:func:`..ops.conv.facet_conv`)."""
    v_first, v_rest = per_conv_variants(variant)

    def conv(name, h, level):
        return facet_conv(params[name], h, adjs[level], mult_rows[level],
                          variant=v_first if name == "conv1" else v_rest,
                          adj_t_sm=None if adj_ts is None else adj_ts[level],
                          compute_dtype=compute_dtype)

    return _network(params, x, conv, len(adjs), coarsening_steps, alpha, multi_scale)


def unet_apply_rowmajor(
    params: Dict,
    x: torch.Tensor,
    adjs: Sequence[torch.Tensor],
    coarsening_steps: int = 2,
    alpha: float = 0.1,
    variant: FacetConvVariant = FacetConvVariant.DEFAULT,
    multi_scale: bool = False,
) -> Output:
    """The same network over raw one-indexed K-lists ``adjs`` [N, K] per
    level (slot 0 = self, 0 = pad; 1 or 3 levels), every conv the plain
    :func:`..ops.conv.facet_conv_rowmajor` (the JAX package's row-major
    ``unet_apply``, ``models/unet.py:91-179``). No kernel runs."""
    v_first, v_rest = per_conv_variants(variant)

    def conv(name, h, level):
        return facet_conv_rowmajor(params[name], h, adjs[level],
                                   variant=v_first if name == "conv1" else v_rest)

    return _network(params, x, conv, len(adjs), coarsening_steps, alpha, multi_scale)


def _tensors(tables, device: str):
    """``(adjs, mult_rows)`` on ``device`` from per-level ``(adj_sm,
    mult_rows)`` host tables."""
    return ([torch.as_tensor(adj_sm, device=device) for adj_sm, _ in tables],
            [torch.as_tensor(rows, device=device) for _, rows in tables])


def graph_tensors(adjs_raw: Sequence[np.ndarray], device: str):
    """Kernel tables of a patch's raw one-indexed K-lists, as tensors on
    ``device``: ``(adjs, mult_rows)`` for :func:`unet_apply` (the JAX
    package's ``_graph_arrays(..., pallas=True)``, without the backward's
    transpose maps, which are not built)."""
    return _tensors([level_tables(a) for a in adjs_raw], device)


def batched_graph_tensors(adjs_batch: Sequence[np.ndarray], coarsening_steps: int,
                          device: str, widths: Optional[Sequence[int]] = None):
    """Kernel tables of B patches padded to one bucket, ``adjs_batch[l]``
    [B, N_l, K_l] per level, as the one block-diagonal graph of
    :func:`..graph.convert.batched_level_tables`: :func:`unet_apply` on
    their inputs ``[B·N, C]`` runs each patch's network at once, one launch
    a conv for the batch. ``widths`` fixes each level's neighbour slots."""
    return _tensors(batched_level_tables(adjs_batch, 2 ** coarsening_steps, widths), device)


def train_graph_arrays(adjs_raw: Sequence[np.ndarray]):
    """The host tables of :func:`train_graph_tensors`, as numpy arrays
    ``(adjs, adj_ts, mult_rows)`` (the streaming loader builds them on its
    thread)."""
    adjs, adj_ts, rows = [], [], []
    for a in adjs_raw:
        a_u, mult = dedupe_klist(np.asarray(a))
        # slot_major_arrays pads the node axis before it builds the transpose
        # map, whose flat slots k·N' + n are strided by the padded N'
        adj_sm, adj_t_sm, mult_rows = slot_major_arrays(*split_self_klist(a_u, mult))
        adjs.append(adj_sm)
        adj_ts.append(adj_t_sm)
        rows.append(mult_rows)
    return adjs, adj_ts, rows


def train_graph_tensors(adjs_raw: Sequence[np.ndarray], device: str):
    """The training form of :func:`graph_tensors`: ``(adjs, adj_ts,
    mult_rows)``, with each level's transpose map for the backward (the JAX
    package's ``_graph_arrays(..., pallas=True)``)."""
    return tuple([torch.as_tensor(a, device=device) for a in tables]
                 for tables in train_graph_arrays(adjs_raw))
