"""Neighbour gathers over one-indexed K-lists (torch counterparts of
``facet_graph_convolution_tpu/ops/gather.py``; reference ``get_slices``,
model.py:380-405): a zero row is gathered for the 0 pads, so padded slots
vanish from sums and stay finite where features are normalized.

- :func:`gather_neighbors`: row-major, ``[N, C]`` over ``adj`` [N, K];
- :func:`gather_slots`: slot-major, ``[N, C]`` over ``adj_sm`` [K', N]
  (the rotation-invariant conv's gather);
- :func:`gather_neighbors_lane`: node-minor, ``[C, N]`` over ``adjT``
  [K, N] (the vertex solvers');
- :func:`make_windowed_lane_gather`: slot-major ``[K, N, C]`` from ``[N_src,
  C]`` over the per-slab window tables of an HBM-scale level (the sharded
  conv's unfused windowed path).

Given a transpose map, the last two are autograd Functions whose backward
is the JAX package's scatter-free one (``_gather_lane_bwd``, :75-95): each
source row sums the cotangents of the slots that read it, listed in the
map, masked where the map pads. No ``index_add_``, no scatter, no atomics:
the same inputs give the same bits.
"""

from __future__ import annotations

from typing import Optional

import torch


def gather_neighbors(x: torch.Tensor, adj: torch.Tensor) -> torch.Tensor:
    """``x`` [N, C], ``adj`` [N, K] one-indexed (0 = pad) → [N, K, C]
    (``gather_neighbors`` without a transpose map: autograd's backward);
    any one-indexed table ``adj`` [A, B] gives [A, B, C]."""
    padded = torch.cat([x.new_zeros(1, x.shape[1]), x], dim=0)
    return padded.index_select(0, adj.reshape(-1).long()).reshape(*adj.shape, x.shape[1])


def neighbor_counts(adj: torch.Tensor) -> torch.Tensor:
    """Non-zero entries per row, self slot included (reference
    ``tf.count_nonzero(adj, 2)``, model.py:436)."""
    return torch.count_nonzero(adj, dim=-1)


def _transpose_sum(g_flat: torch.Tensor, adj_t: torch.Tensor, dim: int) -> torch.Tensor:
    """Σ over the map's slots of ``g_flat``'s rows (``dim`` 0) or columns
    (``dim`` 1) at the one-indexed flat slots ``adj_t`` lists, 0 = pad:
    clamped and masked, as ``_gather_lane_bwd`` does."""
    idx = (adj_t.long() - 1).clamp_min(0)
    valid = (adj_t > 0).to(g_flat.dtype)
    if dim == 0:                                   # adj_t [N, K_t] → [N, C]
        picked = g_flat.index_select(0, idx.reshape(-1)).reshape(*adj_t.shape, -1)
        return (picked * valid[..., None]).sum(dim=1)
    # adj_t [K_t, N] → [C, N]
    picked = g_flat.index_select(1, idx.reshape(-1)).reshape(g_flat.shape[0], *adj_t.shape)
    return (picked * valid[None]).sum(dim=1)


class _GatherSlots(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, adj_sm, adj_t_sm):
        ctx.save_for_backward(adj_t_sm)
        return gather_neighbors(x, adj_sm)

    @staticmethod
    def backward(ctx, g):
        (adj_t_sm,) = ctx.saved_tensors
        if adj_t_sm is None:
            raise RuntimeError(
                "gather_slots: the backward needs the transpose map adj_t_sm "
                "(models.unet.train_graph_tensors builds it)")
        return _transpose_sum(g.reshape(-1, g.shape[-1]), adj_t_sm, 0), None, None


def gather_slots(x: torch.Tensor, adj_sm: torch.Tensor,
                 adj_t_sm: Optional[torch.Tensor]) -> torch.Tensor:
    """``x`` [N, C] over the slot-major one-indexed neighbour list
    ``adj_sm`` [K', N] (0 = pad) → [K', N, C], zeros for pads: the
    neighbour slots of ``ops/facet_conv_kernel.py::_slots`` without the self row.
    ``adj_t_sm`` [N, K_t] lists the one-indexed flat slots ``k·N + i`` that
    read each row (``graph.convert.slot_major_arrays``); the backward sums
    them. It may be None where no gradient reaches ``x``."""
    if adj_t_sm is not None and adj_t_sm.shape[0] != x.shape[0]:
        raise ValueError(f"gather_slots: adj_t_sm has {adj_t_sm.shape[0]} rows, x {x.shape[0]}")
    return _GatherSlots.apply(x, adj_sm, adj_t_sm)


# the JAX package's name (``ops/pallas_conv.py::gather_slot_major``, the same
# gather and scatter-free backward)
gather_slot_major = gather_slots


def _take_lane(x_t: torch.Tensor, adjT: torch.Tensor) -> torch.Tensor:
    pad = torch.cat([x_t.new_zeros(x_t.shape[0], 1), x_t], dim=1)
    return pad.index_select(1, adjT.reshape(-1).long()).reshape(x_t.shape[0], *adjT.shape)


class _GatherLane(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x_t, adjT, adjT_t):
        ctx.save_for_backward(adjT_t)
        return _take_lane(x_t, adjT)

    @staticmethod
    def backward(ctx, g):
        (adjT_t,) = ctx.saved_tensors
        return _transpose_sum(g.reshape(g.shape[0], -1), adjT_t, 1), None, None


def gather_neighbors_lane(x_t: torch.Tensor, adjT: torch.Tensor,
                          adjT_t: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x_t`` [C, N] node-minor features and ``adjT`` [K, N] a one-indexed
    transposed K-list (0 = pad) → [C, K, N]: ``out[c, k, n] = x_t[c,
    adjT[k, n] - 1]``, and 0 for pad slots (a zero column is prepended).

    With ``adjT_t`` [K_t, N_src], the transpose map over the flat slots
    ``k·N + n`` (``graph.convert.lane_tables``), the backward is the
    scatter-free transpose gather-sum; without it, ``index_select``'s own
    (the serving solvers call it under ``torch.no_grad()``)."""
    if adjT_t is not None:
        return _GatherLane.apply(x_t, adjT, adjT_t)
    return _take_lane(x_t, adjT)


class _WindowedGather(torch.autograd.Function):
    """JAX ``make_windowed_lane_gather``'s ``custom_vjp`` over the slabs of
    :func:`..graph.convert.windowed_lane_tables`, row-major."""

    @staticmethod
    def forward(ctx, geometry, x, *tabs):
        block, window, _, num_sources, num_out = geometry
        out_starts, win_starts, relT = tabs[0], tabs[1], tabs[2]
        k = relT.shape[1]
        ctx.geometry, ctx.n_tabs = geometry, len(tabs)
        ctx.save_for_backward(*tabs)
        out = x.new_zeros((k, num_out, x.shape[1]))
        if num_sources > num_out:
            tail_pad = torch.cat([x.new_zeros(1, x.shape[1]), x[num_out:]], dim=0)
        for b in range(out_starts.shape[0]):
            os_, ws = int(out_starts[b]), int(win_starts[b])
            g = x[ws:ws + window].index_select(0, relT[b].reshape(-1).long())
            g = g.reshape(k, block, x.shape[1])
            if num_sources > num_out:
                not_tail, tailT = tabs[7], tabs[8]
                g = g * not_tail[b].to(x.dtype)[..., None] + tail_pad.index_select(
                    0, tailT[b].reshape(-1).long()).reshape(k, block, x.shape[1])
            out[:, os_:os_ + block] = g
        return out

    @staticmethod
    def backward(ctx, g):
        block, _, bwd_window, num_sources, num_out = ctx.geometry
        tabs = ctx.saved_tensors
        out_starts, bwd_starts, relS, validS = tabs[0], tabs[4], tabs[5], tabs[6]
        k, _, c = g.shape
        s = relS.shape[1]
        dx = g.new_zeros((num_out, c))
        for b in range(out_starts.shape[0]):
            os_, bs = int(out_starts[b]), int(bwd_starts[b])
            gwin = g[:, bs:bs + bwd_window].reshape(k * bwd_window, c)
            d = gwin.index_select(0, relS[b].reshape(-1).long()).reshape(s, block, c)
            dx[os_:os_ + block] = (d * validS[b].to(g.dtype)[..., None]).sum(dim=0)
        if num_sources > num_out:
            tailS, tailV = tabs[9], tabs[10]
            d = g.reshape(k * num_out, c).index_select(0, tailS.reshape(-1).long())
            d = d.reshape(*tailS.shape, c) * tailV.to(g.dtype)[..., None]
            dx = torch.cat([dx, d.sum(dim=0)], dim=0)
        return (None, dx) + (None,) * ctx.n_tabs


def make_windowed_lane_gather(geometry):
    """The windowed gather of one level's window ``geometry``
    (``WindowedLaneTables.geometry``), JAX's ``make_windowed_lane_gather``
    in the port's row-major layout: ``f(x [N_src, C], *win_arrays) -> [K,
    N, C]``, ``out[k, n] = x[win_starts[b] + relT[b, k, n − out_starts[b]]]``
    for the slab b of row n (JAX's is ``[C, N] → [C, K, N]``: the tests
    transpose). Pad slots read a clamped row of the window (the consumer
    zeroes them through ``mult_rows``); halo slots (N_src > N) read the halo
    rows. The backward sums each source row's slots through ``relS`` /
    ``validS`` and the halo rows' through ``tailS`` / ``tailV``, in x's
    dtype, with no scatter: ``[N_src, C]``. The last slab overlaps its
    predecessor and writes the same values on the overlap in both
    directions. Plain PyTorch on every device: the default sharded conv
    runs K5 (:mod:`.windowed_conv`) instead."""
    geometry = tuple(int(v) for v in geometry)

    def gather(x, *tabs):
        return _WindowedGather.apply(geometry, x, *tabs)

    return gather
