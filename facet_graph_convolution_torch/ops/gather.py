"""Node-minor (lane-axis) neighbour gather, forward (torch counterpart of
``facet_graph_convolution_tpu/ops/gather.py::gather_neighbors_lane``, its
zero-column form; reference ``get_slices``, model.py:380-405)."""

from __future__ import annotations

import torch


def gather_neighbors_lane(x_t: torch.Tensor, adjT: torch.Tensor) -> torch.Tensor:
    """``x_t`` [C, N] node-minor features and ``adjT`` [K, N] a one-indexed
    transposed K-list (0 = pad) → [C, K, N]: ``out[c, k, n] = x_t[c,
    adjT[k, n] - 1]``, and 0 for pad slots (a zero column is prepended).

    The serving solvers call it under ``torch.no_grad()``. Under autograd its
    backward is ``index_select``'s scatter, not the JAX package's
    scatter-free transpose gather over ``adjT_t``, which is not ported yet.
    """
    c = x_t.shape[0]
    pad = torch.cat([x_t.new_zeros(c, 1), x_t], dim=1)
    return pad.index_select(1, adjT.reshape(-1).long()).reshape(c, *adjT.shape)
