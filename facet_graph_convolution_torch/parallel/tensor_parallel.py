"""Tensor parallelism for the wide fc head (the port's counterpart of
``facet_graph_convolution_tpu/parallel/tensor_parallel.py``).

The reference has no tensor parallelism (SURVEY.md §2.7); its only wide
weights are the Lin(1024) heads (model.py:937). JAX shards the fc hidden
axis over a mesh axis and lets XLA's sharding propagation place the
reduction. Nothing propagates shardings in PyTorch, so here the split is
an explicit Megatron one over the ranks of a group:

- ``fc1`` / ``fc_mid`` / ``fc_coarse`` are column-parallel: each rank keeps
  its slice of the hidden axis of ``w`` [in, hidden] and of ``b``
  [hidden], so its hidden activations are its slice of the whole;
- ``out0`` / ``out1`` / ``out2`` are row-parallel: each rank keeps the
  matching rows of ``w`` [hidden, out], its partial products are summed
  over the ranks by one all-reduce an out layer, then the bias is added
  (replicated);
- everything else (the convs) is replicated.

:func:`..models.unet.unet_apply` takes the group (``tp_group``) and issues
the all-reduce; without it the forward is unchanged. The hidden width must
be a multiple of the group's size. Worth it where ``fc_channels`` grows far
beyond 1024 or a card's memory is tight; at the reference's sizes the heads
are small and the graph sharding dominates.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from facet_graph_convolution_torch.parallel.mesh import GraphGroup

COLUMN_LAYERS = ("fc1", "fc_mid", "fc_coarse")
ROW_LAYERS = ("out0", "out1", "out2")


def unet_param_shardings(params: Dict) -> Dict[str, Dict[str, Optional[int]]]:
    """The axis along which each U-Net parameter is split over the ranks
    (JAX ``unet_param_shardings``, whose ``PartitionSpec`` names the same
    axis; the split does not depend on the group): 1 for the
    column-parallel layers' ``w`` [in, hidden], 0 for their ``b`` [hidden]
    and for the row-parallel out layers' ``w`` [hidden, out], None
    (replicated) for everything else."""
    def axis(layer: str, leaf: torch.Tensor) -> Optional[int]:
        if layer in COLUMN_LAYERS:
            return leaf.dim() - 1
        if layer in ROW_LAYERS and leaf.dim() == 2:
            return 0
        return None

    return {layer: {name: axis(layer, leaf) for name, leaf in leaves.items()}
            for layer, leaves in params.items()}


def shard_unet_params(params: Dict, group: GraphGroup) -> Dict:
    """This rank's parameters under :func:`unet_param_shardings` (JAX
    ``shard_unet_params``): each split leaf's ``group.rank``-th of
    ``group.size`` equal slices along its axis, the others as they are, on
    the group's device. Pass the result with ``tp_group=group`` to
    :func:`..models.unet.unet_apply`."""
    out = {}
    for layer, axes in unet_param_shardings(params).items():
        out[layer] = {}
        for name, axis in axes.items():
            leaf = params[layer][name]
            if axis is not None:
                width = leaf.shape[axis]
                if width % group.size:
                    raise ValueError(f"shard_unet_params: {layer}.{name} has {width} along "
                                     f"axis {axis}, not a multiple of {group.size} ranks")
                part = width // group.size
                leaf = leaf.narrow(axis, group.rank * part, part)
            out[layer][name] = leaf.detach().to(group.device).contiguous()
    return out
