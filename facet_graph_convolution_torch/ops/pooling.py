"""Binary-tree max pooling and repeat unpooling on ``[N, C]`` (torch
counterparts of ``facet_graph_convolution_tpu/ops/pooling.py``; reference
``custom_binary_tree_pooling`` model.py:779-815, ``custom_upsampling``
model.py:817-825).

The Graclus order puts the 2^steps descendants of each coarse node at
consecutive indices, so pooling is a reshape and a reduction.
"""

from __future__ import annotations

import torch


def tree_pool(x: torch.Tensor, steps: int = 1) -> torch.Tensor:
    """Max over sibling groups of 2^steps nodes: [N, C] → [N / 2^steps, C]."""
    n, c = x.shape
    return torch.amax(x.reshape(-1, 2 ** steps, c), dim=1)


def tree_unpool(x: torch.Tensor, steps: int = 1) -> torch.Tensor:
    """Copy each coarse node to its 2^steps descendants:
    [N, C] → [N·2^steps, C]."""
    return torch.repeat_interleave(x, 2 ** steps, dim=0)
