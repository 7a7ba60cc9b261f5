"""Binary-tree pooling and repeat unpooling on ``[N, C]`` (torch
counterparts of ``facet_graph_convolution_tpu/ops/pooling.py``; reference
``custom_binary_tree_pooling`` model.py:779-815, ``custom_upsampling``
model.py:817-825).

The Graclus order puts the 2^steps descendants of each coarse node at
consecutive indices, so pooling is a reshape and a reduction.
"""

from __future__ import annotations

import torch

from facet_graph_convolution_torch.ops import tree_pool_kernel


def tree_pool(x: torch.Tensor, steps: int = 1, mode: str = "max") -> torch.Tensor:
    """Pool sibling groups of 2^steps nodes: [N, C] → [N / 2^steps, C].

    - ``max`` / ``avg``: a plain reduction (model.py:786-791);
    - ``avg_ignore_zeros``: ``steps`` rounds of pairwise mean where an
      all-zero sibling (a fake node) is replaced by its partner
      (model.py:792-814), through K4
      (:func:`facet_graph_convolution_torch.ops.tree_pool_kernel.
      tree_pool_ignore_zeros`) on a CUDA tensor.
    """
    n, c = x.shape
    if mode == "max":
        return torch.amax(x.reshape(-1, 2 ** steps, c), dim=1)
    if mode == "avg":
        return torch.mean(x.reshape(-1, 2 ** steps, c), dim=1)
    if mode == "avg_ignore_zeros":
        return tree_pool_kernel.tree_pool_ignore_zeros(x, steps)
    raise ValueError(f"unknown pool mode {mode!r}")


def tree_unpool(x: torch.Tensor, steps: int = 1) -> torch.Tensor:
    """Copy each coarse node to its 2^steps descendants:
    [N, C] → [N·2^steps, C]."""
    return torch.repeat_interleave(x, 2 ** steps, dim=0)
