"""NaN/Inf guards (the port's counterpart of
``facet_graph_convolution_tpu/utils/guards.py``).

The reference scans the network output for NaN after every step and aborts
at the next checkpoint when fully NaN (train.py:505-506,551-555,620-624).
Here the check is one reduction on the tensors' device over a nested dict
(or list, or tuple) of tensors, such as the parameters.
"""

from __future__ import annotations

from typing import List

import torch


def _leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in _leaves(v)]
    return [tree] if torch.is_tensor(tree) else []


def has_nonfinite(tree) -> torch.Tensor:
    """Scalar bool tensor: any non-finite value in any floating tensor of
    ``tree`` (on the first such tensor's device; no host sync)."""
    flags = [torch.any(~torch.isfinite(leaf)) for leaf in _leaves(tree)
             if leaf.is_floating_point()]
    if not flags:
        return torch.tensor(False)
    return torch.any(torch.stack([f.to(flags[0].device) for f in flags]))


def assert_finite_tree(tree, name: str = "tree") -> None:
    """Host-side check (forces a sync); raises on non-finite values."""
    if bool(has_nonfinite(tree)):
        raise FloatingPointError(f"non-finite values detected in {name}")
