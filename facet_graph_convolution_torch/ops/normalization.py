"""Normalization and activation (torch counterparts of
``facet_graph_convolution_tpu/ops/normalization.py``; reference
``normalizeTensor`` utils.py:1700-1715, ``tensorDotProduct`` utils.py:37-41,
``lrelu`` model.py:828-830)."""

from __future__ import annotations

import torch


def dot_last(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Sum-product over the last axis (reference ``tensorDotProduct``)."""
    return torch.sum(x * y, dim=-1)


def normalize_tensor(x: torch.Tensor, epsilon: float = 1e-5) -> torch.Tensor:
    """The reference's exact sequence:

    1. ``x ← x / (mean|x| + ε)``, a global prescale over the whole tensor;
    2. ``x ← x / sqrt(ε + Σ x²)`` per row, where rows with norm ≤ ε map to 0.
    """
    x = x / (torch.mean(torch.abs(x)) + epsilon)
    norm = torch.sqrt(epsilon + torch.sum(x * x, dim=-1))
    inv = torch.where(norm > epsilon, 1.0 / (norm + epsilon), torch.zeros_like(norm))
    return x * inv[..., None]


def lrelu(x: torch.Tensor, alpha: float = 0.1) -> torch.Tensor:
    """Leaky ReLU written like the reference: relu(x) − α·relu(−x)."""
    return torch.relu(x) - alpha * torch.relu(-x)
