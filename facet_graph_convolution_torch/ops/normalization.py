"""Normalization and activation (torch counterparts of
``facet_graph_convolution_tpu/ops/normalization.py``; reference
``normalizeTensor`` utils.py:1700-1715, ``tensorDotProduct`` utils.py:37-41,
``lrelu`` model.py:828-830, ``tfComputeNormals`` utils.py:71-83,
``batch_norm`` model.py:408-424)."""

from __future__ import annotations

from typing import Dict

import numpy as np
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


def face_normals_device(points: torch.Tensor, faces: torch.Tensor) -> torch.Tensor:
    """Facet normals of the current vertex positions, on their device
    (reference ``tfComputeNormals``: ``cross(v1−v0, v2−v1)``, then
    :func:`normalize_tensor`)."""
    tri = points[faces.long()]                          # [F, 3, 3]
    return normalize_tensor(torch.linalg.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 1]))


def init_moments_norm(channels: int, seed: int = 0, std_dev: float = 0.05,
                      device: str = "cuda") -> Dict[str, torch.Tensor]:
    """``gamma`` and ``beta`` [channels] ~ N(0, std_dev) from a numpy seed
    (the JAX package's keys and layouts)."""
    rng = np.random.default_rng(seed)
    return {name: torch.as_tensor(rng.normal(size=(channels,)).astype(np.float32)
                                  * np.float32(std_dev), device=device)
            for name in ("gamma", "beta")}


def moments_norm(params: Dict[str, torch.Tensor], x: torch.Tensor,
                 epsilon: float = 1e-6) -> torch.Tensor:
    """Moment normalization over the node axis with a learned scale and
    shift (reference ``batch_norm`` fullNorm path, model.py:408-416; not
    used by the default model): the population variance, as ``jnp.var``."""
    mean = torch.mean(x, dim=0)
    var = torch.var(x, dim=0, unbiased=False)
    return (x - mean) * torch.rsqrt(var + epsilon) * params["gamma"] + params["beta"]
