"""Angular facet-normal losses (torch counterparts of
``facet_graph_convolution_tpu/models/losses.py::face_normals_loss`` and
``charbonnier_face_normals_loss``; reference ``faceNormalsLoss``
train.py:1272-1294, ``charbonnierFaceNormalsLoss`` train.py:1297-1325).

The chamfer losses of the vertex pipeline are not ported yet (vertex slice).
"""

from __future__ import annotations

import math

import torch

from facet_graph_convolution_torch.ops.normalization import dot_last

_CLOSE_TO_ONE = 0.9999999  # acos clamp (train.py:1278)


def _fake_node_mask(gt: torch.Tensor) -> torch.Tensor:
    """Fake (padding) nodes are those whose GT normal has |·|₁ ≤ 1e-3
    (reference train.py:1280-1281)."""
    return torch.sum(torch.abs(gt), dim=-1) <= 10e-4


def face_normals_loss(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Mean angular error in degrees over real nodes:
    ``acos(clamp(⟨n, n_gt⟩, ±0.9999999)) · 180/π`` with fake nodes masked
    from numerator and denominator (reference ``faceNormalsLoss``)."""
    dp = dot_last(pred, gt)
    ang = torch.acos(torch.clamp(dp, -_CLOSE_TO_ONE, _CLOSE_TO_ONE)) * (180.0 / math.pi)
    fake = _fake_node_mask(gt)
    real = torch.where(fake, 0.0, 1.0)
    ang = torch.where(fake, 0.0, ang)
    return torch.sum(ang) / torch.sum(real)


def charbonnier_face_normals_loss(
    pred: torch.Tensor, gt: torch.Tensor, epsilon: float = 10e-4
) -> torch.Tensor:
    """Charbonnier-smoothed variant (reference, unused by default,
    train.py:1297-1325): sqrt(Σ angle² + ε²) over the real nodes, normalized
    by their count."""
    dp = dot_last(pred, gt)
    ang = torch.acos(torch.clamp(dp, -0.999999999, 0.999999999))
    fake = _fake_node_mask(gt)
    real = torch.where(fake, 0.0, 1.0)
    sq = torch.where(fake, 0.0, torch.square(ang))
    return torch.sqrt(torch.sum(sq, dim=-1) + epsilon * epsilon) / torch.sum(real)
