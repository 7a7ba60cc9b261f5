"""Losses (torch counterparts of
``facet_graph_convolution_tpu/models/losses.py``): the angular facet-normal
losses (reference ``faceNormalsLoss`` train.py:1272-1294,
``charbonnierFaceNormalsLoss`` train.py:1297-1325) and the sampled chamfer
point-set losses of vertex training (``accuracyLoss`` train.py:1332-1369,
``fullLoss`` train.py:1373-1424, ``sampledAccuracyLoss`` train.py:1428-1462).

The chamfer minima are ``torch.amin``, whose gradient splits evenly among
tied minima as JAX's ``jnp.min`` does (``torch.min(dim)`` would send it all
to one index).
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


def _pairwise_dist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """All-pairs Euclidean distance [len(a), len(b)] as ``sqrt(d² + 1e-20)``:
    the gradient ``diff / sqrt(d² + 1e-20)`` is 0 at coincident points, where
    the norm's ``diff / dist`` would be 0/0 = NaN and reach every parameter
    through the minima's unselected branches."""
    d2 = torch.sum(torch.square(a[:, None, :] - b[None, :, :]), dim=-1)
    return torch.sqrt(d2 + 1e-20)


def _threshold(dist: torch.Tensor, threshold: float) -> torch.Tensor:
    """``dist`` where ≤ threshold, else 0, written so that a NaN distance
    stays NaN (the reference's ``where(dist <= thr, dist, 0)`` maps it to 0
    and hides a poisoned state from the NaN abort)."""
    return torch.where(dist > threshold, 0.0, dist)


def accuracy_loss(p0: torch.Tensor, p1: torch.Tensor, sample_idx: torch.Tensor,
                  threshold: float = 5.0) -> torch.Tensor:
    """Thresholded precision of the sampled ``p0[sample_idx]`` against the
    whole ``p1``, plus completeness, ×1000 (reference ``accuracyLoss``)."""
    dist = _pairwise_dist(p0[sample_idx], p1)
    precision = _threshold(torch.amin(dist, dim=1), threshold)
    return 1000.0 * (torch.mean(precision) + torch.mean(torch.amin(dist, dim=0)))


def full_chamfer_loss(p0: torch.Tensor, p1: torch.Tensor, sample_idx0: torch.Tensor,
                      sample_idx1: torch.Tensor, accuracy_threshold: float = 5000.0,
                      completeness_threshold: float = 5000.0) -> torch.Tensor:
    """Sampled symmetric chamfer, ×1000 (reference ``fullLoss``): sampled-p0
    → whole-p1 precision plus whole-p0 → sampled-p1 completeness, each
    thresholded; the distance matrices are [s0, N1] and [N0, s1]."""
    dist0 = _pairwise_dist(p0[sample_idx0], p1)
    dist1 = _pairwise_dist(p0, p1[sample_idx1])
    precision = _threshold(torch.amin(dist0, dim=1), accuracy_threshold)
    completeness = _threshold(torch.amin(dist1, dim=0), completeness_threshold)
    return 1000.0 * (torch.mean(precision) + torch.mean(completeness))


def sampled_accuracy_loss(p0: torch.Tensor, p1: torch.Tensor,
                          threshold: float = 5.0) -> torch.Tensor:
    """Whole symmetric chamfer with thresholded precision, ×1000 (reference
    ``sampledAccuracyLoss``)."""
    dist = _pairwise_dist(p0, p1)
    accu = _threshold(torch.amin(dist, dim=1), threshold)
    return 1000.0 * (torch.mean(accu) + torch.mean(torch.amin(dist, dim=0)))
