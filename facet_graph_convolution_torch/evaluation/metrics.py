"""Evaluation metrics (host, NumPy and SciPy).

The port's own copy of ``facet_graph_convolution_tpu/evaluation/metrics.py``.
Parity targets: ``angularDiff``/``angularDiffVec`` (utils.py:1168-1239),
``oneSidedHausdorff`` (utils.py:704-757), ``hausdorffOverSampled``
(utils.py:816-1006). Nearest-neighbour queries use a KD-tree: exact (the
reference's 5³-grid-with-halo partition can miss the true NN across a halo
boundary) and ~100× faster than its per-point loops.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
from scipy.spatial import cKDTree

from facet_graph_convolution_torch.geometry.mesh_math import normalize_rows


def angular_error(pred: np.ndarray, gt: np.ndarray) -> np.ndarray:
    """Per-face angular error in degrees: ``acos(0.999999·⟨n, n_gt⟩)``
    (reference ``angularDiffVec``, utils.py:1217-1239 — the 0.999999 factor
    keeps acos finite for perfectly aligned normals)."""
    pred = normalize_rows(np.asarray(pred, np.float64))
    gt = normalize_rows(np.asarray(gt, np.float64))
    dp = np.sum(pred * gt, axis=1)
    return np.degrees(np.arccos(0.999999 * dp))


def angular_error_stats(pred: np.ndarray, gt: np.ndarray) -> Tuple[float, float]:
    """(mean, std) angular error over real faces; fake faces — GT normal with
    all |components| ≤ 1e-3 — are excluded (reference ``angularDiff``,
    utils.py:1168-1212)."""
    gt = np.asarray(gt)
    fake = np.all(np.abs(gt) <= 10e-4, axis=-1)
    ang = angular_error(pred, gt)[~fake]
    return float(ang.mean()), float(ang.std())


def _joint_diag(v0: np.ndarray, v1: np.ndarray) -> float:
    mins = np.minimum(v0.min(axis=0), v1.min(axis=0))
    maxs = np.maximum(v0.max(axis=0), v1.max(axis=0))
    return float(np.sqrt(np.sum((maxs - mins) ** 2)))


def one_sided_hausdorff(v0: np.ndarray, v1: np.ndarray) -> Tuple[float, float]:
    """(max, mean) nearest-neighbour distance from v0 to v1, normalized by
    the joint bounding-box diagonal (reference ``oneSidedHausdorff``,
    utils.py:704-757)."""
    v0 = np.asarray(v0, np.float64)
    v1 = np.asarray(v1, np.float64)
    diag = _joint_diag(v0, v1)
    d, _ = cKDTree(v1 / diag).query(v0 / diag, k=1)
    return float(d.max()), float(d.mean())


def hausdorff_oversampled(
    v0: np.ndarray,
    v1: np.ndarray,
    dense_v0: np.ndarray,
    dense_v1: np.ndarray,
    accuracy_only: bool = False,
) -> Tuple[float, float, float, float]:
    """Symmetric oversampled Hausdorff (reference ``hausdorffOverSampled``,
    utils.py:816-1006): accuracy = distances from v0 vertices to the DENSE
    sampling of v1 (and vice versa for completeness), all point sets
    normalized by the joint v0∪v1 bounding box with the origin at its corner.

    Returns (max_accuracy, max_completeness, mean_accuracy,
    mean_completeness). NOTE the reference returns ``np.amin`` where its
    naming suggests max (utils.py:997-1001); we return the max — the actual
    Hausdorff — since the min of a NN-distance vector is ≈0 noise.
    """
    v0 = np.asarray(v0, np.float64)
    v1 = np.asarray(v1, np.float64)
    mins = np.minimum(v0.min(axis=0), v1.min(axis=0))
    diag = _joint_diag(v0, v1)
    v0n = (v0 - mins) / diag
    v1n = (v1 - mins) / diag
    s0 = (np.asarray(dense_v0, np.float64) - mins) / diag
    s1 = (np.asarray(dense_v1, np.float64) - mins) / diag

    acc, _ = cKDTree(s1).query(v0n, k=1)
    if accuracy_only:
        return float(acc.max()), 0.0, float(acc.mean()), 0.0
    comp, _ = cKDTree(s0).query(v1n, k=1)
    return float(acc.max()), float(comp.max()), float(acc.mean()), float(comp.mean())
