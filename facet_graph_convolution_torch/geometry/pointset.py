"""Point-set utilities (host, NumPy).

The port's own copy of the functions of
``facet_graph_convolution_tpu/geometry/pointset.py`` that the vertex
pipeline needs (reference ``getBoundingBox`` utils.py:2130-2137,
``normalizePointSets`` utils.py:2077-2104, ``takePointSetSlice``
utils.py:2109-2125).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def bounding_box(points: np.ndarray) -> np.ndarray:
    """Axis-aligned bounding box ``[[xmin, xmax], [ymin, ymax], [zmin, zmax]]``."""
    points = np.asarray(points)
    return np.stack([points.min(axis=0), points.max(axis=0)], axis=1)


def bounding_box_diagonal(*point_sets: np.ndarray) -> float:
    """Diagonal of the joint bounding box of the given point sets."""
    mins = np.min([np.asarray(p).min(axis=0) for p in point_sets], axis=0)
    maxs = np.max([np.asarray(p).max(axis=0) for p in point_sets], axis=0)
    return float(np.sqrt(np.sum((maxs - mins) ** 2)))


def normalize_point_sets(a: np.ndarray, b: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Both point sets scaled by their joint bounding-box diagonal."""
    diag = bounding_box_diagonal(a, b)
    return a / diag, b / diag


def point_set_slice(points: np.ndarray, box: np.ndarray) -> np.ndarray:
    """The points inside the inclusive bounding box ``box``."""
    points = np.asarray(points)
    inside = np.all((points >= box[:, 0]) & (points <= box[:, 1]), axis=1)
    return points[inside]
