"""Point-set utilities (host, NumPy).

The port's own copy of
``facet_graph_convolution_tpu/geometry/pointset.py`` (reference
``getBoundingBox`` utils.py:2130-2137, ``normalizePointSets``
utils.py:2077-2104, ``takePointSetSlice`` utils.py:2109-2125, ``getDensePC``
utils.py:2322-2340, ``rand_rotation_matrix`` utils.py:2034-2074).
"""

from __future__ import annotations

from typing import Optional, Tuple

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


def dense_point_cloud(
    vertices: np.ndarray, faces: np.ndarray, res: int = 4
) -> np.ndarray:
    """The vertices plus, on every face, the barycentric lattice points
    ``(b0·v1 + b1·v2 + (res−b0−b1)·v3)/res`` with ``0 < b0+b1`` and
    ``b0, b1 < res`` (reference ``getDensePC``)."""
    faces = np.asarray(faces, dtype=np.int64)
    v1 = vertices[faces[:, 0]]
    v2 = vertices[faces[:, 1]]
    v3 = vertices[faces[:, 2]]
    samples = [np.asarray(vertices)]
    for b0 in range(res):
        for b1 in range(res - b0 + 1):
            if b0 < res and b1 < res and b0 + b1 > 0:
                samples.append((b0 * v1 + b1 * v2 + (res - b0 - b1) * v3) / res)
    return np.concatenate(samples, axis=0)


def random_rotation_matrix(
    deflection: float = 1.0, randnums: Optional[np.ndarray] = None,
    rng: Optional[np.random.Generator] = None,
) -> np.ndarray:
    """Uniform random 3D rotation by Arvo's Householder method (reference
    ``rand_rotation_matrix``); ``randnums`` are its three uniforms."""
    if randnums is None:
        rng = rng or np.random.default_rng()
        randnums = rng.uniform(size=(3,))
    theta, phi, z = randnums
    theta = theta * 2.0 * deflection * np.pi
    phi = phi * 2.0 * np.pi
    z = z * 2.0 * deflection

    r = np.sqrt(z)
    v = np.array([np.sin(phi) * r, np.cos(phi) * r, np.sqrt(2.0 - z)])
    st, ct = np.sin(theta), np.cos(theta)
    rot = np.array([[ct, st, 0.0], [-st, ct, 0.0], [0.0, 0.0, 1.0]])
    return (np.outer(v, v) - np.eye(3)).dot(rot)
