"""Per-face and per-vertex quantities of a mesh, from its vertices and
faces alone: the inputs and targets that the plain reference works out
again from the meshes it is given (numpy, float64 inside)."""

from __future__ import annotations

import numpy as np


def face_normals(vertices: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Unit normals ``cross(v1 − v0, v2 − v0) / |·|`` [F, 3] float32 (0 for
    a degenerate face)."""
    tri = np.asarray(vertices, np.float64)[np.asarray(faces, np.int64)]
    n = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    norm = np.linalg.norm(n, axis=1, keepdims=True)
    return np.where(norm > 0, n / np.where(norm > 0, norm, 1.0), 0.0).astype(np.float32)


def bbox_diagonal(*point_sets: np.ndarray) -> float:
    """Diagonal of the joint axis-aligned bounding box."""
    lo = np.min([np.asarray(p, np.float64).min(axis=0) for p in point_sets], axis=0)
    hi = np.max([np.asarray(p, np.float64).max(axis=0) for p in point_sets], axis=0)
    return float(np.sqrt(np.sum((hi - lo) ** 2)))


def face_centres(vertices: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Centroids [F, 3] float32 of the faces, in the frame of the mesh
    scaled by its bounding-box diagonal (the paper's position input)."""
    v = np.asarray(vertices, np.float64)
    diag = bbox_diagonal(v)
    if diag > 0:
        v = v / diag
    return v[np.asarray(faces, np.int64)].mean(axis=1).astype(np.float32)


def face_inputs(vertices: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """The network's per-face input [F, 6]: unit normal, then centroid."""
    return np.concatenate([face_normals(vertices, faces), face_centres(vertices, faces)], axis=1)
