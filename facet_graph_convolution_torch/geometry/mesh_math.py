"""Vectorized mesh geometry math (host, NumPy).

The port's own copy of the functions of
``facet_graph_convolution_tpu/geometry/mesh_math.py`` that the inference
and evaluation paths need; reference file:line cited per function.
"""

from __future__ import annotations

import warnings

import numpy as np


def normalize_rows(a: np.ndarray, eps: float = 1e-8) -> np.ndarray:
    """L2-normalize along the last axis, twice, with an additive eps inside
    the norm (reference ``normalize`` = ``normalizeOnce`` twice,
    utils.py:26-35); the second pass shrinks the eps bias to O(eps²)."""
    for _ in range(2):
        norms = np.sqrt(np.sum(a * a, axis=-1, keepdims=True)) + eps
        a = a / norms
    return a


def compute_face_normals(vertices: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Unit face normals via cross product (reference ``computeFacesNormals``,
    utils.py:63-68)."""
    tri = vertices[faces.astype(np.int64)]
    n = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    return normalize_rows(n.astype(np.float32))


def compute_vertex_normals(vertices: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Vertex normals as the normalized sum of incident unit face normals
    (reference ``computeNormals``, utils.py:44-59)."""
    faces = faces.astype(np.int64)
    fn = compute_face_normals(vertices, faces)
    normals = np.zeros(vertices.shape, dtype=np.float32)
    for i in range(3):
        np.add.at(normals, faces[:, i], fn)
    return normalize_rows(normals)


def triangle_barycenters(
    vertices: np.ndarray, faces: np.ndarray, normalize: bool = True
) -> np.ndarray:
    """Per-face centroid, optionally scaled by the mesh's bounding-box
    diagonal (reference ``getTrianglesBarycenter``, utils.py:1264-1294)."""
    vertices = np.asarray(vertices, dtype=np.float64)
    if normalize:
        diag = float(np.sqrt(np.sum((vertices.max(axis=0) - vertices.min(axis=0)) ** 2)))
        if diag > 0:
            vertices = vertices / diag
    tri = vertices[faces.astype(np.int64)]
    return tri.mean(axis=1).astype(np.float32)


def average_edge_length(vertices: np.ndarray, faces: np.ndarray):
    """Mean edge length and half-edge count, edges counted once per adjacent
    triangle (reference ``getAverageEdgeLength``, utils.py:2501-2526)."""
    faces = faces.astype(np.int64)
    vertices = np.asarray(vertices, np.float64)
    tri = vertices[faces]
    lengths = np.concatenate(
        [
            np.linalg.norm(tri[:, 1] - tri[:, 0], axis=-1),
            np.linalg.norm(tri[:, 2] - tri[:, 1], axis=-1),
            np.linalg.norm(tri[:, 0] - tri[:, 2], axis=-1),
        ],
        axis=0,
    )
    return float(lengths.mean()), int(lengths.shape[0])


def triangle_areas(
    vertices: np.ndarray, faces: np.ndarray, normalize: bool = False
) -> np.ndarray:
    """Triangle areas, optionally with the vertices scaled by 1 / (2 · mean
    edge length) (reference ``getTrianglesArea``, utils.py:1242-1260)."""
    vertices = np.asarray(vertices, dtype=np.float64)
    if normalize:
        el, _ = average_edge_length(vertices, faces)
        vertices = vertices / (2.0 * el)
    tri = vertices[faces.astype(np.int64)]
    cp = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    return (0.5 * np.linalg.norm(cp, axis=-1)).astype(np.float32)


def edge_map(faces: np.ndarray, max_edges: int = 50):
    """Per-edge table ``e_map[E, 4] = [v1, v2, f1, f2]`` and per-vertex edge
    list ``v_e_map[V, max_edges]`` (−1 padded), built by sorting and grouping
    the 3F half-edges (reference ``getEdgeMap``, utils.py:91-183; the
    relations match, the edge order is the sort order).

    f2 is −1 for border edges; a non-manifold edge (>2 faces) keeps its first
    two faces and is counted in a warning.
    """
    faces = faces.astype(np.int64)
    fnum = faces.shape[0]
    half = np.concatenate(
        [faces[:, [0, 1]], faces[:, [0, 2]], faces[:, [1, 2]]], axis=0
    )
    half_face = np.concatenate([np.arange(fnum)] * 3, axis=0)
    key = np.sort(half, axis=1)
    order = np.lexsort((key[:, 1], key[:, 0]))
    key = key[order]
    half_face = half_face[order]

    new_edge = np.ones(key.shape[0], dtype=bool)
    new_edge[1:] = np.any(key[1:] != key[:-1], axis=1)
    edge_id = np.cumsum(new_edge) - 1
    enum = int(edge_id[-1]) + 1 if key.shape[0] else 0

    e_map_arr = np.full((enum, 4), -1, dtype=np.int32)
    e_map_arr[edge_id[new_edge], 0] = key[new_edge, 0]
    e_map_arr[edge_id[new_edge], 1] = key[new_edge, 1]

    first = np.flatnonzero(new_edge)
    counts = np.diff(np.append(first, key.shape[0]))
    e_map_arr[:, 2] = half_face[first]
    second_mask = counts >= 2
    e_map_arr[second_mask, 3] = half_face[first[second_mask] + 1]
    nonmanifold = int(np.sum(counts > 2))

    vnum = int(faces.max()) + 1 if fnum else 0
    v_e_map = np.full((vnum, max_edges), -1, dtype=np.int32)
    ev = np.concatenate([e_map_arr[:, 0], e_map_arr[:, 1]])
    ee = np.concatenate([np.arange(enum), np.arange(enum)])
    vorder = np.argsort(ev, kind="stable")
    ev, ee = ev[vorder], ee[vorder]
    vnew = np.ones(ev.shape[0], dtype=bool)
    vnew[1:] = ev[1:] != ev[:-1]
    starts = np.flatnonzero(vnew)
    rank = np.arange(ev.shape[0]) - np.repeat(starts, np.diff(np.append(starts, ev.shape[0])))
    keep = rank < max_edges
    v_e_map[ev[keep], rank[keep]] = ee[keep]

    if nonmanifold:
        warnings.warn(f"edge_map: {nonmanifold} non-manifold edges (kept first 2 faces)")
    return e_map_arr, v_e_map


def face_adjacency_edges(faces: np.ndarray):
    """Edge-shared face adjacency ``fadj[F, 4]`` (slot 0 = self, one-indexed,
    0-padded), with the edge tables of :func:`edge_map` (reference
    ``getFacesAdj``, utils.py:188-225)."""
    faces = faces.astype(np.int64)
    fnum = faces.shape[0]
    e_map_arr, v_e_map = edge_map(faces)
    fadj = np.zeros((fnum, 4), dtype=np.int32)
    fadj[:, 0] = np.arange(fnum) + 1
    interior = e_map_arr[(e_map_arr[:, 2] >= 0) & (e_map_arr[:, 3] >= 0)]
    src = np.concatenate([interior[:, 2], interior[:, 3]])
    dst = np.concatenate([interior[:, 3], interior[:, 2]])
    order = np.argsort(src, kind="stable")
    src, dst = src[order], dst[order]
    if src.size:
        new = np.ones(src.shape[0], dtype=bool)
        new[1:] = src[1:] != src[:-1]
        starts = np.flatnonzero(new)
        rank = np.arange(src.shape[0]) - np.repeat(
            starts, np.diff(np.append(starts, src.shape[0])))
        keep = rank < 3  # a triangle has ≤3 edge-neighbours (more ⇒ non-manifold)
        fadj[src[keep], rank[keep] + 1] = dst[keep] + 1
    return fadj, e_map_arr, v_e_map


def border_faces(faces: np.ndarray) -> np.ndarray:
    """1 for faces owning at least one border edge (reference
    ``getBorderFaces``, utils.py:227-240)."""
    faces = np.asarray(faces)
    e_map_arr, _ = edge_map(faces)
    out = np.zeros(faces.shape[0], dtype=np.int8)
    out[e_map_arr[(e_map_arr[:, 3] < 0) & (e_map_arr[:, 2] >= 0), 2]] = 1
    return out


def vertex_faces(faces: np.ndarray, k_v: int, vnum: int = 0) -> np.ndarray:
    """Per-vertex incident faces ``[V, k_v]`` (−1 padded), skipping fake
    faces (first vertex −1), filled in face order, each face's three corners
    in turn (reference ``getVerticesFaces``, utils.py:370-395)."""
    faces = faces.astype(np.int64)
    if vnum == 0:
        vnum = int(faces.max()) + 1
    keep = np.repeat(faces[:, 0] != -1, 3)
    fids = np.repeat(np.arange(faces.shape[0]), 3)[keep]
    vids = faces.reshape(-1)[keep]
    # a stable sort by vertex keeps the (face, corner) order within a vertex
    order = np.argsort(vids, kind="stable")
    vids, fids = vids[order], fids[order]
    v_f = np.full((vnum, k_v), -1, dtype=np.int32)
    if vids.size:
        new = np.ones(vids.shape[0], dtype=bool)
        new[1:] = vids[1:] != vids[:-1]
        starts = np.flatnonzero(new)
        rank = np.arange(vids.shape[0]) - np.repeat(
            starts, np.diff(np.append(starts, vids.shape[0])))
        fits = rank < k_v
        v_f[vids[fits], rank[fits]] = fids[fits]
    return v_f
