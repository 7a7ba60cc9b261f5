"""Wavefront OBJ I/O and the normal-colored visualization mesh (host).

The port's own copy of ``facet_graph_convolution_tpu/geometry/obj_io.py``
(its parser in C++, :mod:`..graph.native`, where the library loaded):
reference ``load_mesh``
(utils.py:476-639), ``write_mesh`` (utils.py:659-697), ``getColoredMesh``
(utils.py:1973-1999).
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

from facet_graph_convolution_torch.geometry.mesh_math import (
    compute_vertex_normals,
    normalize_rows,
)


def load_obj(path: str, filename: Optional[str] = None):
    """Load an OBJ mesh: vertices, triangulated faces, vertex normals.

    As reference ``load_mesh``: polygons are fan-triangulated, faces are
    uint16 below 65536 vertices and uint32 above, vertex normals are
    recomputed from the geometry ('vn' lines are ignored), and duplicate
    vertices are not merged.

    Returns ``(vertices[V,3] float32, faces[F,3] uint16|uint32,
    normals[V,3] float32)``.
    """
    full = os.path.join(path, filename) if filename is not None else path
    try:    # the C++ parser (graph.native), the same output as the loop below
        from facet_graph_convolution_torch.graph.native import parse_obj_native

        verts, tris = parse_obj_native(full)
        dtype = np.uint16 if verts.shape[0] < 65536 else np.uint32
        return verts, tris.astype(dtype), compute_vertex_normals(verts, tris)
    except (ImportError, OSError):
        pass
    vertices = []
    face_idx = []
    with open(full, "r") as fh:
        for line in fh:
            if not line or line[0] == "#":
                continue
            values = line.split()
            if not values:
                continue
            tag = values[0]
            if tag == "v":
                vertices.append(values[1:4])
            elif tag == "f":
                # fan triangulation of n-gons, keeping reference ordering
                idx = [int(v.split("/")[0]) - 1 for v in values[1:]]
                for tri in range(len(idx) - 2):
                    face_idx.extend((idx[0], idx[tri + 1], idx[tri + 2]))

    verts = np.asarray(vertices, dtype=np.float32)
    nb_vert = verts.shape[0]
    dtype = np.uint16 if nb_vert < 65536 else np.uint32
    faces = np.asarray(face_idx, dtype=np.int64).reshape(-1, 3).astype(dtype)
    normals = compute_vertex_normals(verts, faces.astype(np.int64))
    return verts, faces, normals


def write_obj(vertices: np.ndarray, faces: np.ndarray, path: str) -> None:
    """Write an OBJ mesh, skipping fake faces.

    As reference ``write_mesh``: vertices may carry extra columns (e.g. RGB
    after xyz); a face row ``[0, 0, *]`` (the coarsening's fake-face
    sentinel) ends the face list and rows of ``[-1, -1, *]`` are skipped.
    """
    vertices = np.asarray(vertices)
    if vertices.ndim == 3:
        vertices = vertices.reshape(-1, vertices.shape[-1])
    faces = np.asarray(faces, dtype=np.int64)

    with open(path, "w") as fh:
        fmt = " ".join(["%.6f"] * vertices.shape[1])
        for row in vertices:
            fh.write("v " + fmt % tuple(row) + " \n")
        one_indexed = faces + 1
        for row in one_indexed:
            if row[0] == 1 and row[1] == 1:
                break  # fake-face sentinel: stop (utils.py:688-690)
            if row[0] == 0 and row[1] == 0:
                continue  # -1 padded: skip (utils.py:691-692)
            fh.write("f %d %d %d \n" % (row[0], row[1], row[2]))


def colored_mesh(
    vertices: np.ndarray, faces: np.ndarray, face_colors: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """Explode a mesh into per-face triangles with an RGB color appended to
    every corner vertex (reference ``getColoredMesh``). Fake faces (index −1)
    pick up a prepended zero vertex like the reference."""
    faces = np.asarray(faces, dtype=np.int64) + 1
    verts = np.concatenate(
        [np.zeros((1, 3), dtype=np.float32), np.asarray(vertices, np.float32)], axis=0
    )
    corner = verts[faces]                                     # [F, 3, 3]
    colors = np.tile(np.asarray(face_colors, np.float32)[:, None, :], (1, 3, 1))
    new_v = np.concatenate([corner, colors], axis=-1).reshape(-1, 6)
    new_f = np.arange(3 * faces.shape[0]).reshape(-1, 3)
    return new_v, new_f


def normals_to_colors(normals: np.ndarray) -> np.ndarray:
    """Map unit normals to RGB in [0,1] (reference ``infer.py:108-109``)."""
    return (normalize_rows(np.asarray(normals, np.float32)) + 1.0) / 2.0
