"""Mesh and point-cloud I/O and the colored visualization meshes (host).

The port's own copy of ``facet_graph_convolution_tpu/geometry/obj_io.py``
(its OBJ parser in C++, :mod:`..graph.native`, where the library loaded):
reference ``load_mesh`` (utils.py:476-639), ``write_mesh``
(utils.py:659-697), ``write_xyz`` / ``write_coff`` (utils.py:643-657),
``load_off_PC`` / ``load_coff_PC`` (utils.py:419-473), ``getColoredMesh``
(utils.py:1973-1999), ``getHeatMapMesh`` (utils.py:1946-1970),
``getHeatMapColor`` (utils.py:2002-2029).
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


def write_xyz(points: np.ndarray, path: str) -> None:
    """Plain xyz point dump (reference ``write_xyz``)."""
    np.savetxt(path, np.asarray(points))


def write_coff(points_with_colors: np.ndarray, path: str) -> None:
    """Colored point cloud in COFF format (reference ``write_coff``). Columns
    x y z r g b, colors in [0, 1] (scaled to 255) or already in [0, 255]."""
    vec = np.array(points_with_colors, dtype=np.float64, copy=True)
    if vec[:, 3:6].max() <= 1.0:
        vec[:, 3:6] *= 255.0
    with open(path, "w") as fh:
        fh.write("COFF\n")
        fh.write(f"{vec.shape[0]} 0 0\n")
        for row in vec:
            fh.write("%f %f %f %d %d %d\n" % tuple(row[:6]))


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


def heatmap_mesh(
    vertices: np.ndarray, faces: np.ndarray, heat: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """:func:`colored_mesh` with a scalar heat a face as its gray color
    (reference ``getHeatMapMesh``)."""
    heat = np.asarray(heat, np.float32).reshape(-1, 1)
    return colored_mesh(vertices, faces, np.tile(heat, (1, 3)))


def heatmap_colors(values: np.ndarray) -> np.ndarray:
    """Scalars in [0, 1] on the blue → cyan → green → yellow → red ramp
    (reference ``getHeatMapColor``)."""
    v = np.clip(np.asarray(values, np.float32), 0.0, 1.0)
    anchors = np.array(
        [
            [0.0, 0.0, 1.0],
            [0.0, 1.0, 1.0],
            [0.0, 1.0, 0.0],
            [1.0, 1.0, 0.0],
            [1.0, 0.0, 0.0],
        ],
        dtype=np.float32,
    )
    seg = np.minimum((v * 4).astype(np.int32), 3)
    coef = v * 4 - seg
    lo = anchors[seg]
    hi = anchors[seg + 1]
    return lo + coef[:, None] * (hi - lo)


def load_off_pc(path: str) -> np.ndarray:
    """Point cloud of an OFF file: header, counts, then x y z rows read to
    the end (reference ``load_off_PC``)."""
    with open(path, "r") as fh:
        header = fh.readline().strip()
        if header != "OFF":
            raise ValueError(f"bad OFF header: {header!r}")
        fh.readline()
        pts = [line.split()[0:3] for line in fh if line.strip()]
    return np.asarray(pts, dtype=np.float32)


def load_coff_pc(path: str):
    """Colored point cloud of a COFF file, ``(points [N, 3], colors [N, 3])``
    (reference ``load_coff_PC``)."""
    with open(path, "r") as fh:
        header = fh.readline().strip()
        if header != "COFF":
            raise ValueError(f"bad COFF header: {header!r}")
        fh.readline()
        rows = [line.split() for line in fh if line.strip()]
    arr = np.asarray(rows, dtype=np.float32)
    return arr[:, 0:3], arr[:, 3:6]


def normals_to_colors(normals: np.ndarray) -> np.ndarray:
    """Map unit normals to RGB in [0,1] (reference ``infer.py:108-109``)."""
    return (normalize_rows(np.asarray(normals, np.float32)) + 1.0) / 2.0
