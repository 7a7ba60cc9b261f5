"""Frozen copy of the port's synthetic meshes (``icosphere``,
``subdivide_mesh``, ``torus``, ``chamfered_box``, ``add_vertex_noise``, and
``average_edge_length`` that the noise reads), so that the benchmark's
inputs stay the same whatever later changes make to the program's copy.
Copied from ``facet_graph_convolution_torch/data/synthetic.py`` and
``geometry/mesh_math.py`` unchanged.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


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


def icosphere(subdiv: int = 3) -> Tuple[np.ndarray, np.ndarray]:
    t = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.array(
        [
            [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
            [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
            [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
        ],
        dtype=np.float64,
    )
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = np.array(
        [
            [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
            [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
            [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
            [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
        ],
        dtype=np.int64,
    )
    for _ in range(subdiv):
        verts, faces = subdivide_mesh(verts, faces, project_unit=True)
    return verts.astype(np.float32), faces.astype(np.int32)


def subdivide_mesh(
    verts: np.ndarray, faces: np.ndarray, project_unit: bool = False
) -> Tuple[np.ndarray, np.ndarray]:
    """One 4:1 midpoint (Loop-topology) subdivision step, fully vectorized —
    no per-face Python loop, so multi-million-facet meshes build in seconds.
    Each edge gets one midpoint vertex (deduped across faces); with
    ``project_unit`` midpoints are renormalized onto the unit sphere
    (icosphere refinement)."""
    verts = np.asarray(verts, dtype=np.float64)
    faces = np.asarray(faces, dtype=np.int64)
    nv = verts.shape[0]
    nf = faces.shape[0]
    # the three edges of every face, canonical (lo, hi) keying for dedup
    e = np.concatenate(
        [faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]], axis=0
    )
    lo = e.min(axis=1)
    hi = e.max(axis=1)
    key = lo * nv + hi
    uniq, inv = np.unique(key, return_inverse=True)
    mid = (verts[uniq // nv] + verts[uniq % nv]) * 0.5
    if project_unit:
        mid /= np.linalg.norm(mid, axis=1, keepdims=True)
    ab = inv[:nf] + nv
    bc = inv[nf : 2 * nf] + nv
    ca = inv[2 * nf :] + nv
    a, b, c = faces[:, 0], faces[:, 1], faces[:, 2]
    new_faces = np.concatenate(
        [
            np.stack([a, ab, ca], axis=1),
            np.stack([b, bc, ab], axis=1),
            np.stack([c, ca, bc], axis=1),
            np.stack([ab, bc, ca], axis=1),
        ],
        axis=0,
    )
    return np.concatenate([verts, mid], axis=0), new_faces.astype(np.int64)


def torus(
    major: float = 1.0, minor: float = 0.4, nu: int = 48, nv: int = 24
) -> Tuple[np.ndarray, np.ndarray]:
    u = np.linspace(0, 2 * np.pi, nu, endpoint=False)
    v = np.linspace(0, 2 * np.pi, nv, endpoint=False)
    uu, vv = np.meshgrid(u, v, indexing="ij")
    x = (major + minor * np.cos(vv)) * np.cos(uu)
    y = (major + minor * np.cos(vv)) * np.sin(uu)
    z = minor * np.sin(vv)
    verts = np.stack([x, y, z], axis=-1).reshape(-1, 3).astype(np.float32)

    faces = []
    for i in range(nu):
        for j in range(nv):
            a = i * nv + j
            b = ((i + 1) % nu) * nv + j
            c = ((i + 1) % nu) * nv + (j + 1) % nv
            d = i * nv + (j + 1) % nv
            faces += [[a, b, c], [a, c, d]]
    return verts, np.asarray(faces, dtype=np.int32)


def chamfered_box(
    n: int = 12, size: float = 1.0, chamfer: float = 0.12
) -> Tuple[np.ndarray, np.ndarray]:
    """Cube with 45° chamfer strips along every edge and corner triangles —
    the canonical sharp-feature CAD test shape (three crease dihedrals: 135°
    face-to-chamfer, corner junctions). Watertight; ``n`` subdivides each
    face grid and each chamfer strip lengthwise."""
    s, c = float(size), float(chamfer)
    verts: list = []
    vid: dict = {}

    def vert(p):
        key = (round(float(p[0]), 9), round(float(p[1]), 9), round(float(p[2]), 9))
        if key not in vid:
            vid[key] = len(verts)
            verts.append([key[0], key[1], key[2]])
        return vid[key]

    faces: list = []

    def quad(p00, p10, p11, p01):
        a, b, d, e = vert(p00), vert(p10), vert(p11), vert(p01)
        faces.extend([[a, b, d], [a, d, e]])

    def grid(origin, du, dv, nu, nv):
        origin, du, dv = map(np.asarray, (origin, du, dv))
        for i in range(nu):
            for j in range(nv):
                quad(
                    origin + du * (i / nu) + dv * (j / nv),
                    origin + du * ((i + 1) / nu) + dv * (j / nv),
                    origin + du * ((i + 1) / nu) + dv * ((j + 1) / nv),
                    origin + du * (i / nu) + dv * ((j + 1) / nv),
                )

    lo, hi = c, s - c
    span = np.array([hi - lo, 0, 0]), np.array([0, hi - lo, 0]), np.array([0, 0, hi - lo])
    ex, ey, ez = span
    # 6 shrunken face squares (outward winding)
    grid([lo, lo, s], ex, ey, n, n)               # top (+z)
    grid([lo, lo, 0], ey, ex, n, n)               # bottom (−z)
    grid([s, lo, lo], ey, ez, n, n)               # +x
    grid([0, lo, lo], ez, ey, n, n)               # −x
    grid([lo, s, lo], ez, ex, n, n)               # +y
    grid([lo, 0, lo], ex, ez, n, n)               # −y

    # 12 chamfer strips: each connects a face-square border to its
    # neighbouring face square, subdivided n× lengthwise, 1 across
    def strip(a0, a1, b0, b1):
        a0, a1, b0, b1 = map(np.asarray, (a0, a1, b0, b1))
        for i in range(n):
            t0, t1 = i / n, (i + 1) / n
            quad(a0 + (a1 - a0) * t0, a0 + (a1 - a0) * t1,
                 b0 + (b1 - b0) * t1, b0 + (b1 - b0) * t0)

    # top edges (z = s plane ↔ side planes)
    strip([lo, hi, s], [hi, hi, s], [lo, s, hi], [hi, s, hi])      # top↔+y
    strip([hi, lo, s], [lo, lo, s], [hi, 0, hi], [lo, 0, hi])      # top↔−y
    strip([hi, hi, s], [hi, lo, s], [s, hi, hi], [s, lo, hi])      # top↔+x
    strip([lo, lo, s], [lo, hi, s], [0, lo, hi], [0, hi, hi])      # top↔−x
    # bottom edges
    strip([hi, hi, 0], [lo, hi, 0], [hi, s, lo], [lo, s, lo])      # bottom↔+y
    strip([lo, lo, 0], [hi, lo, 0], [lo, 0, lo], [hi, 0, lo])      # bottom↔−y
    strip([hi, lo, 0], [hi, hi, 0], [s, lo, lo], [s, hi, lo])      # bottom↔+x
    strip([lo, hi, 0], [lo, lo, 0], [0, hi, lo], [0, lo, lo])      # bottom↔−x
    # vertical edges
    strip([s, hi, lo], [s, hi, hi], [hi, s, lo], [hi, s, hi])      # +x↔+y
    strip([s, lo, hi], [s, lo, lo], [hi, 0, hi], [hi, 0, lo])      # +x↔−y
    strip([0, hi, hi], [0, hi, lo], [lo, s, hi], [lo, s, lo])      # −x↔+y
    strip([0, lo, lo], [0, lo, hi], [lo, 0, lo], [lo, 0, hi])      # −x↔−y

    # 8 corner triangles (one per cube corner, outward winding)
    def tri(p0, p1, p2):
        faces.append([vert(p0), vert(p1), vert(p2)])

    tri([hi, hi, s], [s, hi, hi], [hi, s, hi])
    tri([lo, hi, s], [lo, s, hi], [0, hi, hi])
    tri([hi, lo, s], [hi, 0, hi], [s, lo, hi])
    tri([lo, lo, s], [0, lo, hi], [lo, 0, hi])
    tri([hi, hi, 0], [hi, s, lo], [s, hi, lo])
    tri([lo, hi, 0], [0, hi, lo], [lo, s, lo])
    tri([hi, lo, 0], [s, lo, lo], [hi, 0, lo])
    tri([lo, lo, 0], [lo, 0, lo], [0, lo, lo])

    return (np.asarray(verts, dtype=np.float32),
            np.asarray(faces, dtype=np.int32))


def add_vertex_noise(
    vertices: np.ndarray,
    faces: np.ndarray,
    level: float = 0.2,
    rng: Optional[np.random.Generator] = None,
) -> np.ndarray:
    """Gaussian vertex noise with σ = level · average-edge-length (the Wang
    et al. convention the reference dataset uses; n1/n2/n3 ≈ 0.1/0.2/0.3)."""
    rng = rng or np.random.default_rng()
    el, _ = average_edge_length(vertices, faces)
    noise = rng.normal(scale=level * el, size=vertices.shape)
    return (vertices + noise).astype(np.float32)
