"""Facet-graph adjacency K-list (host).

The port's own copy of
``facet_graph_convolution_tpu/graph/adjacency.py::face_adjacency_klist``
(in C++, :mod:`.native`, where the library loaded, else NumPy), of
``vertex_adjacency_klist``, the unordered per-vertex K-list, and of
``vertex_ring_adjacency``, the ordered one-ring of the reference's
``load_mesh`` with ``bGetAdj=True``.

The graph format is the padded K-list ``fadj[F, K]``: one-indexed, slot 0 =
self, 0 = padding. Two faces are adjacent iff they share a vertex, so
edge-shared neighbours appear twice, and connections beyond K−1 are dropped
(reference ``getFacesLargeAdj``, utils.py:243-295).
"""

from __future__ import annotations

import warnings

import numpy as np


def face_adjacency_klist(
    faces: np.ndarray, k: int, return_dropped: bool = False
):
    """Vertex-shared facet adjacency K-list (reference ``getFacesLargeAdj``).

    For every vertex (ascending) and every pair (a < b) of its incident faces
    in face-index order, the reference appends b to a's list and then a to
    b's, dropping entries once a face has K−1 neighbours (utils.py:272-291).
    The same insertion sequence is reproduced with a global order key and a
    stable grouped rank. A degenerate face that repeats a vertex is recorded
    once per occurrence (the reference records a phantom face-0 neighbour).

    The C++ single-pass builder (:mod:`.native`) gives the same K-list where
    it loaded; the sort-based construction below is the fallback.
    """
    faces = np.asarray(faces, dtype=np.int64)
    fnum = faces.shape[0]
    fadj = np.zeros((fnum, k), dtype=np.int32)
    fadj[:, 0] = np.arange(fnum, dtype=np.int32) + 1
    if fnum == 0:
        return (fadj, 0) if return_dropped else fadj

    try:
        from facet_graph_convolution_torch.graph.native import face_adjacency_native

        fadj_n, dropped = face_adjacency_native(faces, int(faces.max()) + 1, k)
        if dropped:
            warnings.warn(f"face_adjacency_klist: {dropped // 2} connections dropped (K={k})")
        return (fadj_n, dropped) if return_dropped else fadj_n
    except (ImportError, OSError):
        pass

    vids = faces.reshape(-1)
    fids = np.repeat(np.arange(fnum), 3)
    order = np.lexsort((fids, vids))
    vids, fids = vids[order], fids[order]

    new = np.ones(vids.shape[0], dtype=bool)
    new[1:] = vids[1:] != vids[:-1]
    starts = np.flatnonzero(new)
    counts = np.diff(np.append(starts, vids.shape[0]))

    # all (a_idx < b_idx) incidence pairs per vertex, grouped by vertex
    # degree; the insertion key is lexicographic (vertex, pair rank,
    # which-of-the-two), the reference's double-loop order
    max_deg = int(counts.max())
    scale = np.int64(max_deg * (max_deg - 1) + 2)   # > 2 * max pairs per vertex
    src_list, dst_list, key_list = [], [], []
    for deg in np.unique(counts):
        if deg < 2:
            continue
        sel = counts == deg
        vstarts = starts[sel]                       # [nv]
        inc = fids[vstarts[:, None] + np.arange(deg)[None, :]]   # [nv, deg]
        ai, bi = np.triu_indices(deg, k=1)
        npairs = ai.shape[0]
        fa = inc[:, ai]                             # [nv, npairs]
        fb = inc[:, bi]
        pair_rank = np.broadcast_to(np.arange(npairs)[None, :], fa.shape)
        vert_ids = np.broadcast_to(vids[vstarts][:, None], fa.shape).astype(np.int64)
        base = vert_ids * scale + pair_rank * 2
        src_list.append(np.stack([fa, fb], axis=-1).reshape(-1))
        dst_list.append(np.stack([fb, fa], axis=-1).reshape(-1))
        key_list.append(np.stack([base, base + 1], axis=-1).reshape(-1))

    if not src_list:
        return (fadj, 0) if return_dropped else fadj
    src = np.concatenate(src_list)
    dst = np.concatenate(dst_list)
    keys = np.concatenate(key_list)

    # order directed insertions globally, then rank within each target face
    order = np.lexsort((keys, src))
    src_o, dst_o = src[order], dst[order]
    new_t = np.ones(src_o.shape[0], dtype=bool)
    new_t[1:] = src_o[1:] != src_o[:-1]
    tstarts = np.flatnonzero(new_t)
    rank = np.arange(src_o.shape[0]) - np.repeat(
        tstarts, np.diff(np.append(tstarts, src_o.shape[0]))
    )
    keep = rank < (k - 1)
    fadj[src_o[keep], rank[keep] + 1] = dst_o[keep] + 1
    dropped = int(np.sum(~keep))
    if dropped:
        warnings.warn(
            f"face_adjacency_klist: {dropped // 2} connections dropped (K={k})"
        )
    return (fadj, dropped) if return_dropped else fadj


def vertex_adjacency_klist(
    vertices: np.ndarray, faces: np.ndarray, k: int
) -> np.ndarray:
    """Unordered per-vertex adjacency K-list: for each face, each corner
    appends its two co-face vertices (duplicates across shared edges kept).
    The intended behaviour of the reference's ``getVerticesAdj``
    (utils.py:298-343), which is dead code there."""
    faces = np.asarray(faces, dtype=np.int64)
    vnum = np.asarray(vertices).shape[0]
    vadj = np.zeros((vnum, k), dtype=np.int32)
    vadj[:, 0] = np.arange(vnum) + 1
    # directed pairs per face corner in the reference's order
    src = faces.reshape(-1).repeat(2)
    dst = np.stack(
        [faces[:, [1, 2]], faces[:, [2, 0]], faces[:, [0, 1]]], axis=1
    ).reshape(-1)
    order = np.argsort(src, kind="stable")
    src, dst = src[order], dst[order]
    if src.size:
        new = np.ones(src.shape[0], dtype=bool)
        new[1:] = src[1:] != src[:-1]
        starts = np.flatnonzero(new)
        rank = np.arange(src.shape[0]) - np.repeat(
            starts, np.diff(np.append(starts, src.shape[0]))
        )
        keep = rank < (k - 1)
        vadj[src[keep], rank[keep] + 1] = dst[keep] + 1
    return vadj


def vertex_ring_adjacency(vertices: np.ndarray, faces: np.ndarray, k: int) -> np.ndarray:
    """Ordered per-vertex one-ring adjacency (reference ``load_mesh`` with
    ``bGetAdj=True``, utils.py:566-629): for each vertex, walk opposite edges
    of incident faces in winding order, producing a one-indexed K-list with
    slot 0 = self."""
    faces = np.asarray(faces, dtype=np.int64)
    vnum = np.asarray(vertices).shape[0]
    adj = np.zeros((vnum, k), dtype=np.int64)
    adj[:, 0] = np.arange(vnum) + 1
    # opposite edge per corner, preserving winding (utils.py:586-600)
    opp = {v: [] for v in range(vnum)}
    dropped = 0
    for f in range(faces.shape[0]):
        v1, v2, v3 = faces[f]
        for vv, e in ((v1, (v2, v3)), (v2, (v3, v1)), (v3, (v1, v2))):
            if len(opp[vv]) >= k - 1:
                dropped += 1
            else:
                opp[vv].append(e)
    for v in range(vnum):
        edges = opp[v]
        if not edges:
            continue
        first, last = edges[0]
        adj[v, 1] = first + 1
        adj[v, 2] = last + 1
        free = 3
        heads = [e[0] for e in edges]
        while free < k:
            try:
                idx = heads.index(last)
            except ValueError:
                break
            last = edges[idx][1]
            if last == first:
                break
            adj[v, free] = last + 1
            free += 1
    return adj
