"""Masked BFS patch extraction over the facet graph (host).

The port's own copy of
``facet_graph_convolution_tpu/graph/patching.py::grow_graph_patch_masked``
(in C++, :mod:`.native`, where the library loaded)
(reference ``getGraphPatch_wMask``, utils.py:1508-1696), its unmasked form
``grow_graph_patch`` (reference ``getGraphPatch``, utils.py:1417-1502) and
``grow_mesh_patch`` (reference ``getMeshPatch``, utils.py:1298-1411).
"""

from __future__ import annotations

from collections import deque
from typing import Optional, Tuple

import numpy as np


def grow_graph_patch(
    adj: np.ndarray, nodes_num: int, seed: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Grow a patch of up to ``nodes_num`` nodes (reference ``getGraphPatch``,
    utils.py:1417-1502). Returns (local one-indexed K-list, local→global map).
    """
    patch_adj, old_idx, _ = grow_graph_patch_masked(
        adj, nodes_num, seed, mask=None, min_size=0
    )
    return patch_adj, old_idx


def grow_graph_patch_masked(
    adj: np.ndarray,
    nodes_num: int,
    seed: int,
    mask: Optional[np.ndarray],
    min_size: int,
) -> Tuple[np.ndarray, np.ndarray, int]:
    """Grow a patch by BFS from ``seed`` up to ``nodes_num`` nodes.

    - Nodes with ``mask == 1`` (covered by an earlier patch) are added when
      reached but not expanded: they go to a border queue.
    - If the unmasked region runs out below ``min_size``, growth continues
      through the border queue, ignoring the mask, for receptive field.
    - Returns (local K-list one-indexed, local→global indices, next seed):
      the next seed is an unvisited, unmasked neighbour seen while completing
      the frontier's adjacency rows, or −1.

    The C++ library (:mod:`.native`) runs it where it loaded; the loop below
    is the fallback and its oracle.
    """
    try:
        from facet_graph_convolution_torch.graph.native import grow_patch_native

        return grow_patch_native(adj, nodes_num, seed, mask, min_size)
    except Exception:
        pass

    k = adj.shape[1]
    total = adj.shape[0]
    adj0 = adj.astype(np.int64) - 1          # zero-indexed, -1 = pad
    use_mask = mask if mask is not None else np.zeros(total, dtype=np.int8)

    # BFS can overshoot either limit by < K when expanding a neighbourhood
    cap = min(max(nodes_num, min_size) + k, total)
    new_idx = np.full(total, -1, dtype=np.int64)
    old_idx = np.full(cap, -1, dtype=np.int64)
    out_adj = np.full((cap, k), -1, dtype=np.int64)
    count = 0

    def add_node(g: int) -> int:
        nonlocal count
        new_idx[g] = count
        old_idx[count] = g
        count += 1
        return count - 1

    main_q: deque = deque()
    border_q: deque = deque()
    add_node(seed)
    main_q.append(seed)

    def expand(queue: deque, limit: int, respect_mask: bool) -> None:
        while count < limit and queue:
            cur = queue.popleft()
            local = new_idx[cur]
            out_adj[local, 0] = local
            for slot in range(1, k):
                nbr = adj0[cur, slot]
                if nbr == -1:
                    break
                if new_idx[nbr] == -1:
                    add_node(nbr)
                    if respect_mask and use_mask[nbr] == 1:
                        border_q.append(nbr)
                    else:
                        main_q.append(nbr)
                out_adj[local, slot] = new_idx[nbr]

    expand(main_q, nodes_num, respect_mask=True)

    if count < min_size:
        expand(border_q, min_size, respect_mask=False)
        expand(main_q, min_size, respect_mask=False)

    # complete adjacency rows of the remaining frontier without growing
    next_seed = -1
    for queue in (main_q, border_q):
        while queue:
            cur = queue.popleft()
            local = new_idx[cur]
            out_adj[local, 0] = local
            fill = 1
            for slot in range(1, k):
                nbr = adj0[cur, slot]
                if nbr == -1:
                    break
                if new_idx[nbr] == -1:
                    if use_mask[nbr] == 0:
                        next_seed = int(nbr)
                    continue
                out_adj[local, fill] = new_idx[nbr]
                fill += 1

    out_adj = out_adj[:count] + 1            # back to one-indexed, pad → 0
    return out_adj.astype(np.int32), old_idx[:count], next_seed


def grow_mesh_patch(
    vertices: np.ndarray,
    faces: np.ndarray,
    adj: np.ndarray,
    face_num: int,
    seed: int,
):
    """A BFS face patch with its own vertices (reference ``getMeshPatch``):
    returns (patch vertices, patch faces over them, patch K-list, vertex
    local→global, face local→global). Vertices are numbered in order of
    first appearance over the patch's faces, as the reference's walk
    (utils.py:1319-1342) numbers them."""
    patch_adj, f_old, _ = grow_graph_patch_masked(adj, face_num, seed, None, 0)
    faces = np.asarray(faces, dtype=np.int64)
    sel_faces = faces[f_old]
    uniq, first_pos = np.unique(sel_faces.reshape(-1), return_index=True)
    v_old = uniq[np.argsort(first_pos)]
    v_new = np.full(int(faces.max()) + 1, -1, dtype=np.int64)
    v_new[v_old] = np.arange(v_old.shape[0])
    patch_vertices = np.asarray(vertices)[v_old]
    return patch_vertices, v_new[sel_faces].astype(np.int32), patch_adj, v_old, f_old
