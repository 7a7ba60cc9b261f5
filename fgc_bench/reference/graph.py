"""The facet graph of a training patch and its coarser levels, worked out
from the mesh's faces and the node order that the program chose.

The program cuts a mesh into patches, coarsens each by a randomized
matching and orders its nodes as a binary tree (the two nodes merged at a
coarsening step sit side by side, fake nodes fill the tree). Those choices
are the program's; this module takes them as given (the global face of
each tree position, -1 for a fake node) and checks them
(:func:`check_tree_order`), then derives everything the network reads:

- level 0: two faces of the patch are neighbours iff they share a vertex
  (each neighbour once, and the face itself);
- level l: node i is the cluster of tree positions [i·4^l, (i+1)·4^l);
  two clusters are neighbours iff some of their faces are.

The program's graph lists at most ``k_faces - 1`` neighbours a face;
:func:`check_k_list` refuses a mesh where the vertex-sharing list of some
face would have been cut, since the cut depends on an insertion order this
module does not model.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np
import scipy.sparse


@dataclass
class LevelGraph:
    """One level: ``nbr`` [N, K] int64 neighbour positions with the node
    itself in slot 0 and ``N`` (a zero row) in unused slots; ``real`` [N]
    bool, whether the node holds a face of the mesh."""

    nbr: np.ndarray
    real: np.ndarray

    @property
    def num_nodes(self) -> int:
        return self.nbr.shape[0]

    @property
    def live_slots(self) -> int:
        """Slots that hold a node, over the real nodes (the conv's work)."""
        return int(np.sum(self.nbr[self.real] < self.num_nodes))


def check_k_list(faces: np.ndarray, k_faces: int) -> None:
    """Refuse a mesh in which some face's vertex-sharing list (a face once
    for each shared vertex) has more than ``k_faces - 1`` entries."""
    faces = np.asarray(faces, np.int64)
    deg = np.bincount(faces.reshape(-1))
    raw = (deg[faces] - 1).sum(axis=1)
    if raw.max() > k_faces - 1:
        raise ValueError(f"a face has {int(raw.max())} vertex-sharing entries, more than "
                         f"k_faces - 1 = {k_faces - 1}: the reference does not model the cut")


def _incidence(tree_faces: np.ndarray, faces: np.ndarray) -> scipy.sparse.csr_matrix:
    """[N, V] incidence of the real tree positions with their vertices."""
    pos = np.flatnonzero(tree_faces >= 0)
    verts = np.asarray(faces, np.int64)[tree_faces[pos]]
    rows = np.repeat(pos, 3)
    n_v = int(np.asarray(faces).max()) + 1
    return scipy.sparse.csr_matrix((np.ones(rows.size, np.float64), (rows, verts.reshape(-1))),
                                   shape=(tree_faces.size, n_v))


def _cluster(adj: scipy.sparse.csr_matrix, group: int) -> scipy.sparse.csr_matrix:
    """The graph of consecutive groups of ``group`` nodes."""
    n = adj.shape[0]
    p = scipy.sparse.csr_matrix((np.ones(n), (np.arange(n), np.arange(n) // group)),
                                shape=(n, n // group))
    return (p.T @ adj @ p).tocsr()


def _neighbour_table(adj: scipy.sparse.csr_matrix) -> np.ndarray:
    """[N, K] slot table: the node itself, then its neighbours (the
    pattern of ``adj`` off the diagonal), then N."""
    adj = adj.tocsr().copy()
    adj.setdiag(0)
    adj.eliminate_zeros()
    n = adj.shape[0]
    counts = np.diff(adj.indptr)
    k = 1 + (int(counts.max()) if n else 0)
    table = np.full((n, k), n, np.int64)
    table[:, 0] = np.arange(n)
    rows = np.repeat(np.arange(n), counts)
    rank = np.arange(adj.indices.size) - np.repeat(adj.indptr[:-1], counts)
    table[rows, 1 + rank] = adj.indices
    return table


def check_tree_order(tree_faces: np.ndarray, num_faces: int, adj0: scipy.sparse.csr_matrix,
                     levels: int, steps: int) -> None:
    """The program's node order is a valid coarsening pyramid: every face
    of the patch at one position, the node count a multiple of the tree's
    fan-in, and at each of the ``(levels - 1) · steps`` matchings a pair of
    non-empty clusters merged only where the two are neighbours."""
    real = tree_faces[tree_faces >= 0]
    if real.size != np.unique(real).size or (real.size and real.max() >= num_faces):
        raise ValueError("tree order: a face twice or out of range")
    n = tree_faces.size
    if n % (2 ** ((levels - 1) * steps)):
        raise ValueError(f"tree order: {n} nodes, not a multiple of the tree's fan-in")
    filled = (tree_faces >= 0).astype(np.int64)
    adj = adj0.tocsr()
    for step in range(1, (levels - 1) * steps + 1):
        left, right = filled[0::2] > 0, filled[1::2] > 0
        both = np.flatnonzero(left & right)
        linked = np.asarray(adj[2 * both, 2 * both + 1]).reshape(-1) > 0
        if not linked.all():
            raise ValueError(f"tree order: step {step} merges {int((~linked).sum())} pairs of "
                             "clusters that are not neighbours")
        filled = filled[0::2] + filled[1::2]
        adj = _cluster(adj, 2)


def patch_levels(tree_faces: np.ndarray, faces: np.ndarray, levels: int, steps: int,
                 k_faces: int) -> List[LevelGraph]:
    """The level graphs of a patch whose tree position t holds the mesh
    face ``tree_faces[t]`` (-1: a fake node), after checking the order."""
    tree_faces = np.asarray(tree_faces, np.int64)
    inc = _incidence(tree_faces, faces)
    adj0 = (inc @ inc.T).tocsr()
    check_tree_order(tree_faces, np.asarray(faces).shape[0], adj0, levels, steps)
    out, adj, real = [], adj0, tree_faces >= 0
    fan = 2 ** steps
    for level in range(levels):
        table = _neighbour_table(adj)
        if table.shape[1] > k_faces:
            raise ValueError(f"level {level}: {table.shape[1] - 1} neighbours, past "
                             f"k_faces - 1 = {k_faces - 1}")
        out.append(LevelGraph(table, real))
        if level + 1 < levels:
            adj = _cluster(adj, fan)
            real = real.reshape(-1, fan).any(axis=1)
    return out
