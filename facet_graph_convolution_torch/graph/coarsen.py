"""Graclus heavy-edge coarsening with binary-tree node ordering (host).

The port's own copy of ``facet_graph_convolution_tpu/graph/coarsen.py``,
itself the semantics of the reference's ``lib/coarsening.py`` (from
mdeff/cnn_graph); the matching pass runs in C++ (:mod:`.native`) where the
library loaded:

- :func:`graclus_levels`: multi-level randomized heavy-edge matching, 3
  trials per level keeping the best total association;
- :func:`binary_tree_permutation`: node orders in which the two children of
  every coarse node are index-adjacent, padded with fake singletons so each
  level is a perfect binary tree;
- :func:`permute_data` / :func:`permute_adjacency`: signals and
  adjacencies into tree order;
- :func:`coarsen_graph`: the pipeline.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import scipy.sparse
from scipy.sparse.csgraph import reverse_cuthill_mckee


def _match_one_level(
    rr: np.ndarray,
    cc: np.ndarray,
    vv: np.ndarray,
    rid: np.ndarray,
    weights: np.ndarray,
    num_nodes: int,
) -> Tuple[np.ndarray, float]:
    """One pass of greedy heavy-edge matching (reference ``metis_one_level``,
    lib/coarsening.py:135-192): nodes are visited in ``rid`` order, and an
    unmarked node pairs with the unmarked neighbour maximizing
    ``w_edge · (1/deg_i + 1/deg_j)``. Returns (cluster id per node, total
    association). The C++ library (:mod:`.native`) runs it where it loaded,
    with the inverse weights in float64 (its docstring says how that
    changes the pyramid); the loop below is the fallback."""
    try:
        from facet_graph_convolution_torch.graph.native import match_one_level_native

        return match_one_level_native(rr, cc, vv, rid, weights, num_nodes)
    except Exception:
        pass

    nnz = rr.shape[0]
    marked = np.zeros(num_nodes, dtype=bool)
    rowstart = np.zeros(num_nodes, dtype=np.int64)
    rowlength = np.zeros(num_nodes, dtype=np.int64)
    cluster_id = np.zeros(num_nodes, dtype=np.int32)

    # rr is sorted ascending: CSR-style row extents
    if nnz:
        np.add.at(rowlength, rr, 1)
        rowstart[1:] = np.cumsum(rowlength)[:-1]

    inv_w = np.zeros(num_nodes, dtype=np.float64)
    nz = weights != 0
    inv_w[nz] = 1.0 / weights[nz]

    total_assoc = 0.0
    cluster_count = 0
    for tid in rid:
        if marked[tid]:
            continue
        marked[tid] = True
        rs = rowstart[tid]
        length = rowlength[tid]
        best = -1
        wmax = 0.0
        for jj in range(length):
            nid = cc[rs + jj]
            if marked[nid]:
                continue
            tval = vv[rs + jj] * (inv_w[tid] + inv_w[nid])
            if tval > wmax:
                wmax = tval
                best = nid
        cluster_id[tid] = cluster_count
        if best > -1:
            cluster_id[best] = cluster_count
            marked[best] = True
        total_assoc += wmax
        cluster_count += 1
    return cluster_id, total_assoc


def graclus_levels(
    W: scipy.sparse.spmatrix,
    levels: int,
    rng: Optional[np.random.Generator] = None,
    trials: int = 3,
) -> Tuple[List[scipy.sparse.spmatrix], List[np.ndarray]]:
    """Multi-level Graclus coarsening (reference ``metis``,
    lib/coarsening.py:34-131). Level 0 uses degree-minus-diagonal weights;
    later levels use plain degree and visit nodes in ascending-degree order.
    Each level runs ``trials`` random matchings and keeps the best."""
    rng = rng or np.random.default_rng()
    N = W.shape[0]
    rid = rng.permutation(N)
    parents: List[np.ndarray] = []
    graphs: List[scipy.sparse.spmatrix] = [W]
    degree = np.asarray(W.sum(axis=0)).squeeze() - W.diagonal()

    for _ in range(levels):
        weights = np.asarray(degree).squeeze()
        idx_row, idx_col, val = scipy.sparse.find(W)
        perm = np.argsort(idx_row, kind="stable")
        rr, cc, vv = idx_row[perm], idx_col[perm], val[perm]

        best_assoc = 0.0
        cluster_id = None
        for _trial in range(trials):
            cur, assoc = _match_one_level(rr, cc, vv, rid, weights, N)
            if assoc > best_assoc or cluster_id is None:
                cluster_id, best_assoc = cur, assoc
            rid = rng.permutation(N)
        parents.append(cluster_id)

        nrr = cluster_id[rr]
        ncc = cluster_id[cc]
        n_new = int(cluster_id.max()) + 1
        W = scipy.sparse.csr_matrix((vv, (nrr, ncc)), shape=(n_new, n_new))
        W.eliminate_zeros()
        graphs.append(W)
        N = n_new

        degree = np.asarray(W.sum(axis=0)).squeeze()
        rid = np.argsort(degree)
    return graphs, parents


def binary_tree_permutation(
    parents: Sequence[np.ndarray],
    coarse_order: Optional[Sequence[int]] = None,
) -> List[List[int]]:
    """Per-level node orders in which the two children of each coarse node
    sit at consecutive fine indices, inserting fake singletons so every level
    is a perfect binary pyramid (reference ``compute_perm``,
    lib/coarsening.py:194-241). ``coarse_order`` replaces the identity order
    of the coarsest level; finer levels follow by subtree expansion."""
    indices: List[List[int]] = []
    if len(parents) == 0:
        return indices
    m_last = int(max(parents[-1])) + 1
    if coarse_order is not None:
        order0 = [int(i) for i in coarse_order]
        if sorted(order0) != list(range(m_last)):
            raise ValueError("coarse_order is not a permutation of the coarsest level")
        indices.append(order0)
    else:
        indices.append(list(range(m_last)))

    for parent in parents[::-1]:
        pool_singletons = len(parent)
        layer: List[int] = []
        # children grouped per coarse node, in coarse-node order
        order = np.argsort(parent, kind="stable")
        sorted_parent = parent[order]
        bounds = np.searchsorted(sorted_parent, np.arange(int(parent.max()) + 2))
        for i in indices[-1]:
            if i < len(bounds) - 1:
                children = list(order[bounds[i]:bounds[i + 1]])
            else:
                children = []
            if len(children) > 2:
                raise ValueError("a coarse node has more than two children")
            if len(children) == 1:      # pair the singleton with a fake node
                children.append(pool_singletons)
                pool_singletons += 1
            elif len(children) == 0:    # fake parent gets two fake children
                children.extend([pool_singletons, pool_singletons + 1])
                pool_singletons += 2
            layer.extend(int(c) for c in children)
        indices.append(layer)

    for i, layer in enumerate(indices):
        if sorted(layer) != list(range(m_last * (2 ** i))):
            raise AssertionError(f"tree level {i} is not a perfect-binary permutation")
    return indices[::-1]


def permute_data(x: np.ndarray, indices: Optional[Sequence[int]]) -> np.ndarray:
    """Reorder (and zero-pad) node signals ``x`` [N, C] into tree order
    (reference ``perm_data``, lib/coarsening.py:246-267)."""
    if indices is None:
        return x
    indices = np.asarray(indices, dtype=np.int64)
    n, c = x.shape
    out = np.zeros((len(indices), c), dtype=x.dtype)
    real = indices < n
    out[real] = x[indices[real]]
    return out


def permute_adjacency(
    A: scipy.sparse.spmatrix, indices: Optional[Sequence[int]]
) -> scipy.sparse.coo_matrix:
    """Pad the adjacency with fake isolated nodes and permute rows/cols into
    tree order (reference ``perm_adjacency``, lib/coarsening.py:269-296)."""
    if indices is None:
        return A.tocoo()
    indices = np.asarray(indices, dtype=np.int64)
    m_new = len(indices)
    A = A.tocoo()
    perm = np.argsort(indices)
    row = perm[A.row]
    col = perm[A.col]
    return scipy.sparse.coo_matrix((A.data, (row, col)), shape=(m_new, m_new))


def coarsen_graph(
    A: scipy.sparse.spmatrix,
    levels: int,
    rng: Optional[np.random.Generator] = None,
    self_connections: bool = False,
    reorder: Optional[str] = None,
) -> Tuple[List[scipy.sparse.csr_matrix], Optional[np.ndarray]]:
    """Coarsen ``A`` for ``levels`` levels; returns the per-level adjacencies
    (tree-ordered, zero-diagonal, fake nodes padded) and the level-0
    new→old permutation (reference ``coarsen``, lib/coarsening.py:5-31).

    ``reorder="rcm"`` orders the coarsest level by reverse Cuthill-McKee
    before the binary-tree expansion, so contiguous fine-index blocks are
    spatially compact; ``None`` keeps the reference's identity order."""
    graphs, parents = graclus_levels(A, levels, rng=rng)
    coarse_order = None
    if reorder == "rcm" and levels > 0:
        m_last = int(max(parents[-1])) + 1
        g = graphs[-1].tocsr()[:m_last, :m_last]
        coarse_order = np.asarray(
            reverse_cuthill_mckee(g, symmetric_mode=True), dtype=np.int64
        )
    elif reorder is not None and reorder != "rcm":
        raise ValueError(f"unknown reorder {reorder!r} (use 'rcm' or None)")
    perms = binary_tree_permutation(parents, coarse_order=coarse_order)

    out: List[scipy.sparse.csr_matrix] = []
    for i, g in enumerate(graphs):
        if not self_connections:
            g = g.tocoo()
            g.setdiag(0)
        # with a locality reorder the coarsest level's permutation is not the
        # identity, so every level (coarsest included) is permuted
        if i < len(perms):
            g = permute_adjacency(g, perms[i])
        g = g.tocsr()
        g.eliminate_zeros()
        out.append(g)
    new_to_old = np.asarray(perms[0], dtype=np.int64) if levels > 0 else None
    return out, new_to_old
