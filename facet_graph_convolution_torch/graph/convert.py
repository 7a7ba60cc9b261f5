"""K-list ↔ sparse adjacency conversion and the conv's host tables (NumPy).

The port's own copy of the functions of
``facet_graph_convolution_tpu/graph/convert.py`` that the inference path
needs, and of its public helpers (reference ``listToSparse``
utils.py:1718-1750, ``listToSparseWNormals`` utils.py:1753-1796,
``sparseToList`` utils.py:1799-1827, ``inv_perm`` utils.py:1830-1835), plus
:func:`slot_major_arrays`, the tables of the kernel configuration
(``facet_graph_convolution_tpu/ops/pallas_conv.py::slot_major_arrays``), and
:func:`lane_tables`, those of the vertex solver's node-minor gathers.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import scipy.sparse


def _klist_edges(adj: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Directed edges (row, col) of a one-indexed K-list, skipping slot 0
    (self) and the 0 pads."""
    n, k = adj.shape
    neigh = adj[:, 1:].astype(np.int64) - 1
    valid = neigh >= 0
    rows = np.broadcast_to(np.arange(n)[:, None], neigh.shape)[valid]
    cols = neigh[valid]
    return rows, cols


def klist_degrees(adj: np.ndarray) -> np.ndarray:
    """True neighbour count per node: the non-zero entries, self slot
    included (``tf.count_nonzero(adj, 2)`` in the reference's conv,
    model.py:436)."""
    return np.count_nonzero(adj, axis=-1)


def klist_to_coo(adj: np.ndarray, positions: np.ndarray) -> scipy.sparse.coo_matrix:
    """Position-weighted conversion: ``w_ij = 1/(1000·|c_i − c_j|)``
    (reference ``listToSparse``)."""
    n = adj.shape[0]
    rows, cols = _klist_edges(adj)
    d = np.linalg.norm(positions[cols] - positions[rows], axis=-1)
    values = (1.0 / (1000.0 * d)).astype(np.float32)
    return scipy.sparse.coo_matrix((values, (rows, cols)), shape=(n, n))


def klist_to_coo_normal_weighted(
    adj: np.ndarray, positions: np.ndarray, normals: np.ndarray,
    sigma: float = 0.001,
) -> scipy.sparse.coo_matrix:
    """Normal+position weighted conversion used before coarsening:
    ``w_ij = max(⟨n_i, n_j⟩ · exp(−|c_i−c_j|²/(2σ²)), 0.001)`` (reference
    ``listToSparseWNormals``)."""
    n = adj.shape[0]
    rows, cols = _klist_edges(adj)
    dp = np.sum(normals[rows] * normals[cols], axis=-1)
    d2 = np.sum((positions[cols] - positions[rows]) ** 2, axis=-1)
    values = np.maximum(dp * np.exp(-d2 / (2.0 * sigma * sigma)), 0.001)
    return scipy.sparse.coo_matrix(
        (values.astype(np.float32), (rows, cols)), shape=(n, n)
    )


def coo_to_klist(adj: scipy.sparse.spmatrix, k: int) -> Tuple[np.ndarray, bool]:
    """Sparse matrix → one-indexed K-list with slot 0 = self; returns
    ``(klist, has_saturated)``, saturated when some node had ≥ K neighbours
    and entries were dropped (reference ``sparseToList``). Entries follow COO
    storage order with the diagonal skipped."""
    n = adj.shape[0]
    out = np.zeros((n, k), dtype=np.int32)
    out[:, 0] = np.arange(n, dtype=np.int32) + 1
    coo = adj.tocoo()
    rows, cols = coo.row.astype(np.int64), coo.col.astype(np.int64)
    off = rows != cols
    rows, cols = rows[off], cols[off]
    order = np.argsort(rows, kind="stable")
    rows, cols = rows[order], cols[order]
    if rows.size == 0:
        return out, False
    new = np.ones(rows.shape[0], dtype=bool)
    new[1:] = rows[1:] != rows[:-1]
    starts = np.flatnonzero(new)
    rank = np.arange(rows.shape[0]) - np.repeat(
        starts, np.diff(np.append(starts, rows.shape[0]))
    )
    keep = rank < (k - 1)
    out[rows[keep], rank[keep] + 1] = cols[keep] + 1
    return out, bool(np.any(~keep))


def dedupe_klist(adj: np.ndarray):
    """Collapse duplicate entries per row into (unique K-list, multiplicity).

    The facet K-list lists edge-shared neighbours twice; their slots carry
    identical assignment weights, so ``Σ_slots q·x = Σ_unique mult·q·x``
    exactly.

    Returns ``(adj_u [N, K'], mult [N, K'] float32)`` with K' the maximum
    distinct row count; ``mult`` is 0 on padding slots.
    """
    n, k = adj.shape
    adj32 = np.ascontiguousarray(adj, dtype=np.int32)
    # sort each row's entries (zeros first), count runs of equal values
    order = np.argsort(adj32, axis=1, kind="stable")
    sorted_adj = np.take_along_axis(adj32, order, axis=1)
    new = np.ones_like(sorted_adj, dtype=np.int8)
    np.not_equal(sorted_adj[:, 1:], sorted_adj[:, :-1], out=new[:, 1:].view(bool))
    valid = sorted_adj > 0
    new &= valid
    rank = np.cumsum(new, axis=1, dtype=np.int32) - 1
    k_u = int(rank.max()) + 1 if n else 1
    adj_u = np.zeros((n, k_u), dtype=np.int32)
    rows = np.broadcast_to(np.arange(n, dtype=np.int64)[:, None], adj32.shape)
    rv, kv = rows[valid], rank[valid]
    # duplicates are runs of equal values at equal (row, rank), so a plain
    # fancy-index assignment (last write wins) is exact
    adj_u[rv, kv] = sorted_adj[valid]
    flat = rv * k_u + kv
    mult = np.bincount(flat, minlength=n * k_u).reshape(n, k_u).astype(np.float32)
    return adj_u, mult


def split_self_klist(
    adj_u: np.ndarray, mult: np.ndarray, row_ids: Optional[np.ndarray] = None
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Split the self slot out of a deduped K-list: the self contribution
    needs no gather, its features are the row's own.

    Returns ``(adj_nbr [N, K''], mult_nbr [N, K''], self_mult [N])``: the
    compacted neighbours-only one-indexed K-list, its multiplicities, and the
    self multiplicity. ``row_ids`` names the node of each row (default: row
    i is node i).
    """
    n, _ = adj_u.shape
    self_col = (np.arange(n, dtype=np.int64) if row_ids is None
                else np.asarray(row_ids, dtype=np.int64)) + 1
    is_self = adj_u.astype(np.int64) == self_col[:, None]
    self_mult = np.sum(mult * is_self, axis=1).astype(np.float32)
    nbr = np.where(is_self, 0, adj_u)
    m_n = np.where(is_self, 0.0, mult).astype(np.float32)
    # compact non-zero entries left (stable), trim to the max non-self count
    order = np.argsort(nbr == 0, axis=1, kind="stable")
    nbr = np.take_along_axis(nbr, order, axis=1)
    m_n = np.take_along_axis(m_n, order, axis=1)
    k_n = max(int(np.count_nonzero(nbr, axis=1).max()), 1) if n else 1
    return nbr[:, :k_n].astype(np.int32), m_n[:, :k_n], self_mult


def fused_mult_rows(mult_nbr: np.ndarray, self_mult: np.ndarray) -> np.ndarray:
    """Per-slot multiplier ``[K+1, N]``, slot 0 = self: multiplicity ×
    1/degree, 0 on padding slots. Folding the degree normalizer in is exact,
    both factors being static per graph."""
    deg = mult_nbr.sum(axis=1) + self_mult
    inv_deg = np.where(deg > 0, 1.0 / np.maximum(deg, 1.0), 0.0)
    rows = np.concatenate([self_mult[:, None], mult_nbr], axis=1) * inv_deg[:, None]
    return np.ascontiguousarray(rows.T.astype(np.float32))


def transpose_adjacency(adj: np.ndarray, num_targets: Optional[int] = None) -> np.ndarray:
    """Transpose slot map for a scatter-free gather backward: for the
    one-indexed ``adj`` [N, K], ``adj_t[j]`` lists the one-indexed flat slots
    ``i*K + k`` with ``adj[i, k] == j+1`` (0 = pad). ``num_targets`` defaults
    to N."""
    n, k = adj.shape
    if num_targets is None:
        num_targets = n
    flat = adj.reshape(-1).astype(np.int32)          # one-indexed targets
    slots = np.arange(n * k, dtype=np.int32)
    valid = flat > 0
    targets = flat[valid] - 1
    slots = slots[valid]
    order = np.argsort(targets, kind="stable")
    targets, slots = targets[order], slots[order]
    if targets.size == 0:
        return np.zeros((num_targets, 1), dtype=np.int32)
    new = np.ones(targets.shape[0], dtype=bool)
    new[1:] = targets[1:] != targets[:-1]
    starts = np.flatnonzero(new)
    counts = np.diff(np.append(starts, targets.shape[0]))
    k_t = int(counts.max())
    rank = np.arange(targets.shape[0], dtype=np.int64) - np.repeat(starts, counts)
    adj_t = np.zeros((num_targets, k_t), dtype=np.int32)
    adj_t[targets, rank] = slots + 1
    return adj_t


def lane_tables(
    adj_nbr: np.ndarray, num_sources: Optional[int] = None
) -> Tuple[np.ndarray, np.ndarray]:
    """Tables of the node-minor (lane-axis) gather of a one-indexed
    neighbours-only K-list ``adj_nbr`` [N, K]: ``(adjT [K, N], adjT_t [K_t,
    num_sources])``, the transposed K-list and its transpose slot map over
    the flat slots ``k·N + n`` (one-indexed, 0 = pad), both node-axis minor
    (``facet_graph_convolution_tpu/graph/convert.py::lane_tables``).
    ``num_sources`` defaults to N."""
    adj_t = np.ascontiguousarray(adj_nbr.T.astype(np.int32))
    # transpose_adjacency flattens its [K, N] input row-major, so the flat
    # slots it lists are k·N + n
    adj_t_t = transpose_adjacency(
        adj_t, num_targets=adj_nbr.shape[0] if num_sources is None else num_sources)
    return adj_t, np.ascontiguousarray(adj_t_t.T)


def slot_major_tables(
    adj_nbr: np.ndarray, mult_nbr: np.ndarray, self_mult: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """The forward's host tables of the facet-conv kernel from the self-split
    deduped K-list (:func:`split_self_klist`): ``(adj_sm [K, N'], mult_rows
    [K+1, N', 1])``, the first and last tables of :func:`slot_major_arrays`,
    without the transpose map that only the backward reads.

    ``adj_sm`` is the slot-major one-indexed neighbour list and ``mult_rows``
    the fused multiplicity/degree rows. The node axis is padded to N' (a
    multiple of 256, or of 8 below 256 nodes); padded nodes have all-pad
    adjacency and zero mult rows, so their outputs are zero rows.
    """
    adj_sm = np.ascontiguousarray(adj_nbr.T.astype(np.int32))
    n = adj_nbr.shape[0]
    rows = fused_mult_rows(mult_nbr, self_mult)                # [K+1, N]
    target = -(-n // 256) * 256 if n >= 256 else -(-n // 8) * 8
    if target != n:
        adj_sm = np.pad(adj_sm, ((0, 0), (0, target - n)))
        rows = np.pad(rows, ((0, 0), (0, target - n)))
    return adj_sm, rows[:, :, None].astype(np.float32)


def slot_major_arrays(
    adj_nbr: np.ndarray, mult_nbr: np.ndarray, self_mult: np.ndarray
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Host tables of the facet-conv kernel, forward and backward:
    ``(adj_sm [K, N'], adj_t_sm, mult_rows [K+1, N', 1])``, those of
    :func:`slot_major_tables` and ``adj_t_sm``, the transpose map of
    ``adj_sm`` over the flat slots ``k·N' + n`` (for the backward), built
    on the padded table: its flat slots are strided by N'.
    """
    adj_sm, rows = slot_major_tables(adj_nbr, mult_nbr, self_mult)
    adj_t_sm = transpose_adjacency(adj_sm, num_targets=adj_sm.shape[1])
    return adj_sm, adj_t_sm, rows


def level_tables(adj: np.ndarray, width: Optional[int] = None,
                 block: Optional[int] = None) -> Tuple[np.ndarray, np.ndarray]:
    """:func:`slot_major_tables` of a raw one-indexed K-list ``adj`` [N, K]
    (slot 0 = self, 0 = pad), deduped and self-split first.

    ``block`` (default N) reads ``adj`` as N / block blocks of ``block``
    rows, each a K-list over its own nodes: block b's entries are offset by
    b·block after the dedupe, its pads stay 0, so the tables are those of
    the block-diagonal graph, no edge crossing from one block to another.
    ``width`` pads the neighbour slots to that many (pad slots, zero mult
    rows), so that every batch of one bucket gets tables of one shape; it
    must be at least the K-list's most distinct non-self neighbours of a
    node (K − 1 always is). A node whose row is its self slot alone (a fake
    or padding node) skips the dedupe: its tables are one self slot."""
    adj = np.asarray(adj)
    n = adj.shape[0]
    local = np.arange(n, dtype=np.int64) % (block or max(n, 1))
    alone = (adj[:, 0] == local + 1) & ~adj[:, 1:].any(axis=1)
    rows = np.flatnonzero(~alone)
    nbr, mult, self_rows = split_self_klist(*dedupe_klist(adj[rows]), row_ids=local[rows])
    k = nbr.shape[1] if width is None else width
    if k < nbr.shape[1]:
        raise ValueError(f"width {width} < the {nbr.shape[1]} neighbour slots this K-list needs")
    adj_nbr = np.zeros((n, k), np.int32)
    mult_nbr = np.zeros((n, k), np.float32)
    self_mult = np.ones(n, np.float32)
    adj_nbr[rows, :nbr.shape[1]] = np.where(nbr > 0, nbr + (rows - local[rows])[:, None], 0)
    mult_nbr[rows, :nbr.shape[1]] = mult
    self_mult[rows] = self_rows
    return slot_major_tables(adj_nbr, mult_nbr, self_mult)


def batched_level_tables(klists_by_level, group: int, widths=None):
    """The forward's tables of B patches padded to one bucket, as one graph:
    per level, ``(adj_sm, mult_rows)`` of :func:`level_tables` over the B
    K-lists ``klists_by_level[l]`` [B, N_l, K_l] as blocks of N_l rows
    (``widths[l]`` neighbour slots when given). The node axis is padded once,
    after the last patch.

    The network pools and unpools groups of ``group`` contiguous nodes; the
    blocks line up with them only where N_l = group · N_{l+1} at every level
    (a bucket is a multiple of the tree's groups), which is checked: then
    patch b's nodes b·N_l .. (b+1)·N_l − 1 pool into its own nodes at the
    next level and no group mixes two patches."""
    sizes = [np.shape(k)[1] for k in klists_by_level]
    batch = np.shape(klists_by_level[0])[0]
    for lvl in range(len(sizes) - 1):
        if sizes[lvl] != group * sizes[lvl + 1]:
            raise ValueError(f"level sizes {sizes} are not a tree of {group}-node groups: "
                             "the batch's blocks would not pool into their own patches")
    if any(np.shape(k)[0] != batch for k in klists_by_level):
        raise ValueError("every level needs the same batch")
    return [level_tables(np.reshape(k, (-1, np.shape(k)[2])),
                         None if widths is None else widths[lvl], block=np.shape(k)[1])
            for lvl, k in enumerate(klists_by_level)]


def invert_permutation(perm: np.ndarray) -> np.ndarray:
    """Inverse permutation, sized to cover max(len, max+1) like the reference
    ``inv_perm``."""
    perm = np.asarray(perm, dtype=np.int64)
    size = max(perm.shape[0], int(perm.max()) + 1) if perm.size else 0
    inv = np.zeros(size, dtype=np.int64)
    inv[perm] = np.arange(perm.shape[0])
    return inv
