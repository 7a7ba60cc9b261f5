"""K-list ↔ sparse adjacency conversion and the conv's host tables (NumPy).

The port's own copy of the functions of
``facet_graph_convolution_tpu/graph/convert.py`` that the inference path
needs, and of its public helpers (reference ``listToSparse``
utils.py:1718-1750, ``listToSparseWNormals`` utils.py:1753-1796,
``sparseToList`` utils.py:1799-1827, ``inv_perm`` utils.py:1830-1835), plus
:func:`slot_major_arrays`, the tables of the kernel configuration
(``facet_graph_convolution_tpu/ops/pallas_conv.py::slot_major_arrays``),
:func:`lane_tables`, those of the vertex solver's node-minor gathers, and
:func:`windowed_lane_tables`, the per-slab tables of the windowed conv
(``ops/windowed_conv.py``) at HBM scale.
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


def lane_tables_pre(
    adj_nbr: np.ndarray, num_sources: Optional[int] = None
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """:func:`lane_tables` with their index math done once on the host:
    ``(adjT0, validF, idxT, validT)`` (the JAX package's
    ``lane_tables_pre``).

    - ``adjT0`` [K, N] int32: the zero-based forward table clamped at 0
      (``max(adjT − 1, 0)``: a pad slot reads row 0);
    - ``validF`` [K, N] bool: the forward's live slots (``adjT > 0``);
    - ``idxT`` [S, N_src] int32 / ``validT`` [S, N_src] bool: the
      zero-based backward slot map over the flat slots ``k·N + n`` and its
      live entries."""
    adjT, adjT_t = lane_tables(adj_nbr, num_sources)
    adjT0 = np.maximum(adjT - 1, 0).astype(np.int32)
    validF = adjT > 0
    idxT = np.maximum(adjT_t - 1, 0).astype(np.int32)
    validT = adjT_t > 0
    return adjT0, validF, idxT, validT


class WindowedLaneTables:
    """Per-slab windowed gather tables of an RCM-ordered level (the JAX
    package's ``WindowedLaneTables``, array for array).

    On a locality-ordered pyramid (``coarsen_graph(reorder="rcm")``) every
    node's neighbours lie in a narrow band of indices, so the output rows
    are cut into ``block``-row slabs, each of which reads a ``window`` of
    source rows. The slabs start every ``block`` rows; the LAST one starts
    at ``N − block`` and so overlaps its predecessor (both give the same
    values on the overlap). ``window`` / ``bwd_window`` are the largest
    source spans of any slab, shared by every slab.

    - forward: slot k of row ``out_starts[b] + j`` reads source row
      ``win_starts[b] + relT[b, k, j]`` (pad slots read a clamped row of
      the window: a consumer zeroes them, through ``mult_rows`` or
      ``validF``);
    - backward: source row ``out_starts[b] + j`` sums the cotangents of the
      flat slots ``k·N + n`` given by ``relS[b, s, j] = k·bwd_window +
      (n − bwd_starts[b])``, where ``validS[b, s, j]``.

    Halo-extended sources (a shard of a partitioned level, ``num_sources >
    num_out``): the H halo rows sit after the N owned ones, outside any
    band. Slots that read them carry a pack of their own: ``not_tail``
    zeroes the window's clamped row for them, ``tailT`` (one-indexed into
    the halo rows, 0 elsewhere) reads them, and the backward sums the
    cotangents of each halo row's flat slots ``tailS`` [S, H] where
    ``tailV``. With ``num_sources == num_out`` the pack is absent."""

    def __init__(self, block, window, bwd_window, out_starts, win_starts,
                 relT, validF, bwd_starts, relS, validS, num_sources,
                 num_out, not_tail=None, tailT=None, tailS=None, tailV=None):
        self.block = int(block)
        self.window = int(window)
        self.bwd_window = int(bwd_window)
        self.out_starts = out_starts
        self.win_starts = win_starts
        self.relT = relT
        self.validF = validF
        self.bwd_starts = bwd_starts
        self.relS = relS
        self.validS = validS
        self.num_sources = int(num_sources)
        self.num_out = int(num_out)
        self.not_tail = not_tail
        self.tailT = tailT
        self.tailS = tailS
        self.tailV = tailV

    @property
    def has_tail(self):
        return self.num_sources > self.num_out

    @property
    def arrays(self):
        """The tables in their fixed order: 7, or 11 with the halo pack."""
        base = (self.out_starts, self.win_starts, self.relT, self.validF,
                self.bwd_starts, self.relS, self.validS)
        if self.has_tail:
            return base + (self.not_tail, self.tailT, self.tailS, self.tailV)
        return base

    @property
    def geometry(self):
        """``(block, window, bwd_window, num_sources, num_out)``."""
        return (self.block, self.window, self.bwd_window,
                self.num_sources, self.num_out)


def _round_up(x: int, align: int) -> int:
    return ((int(x) + align - 1) // align) * align


def windowed_lane_tables(
    adj_nbr: np.ndarray,
    num_sources: Optional[int] = None,
    block: int = 32768,
    align: int = 512,
    max_window_ratio: float = 8.0,
    window: Optional[int] = None,
    bwd_window: Optional[int] = None,
    tables: Optional[Tuple[np.ndarray, np.ndarray]] = None,
) -> Optional[WindowedLaneTables]:
    """:class:`WindowedLaneTables` of the one-indexed neighbours-only K-list
    ``adj_nbr`` [N, K] (the JAX package's ``windowed_lane_tables``, array
    for array).

    ``num_sources > N`` builds the halo pack: entries up to N ride the
    windows, larger ones read the halo rows. ``tables`` = the one-indexed
    ``(adjT [K, N], adjT_t [S, N_src])`` of :func:`lane_tables` (a
    partition's ``lane_adj[d]`` / ``lane_adj_t[d]``) is used in place of
    deriving them from ``adj_nbr``. ``window`` / ``bwd_window`` force a span
    at least that wide (one geometry for several meshes).

    Returns None where windows cannot help: fewer than two slabs, or no
    locality among the owned entries (a span past ``max_window_ratio ×
    block``, as a pyramid without ``reorder="rcm"`` gives)."""
    if tables is not None:
        adjT, adjT_t = tables
        n = adjT.shape[1]
    else:
        n = adj_nbr.shape[0]
    nsrc = n if num_sources is None else num_sources
    if n < 2 * block or nsrc < n:
        return None
    if tables is not None:
        adjT0 = np.maximum(adjT - 1, 0).astype(np.int32)
        validF = adjT > 0
        idxT = np.maximum(adjT_t - 1, 0).astype(np.int32)
        validT = adjT_t > 0
    else:
        adjT0, validF, idxT, validT = lane_tables_pre(adj_nbr, num_sources)
    k, _ = adjT0.shape
    # the backward's flat slots k·N + n are int32
    assert k * n < 2**31, (k, n)
    s = idxT.shape[0]
    owned = validF & (adjT0 < n)                 # the banded (non-halo) entries

    out_starts = np.arange(0, n - block + 1, block, dtype=np.int32)
    if int(out_starts[-1]) != n - block:
        out_starts = np.append(out_starts, np.int32(n - block))
    nblk = out_starts.shape[0]

    def spans(idx2d, valid2d):
        """Each slab's least and greatest live index."""
        lo = np.full(nblk, 0, np.int64)
        hi = np.full(nblk, 0, np.int64)
        for b, st in enumerate(out_starts):
            sub = idx2d[:, st: st + block]
            va = valid2d[:, st: st + block]
            if va.any():
                vals = sub[va]
                lo[b], hi[b] = int(vals.min()), int(vals.max())
        return lo, hi

    f_lo, f_hi = spans(adjT0, owned)
    needed = min(_round_up(int((f_hi - f_lo).max()) + 1, align), n)
    if needed > max_window_ratio * block:
        return None
    window = min(max(needed, window or 0), n)
    win_starts = np.clip(f_lo, 0, n - window).astype(np.int32)

    # the backward's spans over the n of the flat slots k·N + n of the owned
    # source rows (the halo rows' slots ride tailS)
    k_arr = (idxT // n).astype(np.int64)
    n_arr = (idxT % n).astype(np.int64)
    b_lo, b_hi = spans(n_arr[:, :n], validT[:, :n])
    bwd_needed = min(_round_up(int((b_hi - b_lo).max()) + 1, align), n)
    if bwd_needed > max_window_ratio * block:
        return None
    bwd_window = min(max(bwd_needed, bwd_window or 0), n)
    bwd_starts = np.clip(b_lo, 0, n - bwd_window).astype(np.int32)

    relT = np.empty((nblk, k, block), np.int32)
    vF = np.empty((nblk, k, block), bool)
    relS = np.empty((nblk, s, block), np.int32)
    vS = np.empty((nblk, s, block), bool)
    for b, st in enumerate(out_starts):
        cols = slice(int(st), int(st) + block)
        relT[b] = np.clip(adjT0[:, cols] - win_starts[b], 0, window - 1)
        vF[b] = owned[:, cols]
        flat = k_arr[:, cols] * bwd_window + (n_arr[:, cols] - bwd_starts[b])
        relS[b] = np.clip(flat, 0, k * bwd_window - 1)
        vS[b] = validT[:, cols]
    kw = {}
    if nsrc > n:
        not_tail = np.empty((nblk, k, block), bool)
        tailT = np.empty((nblk, k, block), np.int32)
        tail_idx = np.where(owned | ~validF, 0, adjT0 - n + 1)   # one-indexed
        for b, st in enumerate(out_starts):
            cols = slice(int(st), int(st) + block)
            not_tail[b] = owned[:, cols] | ~validF[:, cols]
            tailT[b] = tail_idx[:, cols]
        kw = dict(
            not_tail=not_tail, tailT=tailT,
            tailS=np.ascontiguousarray(idxT[:, n:]),
            tailV=np.ascontiguousarray(validT[:, n:]),
        )
    return WindowedLaneTables(
        block=block, window=window, bwd_window=bwd_window,
        out_starts=out_starts, win_starts=win_starts, relT=relT, validF=vF,
        bwd_starts=bwd_starts, relS=relS, validS=vS,
        num_sources=nsrc, num_out=n, **kw,
    )


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
