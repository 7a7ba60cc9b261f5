"""Sharded vertex solvers over partitioned vertices and faces (the port's
counterpart of ``facet_graph_convolution_tpu/parallel/vertex_halo.py``).

After the halo-exchange U-Net predicts the facet normals of a whole mesh
(:mod:`.halo`), the vertex positions are refined with the VERTEX space (and,
for the multi-scale solvers, the FACE space) partitioned into D contiguous
blocks, one a rank; each exchange is :func:`.halo.halo_extend` over the
rings of a :class:`VertexPartition`.

- :func:`sharded_update_positions_edges` — the edge-map Taubin solver
  (reference ``update_position2``, train.py:1467-1557): each iteration
  exchanges the boundary vertices' positions before the edge-endpoint
  gathers; the per-vertex face normals are static, gathered once on the
  host. Pad slots carry zero normals, so their contribution vanishes
  exactly as in the single-device solver.
- :func:`sharded_update_positions_multiscale` — the multi-scale solver
  (reference ``update_position_MS``): every iteration runs two exchanges,
  the vertex positions to the face shards (corners, centroids and, at
  scales above 0, the zero-ignoring pool, K4 on the card) and the per-face
  scalar t = ⟨n_f, c_f⟩ back to the vertex shards. Fake faces ride the
  zero-row gathers on both sides.
- :func:`multiscale_solver_local` / :func:`multiscale_solver_local_operator`
  — the differentiable bodies of sharded vertex training (naive and
  operator form) over one rank's tables
  (:func:`prepare_multiscale_solver`, :func:`prepare_multiscale_solver_operator`).
  Every gather takes its table's transpose map, so the backward is the
  scatter-free gather-sum of :func:`..ops.gather.gather_slots`, and the
  exchanges' backward is :func:`.halo.halo_extend`'s: the same bits on
  every run.
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from facet_graph_convolution_torch.graph.convert import dedupe_klist, transpose_adjacency
from facet_graph_convolution_torch.ops.gather import gather_neighbors, gather_slots
from facet_graph_convolution_torch.ops.normalization import dot_last
from facet_graph_convolution_torch.ops.pooling import tree_pool
from facet_graph_convolution_torch.ops.vertex_update import face_center_klists
from facet_graph_convolution_torch.parallel.halo import (
    ExchangeTables,
    exchange_tables,
    gather_rows,
    halo_extend,
    shard_rows,
)
from facet_graph_convolution_torch.parallel.mesh import GraphGroup, make_mesh


@dataclasses.dataclass
class VertexPartition:
    """Partition of a per-vertex gather map ``idx [V, ...]`` (0-indexed
    global vertex ids, −1 = pad) into D blocks with halo exchange tables —
    the structure of :class:`parallel.halo.LevelPartition` generalized to an
    arbitrary-shaped index map."""

    num_vertices: int
    block: int
    offsets: Tuple[int, ...]
    local_idx: np.ndarray            # [D, block, ...] one-indexed into ext, 0 = pad
    send_idx: np.ndarray             # [D, num_off, H]
    recv_mask: np.ndarray            # [D, num_off, H]
    halo_size: int
    pad_rows: int                    # rows appended so D divides V


def partition_index_map(
    idx: np.ndarray,
    num_shards: int,
    producer_count: Optional[int] = None,
) -> VertexPartition:
    """Build halo tables for a per-row gather map.

    Rows of ``idx`` are the CONSUMERS (padded to a multiple of D with inert
    −1 rows); the ids reference the PRODUCER space, by default the same set
    as the consumers. Pass ``producer_count`` (must be divisible by D) for
    cross-space gathers — e.g. faces gathering vertex positions: each device
    then holds consumer block d AND producer block d, and ``send_idx``
    indexes the *producer* block."""
    v = idx.shape[0]
    pad_rows = (-v) % num_shards
    if pad_rows:
        pad = np.full((pad_rows,) + idx.shape[1:], -1, dtype=idx.dtype)
        idx = np.concatenate([idx, pad], axis=0)
    v_tot = idx.shape[0]
    cons_block = v_tot // num_shards
    if producer_count is None:
        producer_count = v_tot
    assert producer_count % num_shards == 0, (producer_count, num_shards)
    block = producer_count // num_shards          # producer block
    flat = idx.reshape(v_tot, -1).astype(np.int64)
    owner = lambda g: g // block

    requested, offsets_set = [], set()
    for s in range(num_shards):
        rows = flat[s * cons_block : (s + 1) * cons_block]
        valid = rows[rows >= 0]
        remote = np.unique(valid[(valid < s * block) | (valid >= (s + 1) * block)])
        groups = {}
        owners = owner(remote)
        # remote is sorted ⇒ owners non-decreasing: split at owner boundaries
        bounds = np.searchsorted(owners, np.arange(num_shards + 1))
        for o in np.unique(owners):
            o = int(o)
            groups[o - s] = remote[bounds[o] : bounds[o + 1]]
            offsets_set.add(o - s)
        requested.append(groups)

    offsets = tuple(sorted(offsets_set, key=lambda d: (abs(d), d)))
    halo = max(
        [len(requested[s].get(d, ())) for s in range(num_shards) for d in offsets]
        or [0]
    )
    halo = max(halo, 1)
    num_off = max(len(offsets), 1)

    send_idx = np.zeros((num_shards, num_off, halo), dtype=np.int32)
    recv_mask = np.zeros((num_shards, num_off, halo), dtype=np.float32)
    local_idx = np.zeros((num_shards, cons_block, flat.shape[1]), dtype=np.int32)

    # dense producer-id → extended-slot remap reused across shards (each
    # shard refills exactly the ids it will read) — replaces the per-remote
    # -entry dict loop, same vectorization as parallel.halo._partition_level
    slot_map = np.zeros(producer_count, dtype=np.int64)
    for s in range(num_shards):
        for j, d in enumerate(offsets):
            req = requested[s].get(d, np.zeros(0, np.int64))
            slot_map[req] = block + j * halo + np.arange(len(req))
            recv_mask[s, j, : len(req)] = 1.0
        for j, d in enumerate(offsets):
            src = s + d
            if 0 <= src < num_shards:
                req = requested[s].get(d, np.zeros(0, np.int64))
                send_idx[src, j, : len(req)] = req - src * block

        rows = flat[s * cons_block : (s + 1) * cons_block]
        out = np.zeros_like(rows)
        own = (rows >= s * block) & (rows < (s + 1) * block)
        out[own] = rows[own] - s * block + 1
        remote_mask = (rows >= 0) & ~own
        out[remote_mask] = slot_map[rows[remote_mask]] + 1
        local_idx[s] = out

    return VertexPartition(
        num_vertices=v,
        block=block,
        offsets=offsets,
        local_idx=local_idx.reshape((num_shards, cons_block) + idx.shape[1:]),
        send_idx=send_idx,
        recv_mask=recv_mask,
        halo_size=halo,
        pad_rows=pad_rows,
    )



def sharded_update_positions_edges(
    x: np.ndarray,
    face_normals: np.ndarray,
    edge_map: np.ndarray,
    v_edges: np.ndarray,
    group: Optional[GraphGroup] = None,
    iter_num: int = 60,
    lmbd: Union[float, str] = 1.0 / 18.0,
    adaptive_tol: float = 0.0,
    trust: float = 0.0,
    device: str = "cuda",
) -> np.ndarray:
    """:func:`..ops.vertex_update.update_positions_edges` over the group's
    ranks (JAX ``sharded_update_positions_edges``): identical math,
    vertex-partitioned, with a boundary exchange each iteration.
    ``x`` [V, 3], ``face_normals`` [F, 3], ``edge_map`` [E, 4] and
    ``v_edges`` [V, maxE] are host arrays of the whole mesh, alike on every
    rank. ``lmbd="degree"`` (per-vertex 1/(3·deg)), ``adaptive_tol`` (stop
    when the residual improves by less than that share of itself, decided
    on the residual summed over the ranks, so every rank stops at the same
    iteration) and ``trust`` (a vertex's displacement capped at ``trust`` ×
    its initial RMS violation, shard-local) are the single-device solver's.
    The all-reduced residual sums in another order than one device's, so
    where an iteration's improvement lands within rounding of
    ``adaptive_tol`` the two may stop one iteration apart. Returns the
    refined [V, 3] positions on every rank. ``group`` defaults to
    :func:`..mesh.make_mesh` on ``device``."""
    group = group or make_mesh(device)
    n_dev, dev = group.size, group.device
    v = x.shape[0]

    # host-side setup mirroring the single-device solver
    v_edges1 = v_edges.astype(np.int64) + 1
    emap = edge_map.astype(np.int64) + np.array([[0, 0, 1, 1]])
    emap = np.concatenate([np.zeros((1, 4), np.int64), emap], axis=0)
    fn_pad = np.concatenate(
        [np.zeros((1, 3), np.float32), np.asarray(face_normals, np.float32)], axis=0)
    n_edges = emap[v_edges1]                      # [V, maxE, 4]
    # pad edges resolve to vertex 0 in the single-device solver; their
    # normals are zero either way, so mark them −1 (a zero row) to keep the
    # halo small — the contribution is zero in both
    is_pad = v_edges[..., None] < 0
    v_pair_idx = np.where(np.broadcast_to(is_pad, n_edges[..., 0:2].shape), -1,
                          n_edges[..., 0:2])
    n_f = fn_pad[n_edges[..., 2:4]]               # [V, maxE, 2, 3] static

    part = partition_index_map(v_pair_idx, n_dev)
    pad_rows = part.pad_rows
    x_padded = np.concatenate([np.asarray(x, np.float32), np.zeros((pad_rows, 3), np.float32)])
    n_f_padded = np.concatenate(
        [n_f.astype(np.float32), np.zeros((pad_rows,) + n_f.shape[1:], np.float32)])
    if isinstance(lmbd, str):
        if lmbd != "degree":
            raise ValueError(f"unknown lmbd mode {lmbd!r}")
        deg = np.sum(np.asarray(v_edges) >= 0, axis=1).astype(np.float32)
        lam = np.where(deg > 0, 1.0 / (3.0 * np.maximum(deg, 1.0)), 0.0).astype(np.float32)
        lmb = shard_rows(np.concatenate([lam, np.zeros(pad_rows, np.float32)])[:, None], group)
    else:
        lmb = torch.full((part.block, 1), float(lmbd), dtype=torch.float32, device=dev)

    idx = torch.as_tensor(part.local_idx[group.rank], dtype=torch.int64, device=dev)
    n_fb = shard_rows(n_f_padded, group)          # [block, maxE, 2, 3]
    ex = exchange_tables(part.offsets, part.send_idx, part.recv_mask, None, None, group.rank,
                         part.block, dev)

    def proj(x_loc):
        x_ext = halo_extend(x_loc, ex, group)
        ext_pad = torch.cat([x_ext.new_zeros(1, 3), x_ext], dim=0)
        e_vec = ext_pad[idx] - x_loc[:, None, None, :]   # [block, maxE, 2, 3]
        return dot_last(n_fb, torch.sum(e_vec, dim=2)[:, :, None, :])

    def residual(p):
        r = torch.sum(torch.square(p))
        if n_dev > 1:
            dist.all_reduce(r, group=group.group)
        return r

    with torch.no_grad():
        x_loc = shard_rows(x_padded, group)
        x0 = x_loc
        if trust > 0.0:
            p0 = proj(x_loc)
            cnt = torch.clamp(2.0 * torch.sum((idx[..., 0] > 0).to(x_loc.dtype), dim=-1),
                              min=1.0)
            cap = trust * torch.sqrt(torch.sum(torch.square(p0), dim=(1, 2)) / cnt)

        def step(x_loc):
            p = proj(x_loc)
            x_new = x_loc + lmb * torch.sum(n_fb * p[..., None], dim=(1, 2))
            if trust > 0.0:
                d = x_new - x0
                dn = torch.linalg.norm(d, dim=1, keepdim=True)
                x_new = x0 + d * torch.clamp(cap[:, None] / torch.clamp(dn, min=1e-12), max=1.0)
            return x_new, p

        if adaptive_tol > 0.0:
            # the JAX while_loop's carry: the residuals of the last two iterates
            r_pp = torch.tensor(1e30, dtype=torch.float32, device=dev)
            r_p = r_pp * 0.09
            i = 0
            while i < iter_num and bool((r_pp - r_p) > adaptive_tol * r_p):
                x_loc, p = step(x_loc)
                r_pp, r_p = r_p, residual(p)
                i += 1
        else:
            for _ in range(iter_num):
                x_loc = step(x_loc)[0]
        out = gather_rows(x_loc, group)
    return out.cpu().numpy()[:v]


# ---------------------------------------------------------------------------
# One rank's tensors of a VertexPartition, and the gather through its halo
# ---------------------------------------------------------------------------

class IndexMapTables(NamedTuple):
    """One rank's tensors of a :class:`VertexPartition`: ``idx`` [rows,
    ...] one-indexed into the rank's halo-extended producer rows (0 = a
    zero row), ``idx_t`` [ext, K_t] the transpose map of ``idx`` flattened
    to [rows, K] (for the gather's scatter-free backward; None where no
    gradient is taken) and the rank's :class:`.halo.ExchangeTables`."""

    idx: torch.Tensor
    idx_t: Optional[torch.Tensor]
    exchange: ExchangeTables


def index_map_tables(part: VertexPartition, rank: int, device,
                     transpose: bool = True) -> IndexMapTables:
    """:class:`IndexMapTables` of rank ``rank`` on ``device``; ``transpose``
    builds the backward's transpose map."""
    local = part.local_idx[rank]
    flat = local.reshape(local.shape[0], -1)
    ext = part.block + len(part.offsets) * part.halo_size
    idx_t = (torch.as_tensor(transpose_adjacency(flat, num_targets=ext), device=device)
             if transpose else None)
    return IndexMapTables(
        torch.as_tensor(np.ascontiguousarray(local), dtype=torch.int64, device=device), idx_t,
        exchange_tables(part.offsets, part.send_idx, part.recv_mask, None, None, rank,
                        part.block, device))


def _exchange_rows(data: torch.Tensor, tables: IndexMapTables, group: GraphGroup) -> torch.Tensor:
    """JAX ``_exchange_rows`` and the gather after it: ``data`` [block, C]
    producer rows, halo-extended over the rings (:func:`.halo.halo_extend`,
    differentiable), then gathered at ``tables.idx`` → [rows, ..., C] (zero
    rows at 0)."""
    ext = halo_extend(data, tables.exchange, group)
    flat = tables.idx.reshape(tables.idx.shape[0], -1)
    out = (gather_neighbors(ext, flat) if tables.idx_t is None
           else gather_slots(ext, flat, tables.idx_t))
    return out.reshape(*tables.idx.shape, data.shape[-1])


def _step_sizes(v_faces: np.ndarray) -> np.ndarray:
    """Per-vertex step size [V, 1] from the original incidence
    (train.py:1676-1683): 1/|faces|, 0 for a vertex without faces."""
    counts = np.sum(v_faces >= 0, axis=1).astype(np.float32)
    return np.where(counts > 0, 1.0 / np.maximum(counts, 1.0), 0.0)[:, None].astype(np.float32)


def _check_aligned(f: int, num_vertices: int, num_shards: int, group_size: int,
                   levels: int) -> Tuple[int, int]:
    f_align = num_shards * group_size ** (levels - 1)
    assert f % f_align == 0, (f, f_align, "pad faces before partitioning")
    assert num_vertices % num_shards == 0, (num_vertices, num_shards)
    return f // num_shards, num_vertices // num_shards


# ---------------------------------------------------------------------------
# The naive multi-scale solver: corners, centroids and pools every iteration
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class MultiscaleSolverOperands:
    """Host operands of the sharded naive multi-scale solver (JAX
    ``MultiscaleSolverOperands``, its [D, ...] arrays kept in their
    :class:`VertexPartition`): ``fv`` the faces → vertex-corner map, ``vf``
    per scale the vertices → level-s-face map, ``lmbd`` [V, 1] the step
    sizes. Built by :func:`prepare_multiscale_solver`;
    :meth:`rank_operands` gives one rank's tensors."""

    num_vertices: int
    num_faces: int
    v_block: int
    f_block: int
    fv: VertexPartition
    vf: Tuple[VertexPartition, ...]
    lmbd: np.ndarray

    def rank_operands(self, rank: int, device, transpose: bool = True) -> "NaiveSolverTables":
        return NaiveSolverTables(
            index_map_tables(self.fv, rank, device, transpose),
            tuple(index_map_tables(p, rank, device, transpose) for p in self.vf),
            torch.as_tensor(self.lmbd[rank * self.v_block:(rank + 1) * self.v_block],
                            device=device))


class NaiveSolverTables(NamedTuple):
    """One rank's tensors of :class:`MultiscaleSolverOperands` (JAX's
    ``device_operands`` indexed at the rank)."""

    fv: IndexMapTables
    vf: Tuple[IndexMapTables, ...]
    lmbd: torch.Tensor               # [vb, 1]


def prepare_multiscale_solver(
    face_normals_shapes: Sequence[int],
    faces: np.ndarray,
    v_faces: np.ndarray,
    num_vertices: int,
    num_shards: int,
    coarsening_steps: int = 2,
) -> MultiscaleSolverOperands:
    """The naive solver's operands for ``num_shards`` ranks (JAX
    ``prepare_multiscale_solver``): ``faces`` [F, 3] tree-ordered (−1 =
    fake), padded so that D × (2^steps)^(levels−1) divides F, and
    ``v_faces`` [V, K] padded so that D divides V; the step sizes come from
    the original incidence."""
    levels = len(face_normals_shapes)
    group = 2 ** coarsening_steps
    f = faces.shape[0]
    fb, vb = _check_aligned(f, num_vertices, num_shards, group, levels)
    vf = []
    for s in range(levels):
        idx_s = np.where(v_faces >= 0, v_faces.astype(np.int64) // group ** s, -1)
        vf.append(partition_index_map(idx_s, num_shards, producer_count=f // group ** s))
    return MultiscaleSolverOperands(
        num_vertices=num_vertices, num_faces=f, v_block=vb, f_block=fb,
        fv=partition_index_map(faces.astype(np.int64), num_shards, producer_count=num_vertices),
        vf=tuple(vf), lmbd=_step_sizes(v_faces))


def multiscale_solver_local(
    x_loc: torch.Tensor,
    fn_blocks: Sequence[torch.Tensor],
    tables: NaiveSolverTables,
    group: GraphGroup,
    coarsening_steps: int = 2,
    iter_nums: Sequence[int] = (80, 20, 20),
) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """The sharded naive multi-scale solver on one rank (JAX
    ``multiscale_solver_local``), differentiable: ``x_loc`` [vb, 3] the
    rank's vertices, ``fn_blocks`` per level (fine first) its block of the
    face normals [fb / 4^s, 3]. Per scale, coarsest first, the per-vertex
    normals are gathered once from the live normals (so gradients reach the
    heads), then each iteration gathers the corners through the vertex
    exchange, takes the centroids, pools them ``coarsening_steps × scale``
    rounds (``tree_pool(mode="avg_ignore_zeros")``: K4 and, under autograd,
    its backward kernel on the card), forms t = ⟨n_f, c_f⟩ on the face
    shard (a scalar: 3× less exchange than the centres), exchanges it back
    and moves each vertex by λ Σ_k n_k (t_k − ⟨n_k, x⟩). Returns the
    rank's final x and the per-scale displacements, coarse first."""
    levels = len(fn_blocks)
    dx_out = []
    for s in range(levels):
        cur = levels - 1 - s
        v_fn = _exchange_rows(fn_blocks[cur], tables.vf[cur], group)      # [vb, K, 3]
        x_init = x_loc
        for _ in range(int(iter_nums[s])):
            corners = _exchange_rows(x_loc, tables.fv, group)            # [fb, 3, 3]
            fpos = torch.mean(corners, dim=1)                            # fake → 0
            if cur > 0:
                fpos = tree_pool(fpos.contiguous(), steps=coarsening_steps * cur,
                                 mode="avg_ignore_zeros")
            t_loc = torch.sum(fn_blocks[cur] * fpos, dim=-1, keepdim=True)  # [fb_s, 1]
            t_vk = _exchange_rows(t_loc, tables.vf[cur], group)[..., 0]     # [vb, K]
            n_w = t_vk - dot_last(v_fn, x_loc[:, None, :])
            x_loc = x_loc + tables.lmbd * torch.sum(n_w[..., None] * v_fn, dim=1)
        dx_out.append(x_loc - x_init)
    return x_loc, dx_out


def sharded_update_positions_multiscale(
    x: np.ndarray,
    face_normals_list: Sequence[np.ndarray],
    faces: np.ndarray,
    v_faces: np.ndarray,
    group: Optional[GraphGroup] = None,
    coarsening_steps: int = 2,
    iter_nums: Sequence[int] = (80, 20, 20),
    device: str = "cuda",
) -> Tuple[np.ndarray, List[np.ndarray]]:
    """:func:`..ops.vertex_update.update_positions_multiscale` over the
    group's ranks (JAX ``sharded_update_positions_multiscale``): vertices
    AND faces partitioned, two halo exchanges an iteration
    (:func:`multiscale_solver_local` without gradient). ``x`` [V, 3],
    ``face_normals_list`` fine → coarse ([F, 3], [F/4, 3], [F/16, 3]),
    ``faces`` [F, 3] tree-ordered with −1 fakes and ``v_faces`` [V, K] are
    host arrays of the whole patch, alike on every rank. As JAX does, the
    faces are padded with −1 rows to a multiple of D × (2^steps)^(levels−1)
    (zero normals there), the vertices to a multiple of D, and the step
    sizes come from the original incidence. The default schedule pools
    with K4 100 times a solve (80 iterations at 4 rounds, 20 at 2). Returns
    ``(x [V, 3], [dx coarse, mid, fine])`` on every rank. ``group``
    defaults to :func:`..mesh.make_mesh` on ``device``."""
    group = group or make_mesh(device)
    n_dev, dev = group.size, group.device
    levels = len(face_normals_list)
    grp = 2 ** coarsening_steps
    v, f = x.shape[0], faces.shape[0]
    f_pad = (-f) % (n_dev * grp ** (levels - 1))
    faces_p = np.concatenate([faces.astype(np.int64), np.full((f_pad, 3), -1, np.int64)])
    v_pad = (-v) % n_dev
    x_p = np.concatenate([np.asarray(x, np.float32), np.zeros((v_pad, 3), np.float32)])
    v_faces_p = np.concatenate([v_faces.astype(np.int64),
                                np.full((v_pad, v_faces.shape[1]), -1, np.int64)])
    counts = [(f + f_pad) // grp ** s for s in range(levels)]
    ops = prepare_multiscale_solver(counts, faces_p, v_faces_p, v + v_pad, n_dev,
                                    coarsening_steps)
    tables = ops.rank_operands(group.rank, dev, transpose=False)
    fn_blocks = []
    for s, fn in enumerate(face_normals_list):
        full = np.zeros((counts[s], 3), np.float32)
        fn = np.asarray(fn, np.float32).reshape(-1, 3)
        full[:fn.shape[0]] = fn
        fn_blocks.append(shard_rows(full, group))
    with torch.no_grad():
        out, dx = multiscale_solver_local(shard_rows(x_p, group), fn_blocks, tables, group,
                                          coarsening_steps, iter_nums)
        out = gather_rows(out, group).cpu().numpy()[:v]
        dx = [gather_rows(d, group).cpu().numpy()[:v] for d in dx]
    return out, dx


# ---------------------------------------------------------------------------
# The operator multi-scale solver: static centre operators, deduped slots
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class OperatorSolverOperands:
    """Host operands of the sharded OPERATOR multi-scale solver (JAX
    ``OperatorSolverOperands``; the graph-parallel twin of
    :func:`..ops.vertex_update.update_positions_multiscale_operator`): per
    scale the DEDUPED vertex → level-s-face map ``vfu`` with its
    multiplicities ``vfu_mults`` [V, K_u], and the static level-s-face →
    vertex centre operator ``c_s = A_s·x`` (:func:`..ops.vertex_update.
    face_center_klists`) as the map ``fc`` with its weights ``fc_weights``
    [F_s, K_s], which replaces the per-iteration corner gather and pool
    chain. Built by :func:`prepare_multiscale_solver_operator`."""

    num_vertices: int
    num_faces: int
    v_block: int
    f_block: int
    vfu: Tuple[VertexPartition, ...]
    vfu_mults: Tuple[np.ndarray, ...]
    fc: Tuple[VertexPartition, ...]
    fc_weights: Tuple[np.ndarray, ...]
    lmbd: np.ndarray

    def rank_operands(self, rank: int, device, transpose: bool = True) -> "OperatorSolverTables":
        vb = self.v_block

        def block(a, rows):
            return torch.as_tensor(np.ascontiguousarray(a[rank * rows:(rank + 1) * rows]),
                                   device=device)

        return OperatorSolverTables(
            tuple(index_map_tables(p, rank, device, transpose) for p in self.vfu),
            tuple(block(m, vb) for m in self.vfu_mults),
            tuple(index_map_tables(p, rank, device, transpose) for p in self.fc),
            tuple(block(w, w.shape[0] // (self.num_faces // self.f_block))
                  for w in self.fc_weights),
            block(self.lmbd, vb))


class OperatorSolverTables(NamedTuple):
    """One rank's tensors of :class:`OperatorSolverOperands`."""

    vfu: Tuple[IndexMapTables, ...]
    vfu_mults: Tuple[torch.Tensor, ...]      # [vb, K_u]
    fc: Tuple[IndexMapTables, ...]
    fc_weights: Tuple[torch.Tensor, ...]     # [fb_s, K_s]
    lmbd: torch.Tensor                       # [vb, 1]


def prepare_multiscale_solver_operator(
    face_normals_shapes: Sequence[int],
    faces: np.ndarray,
    v_faces: np.ndarray,
    num_vertices: int,
    num_shards: int,
    coarsening_steps: int = 2,
) -> OperatorSolverOperands:
    """The operator solver's operands for ``num_shards`` ranks (JAX
    ``prepare_multiscale_solver_operator``), with the padding
    :func:`prepare_multiscale_solver` asks for."""
    levels = len(face_normals_shapes)
    group = 2 ** coarsening_steps
    f = faces.shape[0]
    fb, vb = _check_aligned(f, num_vertices, num_shards, group, levels)
    vfu, mults = [], []
    for s in range(levels):
        vf1 = np.where(v_faces < 0, 0, (v_faces.astype(np.int64) // group ** s) + 1)
        vf_u, mult = dedupe_klist(vf1.astype(np.int32))
        vfu.append(partition_index_map(vf_u.astype(np.int64) - 1, num_shards,
                                       producer_count=f // group ** s))
        mults.append(mult.astype(np.float32))
    fc, weights = [], []
    for adj, wt in face_center_klists(faces, face_normals_shapes, num_vertices,
                                      coarsening_steps):
        fc.append(partition_index_map(adj.astype(np.int64) - 1, num_shards,
                                      producer_count=num_vertices))
        weights.append(wt)
    return OperatorSolverOperands(
        num_vertices=num_vertices, num_faces=f, v_block=vb, f_block=fb, vfu=tuple(vfu),
        vfu_mults=tuple(mults), fc=tuple(fc), fc_weights=tuple(weights),
        lmbd=_step_sizes(v_faces))


def multiscale_solver_local_operator(
    x_loc: torch.Tensor,
    fn_blocks: Sequence[torch.Tensor],
    tables: OperatorSolverTables,
    group: GraphGroup,
    coarsening_steps: int = 2,
    iter_nums: Sequence[int] = (80, 20, 20),
) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """The sharded OPERATOR solver on one rank (JAX
    ``multiscale_solver_local_operator``), differentiable: per scale the
    deduped per-vertex normals and the [vb, 3, 3] projector P_v = Σ_u
    mult·n nᵀ are hoisted out of the loop; each iteration runs ONE vertex →
    face exchange (positions for the static centre operator A_s: no corner
    gather, no pool) and ONE face → vertex exchange of t over the deduped
    slots, and moves x by λ (Σ_u mult·t·n − P_v x). Plain PyTorch, as the
    port's single-device operator solver is (XLA runs it in JAX: no kernel
    to port). Returns as :func:`multiscale_solver_local`."""
    levels = len(fn_blocks)
    dx_out = []
    for s in range(levels):
        cur = levels - 1 - s
        v_fn = _exchange_rows(fn_blocks[cur], tables.vfu[cur], group)     # [vb, K_u, 3]
        mult = tables.vfu_mults[cur]
        proj = torch.einsum("vka,vkb,vk->vab", v_fn, v_fn, mult)          # [vb, 3, 3]
        x_init = x_loc
        for _ in range(int(iter_nums[s])):
            g = _exchange_rows(x_loc, tables.fc[cur], group)             # [fb_s, K_s, 3]
            c = torch.sum(tables.fc_weights[cur][..., None] * g, dim=1)
            t_loc = torch.sum(fn_blocks[cur] * c, dim=-1, keepdim=True)
            t_vk = _exchange_rows(t_loc, tables.vfu[cur], group)[..., 0]  # [vb, K_u]
            term1 = torch.sum((mult * t_vk)[..., None] * v_fn, dim=1)
            px = torch.einsum("vab,vb->va", proj, x_loc)
            x_loc = x_loc + tables.lmbd * (term1 - px)
        dx_out.append(x_loc - x_init)
    return x_loc, dx_out
