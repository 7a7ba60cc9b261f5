"""Sharded vertex solver: edge-map Taubin filtering over partitioned
vertices (the port's counterpart of
``facet_graph_convolution_tpu/parallel/vertex_halo.py``, its edge solver).

After the halo-exchange U-Net predicts the facet normals of a whole mesh
(:mod:`.halo`), the vertex positions are refined by the solver the
reference unrolls on one device (``update_position2``, train.py:1467-1557),
here with the VERTEX space partitioned into D contiguous blocks, one a
rank: each iteration exchanges the boundary vertices' positions
(:func:`.halo.halo_extend`, rings only) before the edge-endpoint gathers.

The per-vertex face normals are static across iterations, so they are
gathered once on the host and each rank keeps its block; only the moving
positions ride the exchange. Pad slots carry zero normals, so their
contribution vanishes exactly as in the single-device solver. The
multiscale solvers of the JAX module are not ported here
(``parallel.NOT_YET_PORTED``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from facet_graph_convolution_torch.ops.normalization import dot_last
from facet_graph_convolution_torch.parallel.halo import (
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
