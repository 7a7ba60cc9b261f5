"""One facet graph partitioned over the ranks of a group, with a halo
exchange a conv (the port's counterpart of
``facet_graph_convolution_tpu/parallel/halo.py``).

The graph is node-partitioned into D contiguous blocks, one a rank (the
binary-tree order gives locality, so the adjacency is close to banded). Each
shard owns its nodes' full K-lists, so degree normalization is globally
exact; neighbour features living on other shards (the *halo*) are fetched
once a conv, before K1 reads them:

- :func:`build_partition` is the JAX package's host partitioner, in NumPy,
  array for array; :func:`partition_operands` turns one shard of it into
  that rank's tensors, the slot-major K1/K2 tables over the shard's
  extended index space (n owned rows, then the halo rows);
- :func:`halo_extend` exchanges the halo rows: a pair of point-to-point
  sends a ring offset (JAX's ``ppermute``) and one ``all_to_all`` for the
  batched cross-host rows, as an autograd Function whose backward sends the
  cotangents back and sums them into their owners' rows through a transpose
  map (no scatter, bitwise repeatable);
- :func:`sharded_conv` is :func:`..ops.conv.facet_conv` with the halo
  exchange between the projection and the gather: K1 reads ``cat`` with
  N_src ≥ N source rows, K2 gives ``dcat`` for all of them
  (``ops/facet_conv_kernel.py``); the rotation-invariant first conv
  exchanges the raw features and aggregates with K3;
- on levels of at least :data:`WINDOWED_MIN_NODES` rows a shard ordered by
  RCM (a million-face mesh's levels 0 and 1), :func:`build_level_windows`
  cuts the rows into slabs and :func:`windowed_conv` runs K5
  (``ops/windowed_conv.py``): the whole conv, its ``[M·C → out]`` product
  included, in one pass a direction, so the aggregate z never reaches
  device memory (JAX's default there too);
- :func:`sharded_unet_forward_local` is :func:`..models.unet._network`
  over those convs, with tree pooling shard-local: partition boundaries are
  aligned to ``(2^steps)^(levels-1)``, so every coarsening level splits at
  sibling-group boundaries;
- the global mean of ``normalize_tensor`` and the loss's denominator are
  all-reduced; :func:`make_sharded_train_step` sums the gradients over the
  ranks with one all-reduce, and :func:`train_normals_sharded` is the
  driver.

At one rank the partition has no ring offset and no cross-host table, and
no collective is issued: the step is the flat step over the whole graph
(``chip_smoke.py`` holds them equal on the card). The step runs eagerly:
capturing it in a CUDA graph would need NCCL's graph-safe mode around the
exchanges, which this module does not set up.

Correctness contract (tests/test_torch_halo.py,
tests/test_torch_windowed_step.py): at D = 1, 2 and 4 the sharded forward
and train step equal the JAX package's sharded ones and the port's flat
``unet_apply`` to float tolerance, with and without windowed levels.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import os
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from facet_graph_convolution_torch.config import Config
from facet_graph_convolution_torch.data.dataset import bucket_size, pad_patch_to
from facet_graph_convolution_torch.graph.convert import (
    WindowedLaneTables,
    dedupe_klist,
    fused_mult_rows,
    lane_tables,
    split_self_klist,
    transpose_adjacency,
    windowed_lane_tables,
)
from facet_graph_convolution_torch.models.augment import (
    random_rotation,
    rotate_inputs,
    rotate_vec3,
)
from facet_graph_convolution_torch.models.losses import _CLOSE_TO_ONE, _fake_node_mask
from facet_graph_convolution_torch.models.unet import _network
from facet_graph_convolution_torch.ops.aggregate import WeightedAggregate
from facet_graph_convolution_torch.ops.conv import (
    Bf16Matmul,
    FacetConvVariant,
    facet_conv,
    per_conv_variants,
)
from facet_graph_convolution_torch.ops.gather import _transpose_sum, make_windowed_lane_gather
from facet_graph_convolution_torch.ops.normalization import dot_last
from facet_graph_convolution_torch.ops.windowed_conv import (
    make_windowed_fused_conv,
    window_tensors,
)
from facet_graph_convolution_torch.parallel.distributed import devices_per_host
from facet_graph_convolution_torch.parallel.mesh import GraphGroup, make_mesh
from facet_graph_convolution_torch.training.checkpoint import CheckpointManager
from facet_graph_convolution_torch.training.trainer import (
    TrainState,
    _config_variant,
    _leaves,
    adam_update,
    compute_dtype,
    create_train_state,
)
from facet_graph_convolution_torch.utils.profiling import marked_step, span

# JAX functions of this module without a counterpart, and why: none
NO_COUNTERPART: Dict[str, str] = {}

# Levels whose shard has at least WINDOWED_MIN_NODES rows, ordered by RCM,
# run the windowed conv over WINDOWED_BLOCK-row slabs: K5, the fused conv
# (ops/windowed_conv.py), or with FGC_WINDOWED_FUSED=0 the unfused windowed
# gather before the aggregation (JAX's A/B branch). The JAX package's
# defaults and environment names; module-level so that tests can change them.
_WINDOWED_FUSED = os.environ.get("FGC_WINDOWED_FUSED", "1") != "0"
WINDOWED_MIN_NODES = int(os.environ.get("FGC_WINDOWED_MIN_NODES", 262144))
WINDOWED_BLOCK = int(os.environ.get("FGC_WINDOWED_BLOCK", 32768))


# ---------------------------------------------------------------------------
# Host-side partitioner (the JAX package's, in NumPy)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class LevelPartition:
    """One pyramid level, split into D equal blocks.

    - ``local_adj`` [D, n, K]: K-lists with entries remapped into the
      shard-extended index space — one-indexed; 1..n are owned nodes,
      n+1..n+H are halo slots, 0 is padding;
    - ``send_idx`` [D, num_offsets, H]: for ring offset ``offsets[j]``, the
      owned-row indices shard s must send to shard s − offsets[j] (packed in
      the receiver's expected order; −1 = inactive slot → sends row 0 whose
      content the receiver never reads);
    - ``recv_mask`` [D, num_offsets, H]: 1 where the received slot is a real
      requested row.

    Host-aware split (``devices_per_host`` set at build time): the per-offset
    ring tables then carry only *intra-host* halo traffic (ranks s, s+1 of
    one host), and all *cross-host* rows are batched into per-(src, dst)
    pair tables exchanged in ONE ``all_to_all`` per layer — one transfer
    across hosts instead of one per ring offset:

    - ``cross_send`` [D, D, Hx]: rows shard s sends to shard t (local
      indices on s, packed in t's expected order; 0-filled when inactive);
    - ``cross_mask`` [D, D, Hx]: on the receiver — 1 where the slot received
      from source shard o is a real requested row.
    """

    num_nodes: int
    block: int                       # n = num_nodes / D
    offsets: Tuple[int, ...]         # ring offsets (nonzero, e.g. (1, -1, 2))
    local_adj: np.ndarray            # [D, n, K'] deduped, neighbours-only
    local_adj_t: np.ndarray          # [D, ext, K_t] transpose slot maps
    lane_adj: np.ndarray             # [D, K', n] transposed K-lists (lane gather)
    lane_adj_t: np.ndarray           # [D, K_tl, ext] lane slot maps (node minor)
    send_idx: np.ndarray
    recv_mask: np.ndarray
    halo_size: int                   # H per offset (uniform, padded)
    mult: np.ndarray                 # [D, n, K'] slot multiplicities
    self_mult: np.ndarray            # [D, n] self-slot multiplicity
    cross_send: Optional[np.ndarray] = None   # [D, D, Hx]
    cross_mask: Optional[np.ndarray] = None   # [D, D, Hx]
    cross_halo: int = 0


@dataclasses.dataclass
class GraphPartition:
    num_shards: int
    levels: List[LevelPartition]
    # windowed_lane_tables of each (level, block), built once a partition
    # (:func:`build_level_windows`, :func:`unify_level_windows`)
    _window_cache: Dict = dataclasses.field(default_factory=dict, repr=False, compare=False)

    @property
    def fine(self) -> LevelPartition:
        return self.levels[0]


@dataclasses.dataclass(frozen=True)
class LevelGeometry:
    """Shape signature of one LevelPartition — the static geometry a compiled
    sharded step depends on. Partitioning DIFFERENT meshes with a merged
    (elementwise-max / offset-union) geometry yields identically-shaped
    tables, so one jitted step serves them all (multi-mesh training without
    per-mesh recompiles; ``train_normals_sharded_multi``)."""

    offsets: Tuple[int, ...]
    halo: int
    cross_halo: int
    use_cross: bool
    k_n: int                         # deduped neighbours-only K width
    k_t: int                         # row-major transpose slot width
    k_tl: int                        # lane slot-map width


def level_geometry(lvl: LevelPartition) -> LevelGeometry:
    return LevelGeometry(
        offsets=tuple(lvl.offsets),
        halo=lvl.halo_size,
        cross_halo=lvl.cross_halo,
        use_cross=lvl.cross_send is not None,
        k_n=lvl.local_adj.shape[2],
        k_t=lvl.local_adj_t.shape[2],
        k_tl=lvl.lane_adj_t.shape[1],
    )


def merge_geometry(a: LevelGeometry, b: LevelGeometry) -> LevelGeometry:
    assert a.use_cross == b.use_cross, (
        "cannot merge a ring-exchange level with an all_to_all level — "
        "build both partitions with the same exchange mode"
    )
    return LevelGeometry(
        offsets=tuple(sorted(set(a.offsets) | set(b.offsets),
                             key=lambda d: (abs(d), d))),
        halo=max(a.halo, b.halo),
        cross_halo=max(a.cross_halo, b.cross_halo),
        use_cross=a.use_cross,
        k_n=max(a.k_n, b.k_n),
        k_t=max(a.k_t, b.k_t),
        k_tl=max(a.k_tl, b.k_tl),
    )


def _partition_level(
    adj: np.ndarray, num_shards: int, devices_per_host: Optional[int] = None,
    geometry: Optional[LevelGeometry] = None,
) -> LevelPartition:
    n_total, k = adj.shape
    assert n_total % num_shards == 0, (n_total, num_shards)
    block = n_total // num_shards
    owner = lambda g: g // block
    # host-aware mode: shard s lives on host s // dph (process-contiguous
    # mesh ordering, parallel/distributed.make_multihost_mesh); remote rows
    # owned by a different host are exchanged via the batched all_to_all
    # tables instead of the per-offset rings
    dph = devices_per_host if devices_per_host and devices_per_host < num_shards else None
    host_of = (lambda sh: sh // dph) if dph else (lambda sh: 0)

    neigh = adj.astype(np.int64) - 1                     # -1 = pad
    # per shard: remote global ids needed — intra-host grouped by owner
    # offset, cross-host grouped by source shard (all-vectorized: unique +
    # owner-boundary splits; no per-edge Python)
    requested: List[Dict[int, np.ndarray]] = []
    cross_req: List[Dict[int, np.ndarray]] = []
    offsets_set = set()
    for s in range(num_shards):
        rows = neigh[s * block : (s + 1) * block]
        valid = rows[rows >= 0]
        remote = np.unique(valid[(valid < s * block) | (valid >= (s + 1) * block)])
        groups: Dict[int, np.ndarray] = {}
        xgroups: Dict[int, np.ndarray] = {}
        owners = remote // block
        # remote is sorted, hence owners is non-decreasing: split at owner
        # boundaries instead of one masked scan per owner
        bounds = np.searchsorted(owners, np.arange(num_shards + 1))
        for o in np.unique(owners):
            o = int(o)
            rows_o = remote[bounds[o] : bounds[o + 1]]
            if dph and host_of(o) != host_of(s):
                xgroups[o] = rows_o
            else:
                groups[o - s] = rows_o
                offsets_set.add(o - s)
        requested.append(groups)
        cross_req.append(xgroups)

    offsets = tuple(sorted(offsets_set, key=lambda d: (abs(d), d)))
    if geometry is not None:
        assert offsets_set <= set(geometry.offsets), (
            "forced geometry is missing ring offsets this mesh needs",
            sorted(offsets_set - set(geometry.offsets)),
        )
        assert geometry.use_cross == bool(dph), (
            "forced geometry exchange mode mismatch"
        )
        offsets = geometry.offsets
    halo = 0
    for s in range(num_shards):
        for d in offsets:
            halo = max(halo, len(requested[s].get(d, ())))
    halo = max(halo, 1)
    if geometry is not None:
        halo = max(halo, geometry.halo)
    num_off = max(len(offsets), 1)
    cross_halo = 0
    for s in range(num_shards):
        for o, rows_o in cross_req[s].items():
            cross_halo = max(cross_halo, len(rows_o))
    if dph:
        cross_halo = max(cross_halo, 1)
    if geometry is not None:
        cross_halo = max(cross_halo, geometry.cross_halo)

    send_idx = np.full((num_shards, num_off, halo), -1, dtype=np.int32)
    recv_mask = np.zeros((num_shards, num_off, halo), dtype=np.float32)
    cross_send = (
        np.zeros((num_shards, num_shards, cross_halo), dtype=np.int32)
        if dph else None
    )
    cross_mask = (
        np.zeros((num_shards, num_shards, cross_halo), dtype=np.float32)
        if dph else None
    )
    local_adj = np.zeros((num_shards, block, k), dtype=np.int32)

    # dense global→extended-slot remap, reused across shards: each shard
    # refills exactly the positions it will read (its own requested ids), so
    # stale entries from earlier shards are never consulted (a per-remote-
    # edge dict lookup takes minutes at 2M facets × 4 levels).
    slot_map = np.zeros(n_total, dtype=np.int64)
    for s in range(num_shards):
        # halo slot map for shard s: offset j's rows land at
        # [j*halo, j*halo+|req|); cross-host rows from source o land after
        # the intra region at [num_off*halo + o*cross_halo, ... + |req|)
        for j, d in enumerate(offsets):
            req = requested[s].get(d, np.zeros(0, np.int64))
            slot_map[req] = block + j * halo + np.arange(len(req))
            recv_mask[s, j, : len(req)] = 1.0
            # the sender is shard s + d; its send list for offset d towards s
            # is filled below from the receiver's perspective
        # fill sender tables: shard s RECEIVES from s+d ⇒ shard (s+d) sends
        for j, d in enumerate(offsets):
            src = s + d
            if 0 <= src < num_shards:
                req = requested[s].get(d, np.zeros(0, np.int64))
                send_idx[src, j, : len(req)] = req - src * block
        if dph:
            base = block + len(offsets) * halo
            for o, req in cross_req[s].items():
                slot_map[req] = base + o * cross_halo + np.arange(len(req))
                cross_mask[s, o, : len(req)] = 1.0
                # source shard o sends these rows (its local indices) to s
                cross_send[o, s, : len(req)] = req - o * block

        rows = neigh[s * block : (s + 1) * block]
        out = np.zeros_like(rows)
        own_mask = (rows >= s * block) & (rows < (s + 1) * block)
        out[own_mask] = rows[own_mask] - s * block + 1
        remote_mask = (rows >= 0) & ~own_mask
        out[remote_mask] = slot_map[rows[remote_mask]] + 1
        local_adj[s] = out

    # dedupe duplicate K-list slots into multiplicities and split the self
    # slot out (its features are the local row — no gather) per shard, the
    # same exact transformations as the single-chip fast path
    # (graph.convert.dedupe_klist / split_self_klist); degree = mult sums
    # stays the original non-zero count, so global normalization is exact
    nbrs, mults, selfs = [], [], []
    for s in range(num_shards):
        a_u, mlt = dedupe_klist(local_adj[s])
        nbr, m_n, s_m = split_self_klist(a_u, mlt)
        nbrs.append(nbr)
        mults.append(m_n)
        selfs.append(s_m)
    k_n = max(a.shape[1] for a in nbrs)
    if geometry is not None:
        k_n = max(k_n, geometry.k_n)
    local_adj = np.zeros((num_shards, block, k_n), dtype=np.int32)
    mult = np.zeros((num_shards, block, k_n), dtype=np.float32)
    for s in range(num_shards):
        local_adj[s, :, : nbrs[s].shape[1]] = nbrs[s]
        mult[s, :, : mults[s].shape[1]] = mults[s]
    self_mult = np.stack(selfs)

    # transpose slot maps over the halo-extended index space, for the
    # scatter-free gather backward inside each shard — sized by the ACTUAL
    # offset count (len(offsets) can be 0, e.g. D=1 overhead benchmarks,
    # while the table arrays keep a min width of 1 for structural reasons)
    ext = block + len(offsets) * halo + (num_shards * cross_halo if dph else 0)
    t_maps = [transpose_adjacency(local_adj[s], num_targets=ext)
              for s in range(num_shards)]
    k_t = max(t.shape[1] for t in t_maps)
    if geometry is not None:
        k_t = max(k_t, geometry.k_t)
    local_adj_t = np.zeros((num_shards, ext, k_t), dtype=np.int32)
    for s, t in enumerate(t_maps):
        local_adj_t[s, :, : t.shape[1]] = t

    # slot-major tables, the port's K1/K2 layout: transposed K-lists + slot
    # maps over the extended index space
    lane_pairs = [lane_tables(local_adj[s], num_sources=ext)
                  for s in range(num_shards)]
    lane_adj = np.stack([p[0] for p in lane_pairs])
    # lane slot maps are [K_t, ext] (node axis minor — see lane_tables)
    k_tl = max(p[1].shape[0] for p in lane_pairs)
    if geometry is not None:
        k_tl = max(k_tl, geometry.k_tl)
    lane_adj_t = np.zeros((num_shards, k_tl, ext), dtype=np.int32)
    for s, (_, t) in enumerate(lane_pairs):
        lane_adj_t[s, : t.shape[0], :] = t

    return LevelPartition(
        num_nodes=n_total,
        block=block,
        offsets=offsets,
        local_adj=local_adj,
        local_adj_t=local_adj_t,
        lane_adj=lane_adj,
        lane_adj_t=lane_adj_t,
        send_idx=send_idx.clip(min=0),  # -1 → 0 (sends row 0; receiver masks)
        recv_mask=recv_mask,
        halo_size=halo,
        mult=mult,
        self_mult=self_mult,
        cross_send=cross_send,
        cross_mask=cross_mask,
        cross_halo=cross_halo if dph else 0,
    )


def build_partition(
    adjs: Sequence[np.ndarray],
    num_shards: int,
    devices_per_host: Optional[int] = None,
    exchange: str = "auto",
    geometry: Optional[Sequence[Optional[LevelGeometry]]] = None,
) -> GraphPartition:
    """Partition a coarsening pyramid for D shards. The fine level size must
    be divisible by D × (coarsening group)^(levels−1) so every level splits
    evenly (use :func:`facet_graph_convolution_torch.data.dataset.pad_patch_to`
    first).

    ``devices_per_host`` (ranks a host, :func:`..distributed.devices_per_host`)
    splits the halo traffic: intra-host rows ride the per-offset rings of
    point-to-point pairs; cross-host rows batch into one ``all_to_all`` per
    conv layer (one transfer across hosts instead of one per ring offset).

    ``exchange`` picks the single-host collective shape per level:
    ``"rings"`` = one send/receive pair per ring offset; ``"a2a"`` = batch
    ALL halo traffic into one ``all_to_all`` per layer; ``"auto"`` (default)
    uses the a2a form when the ring offsets span at least half the shards —
    the Graclus tree ordering often spreads neighbours across every shard,
    where nearly all pairs would exchange one ring each. The tables are the
    JAX package's, array for array. The span ``fgc.prep.partition``."""
    with span("fgc.prep.partition"):
        levels = []
        for i, a in enumerate(adjs):
            a = np.asarray(a)
            if geometry is not None and geometry[i] is not None:
                # forced geometry pins the per-level shapes AND the exchange
                # mode (use_cross ⇒ batched a2a tables), overriding ``exchange``
                geo = geometry[i]
                dph = devices_per_host if devices_per_host is not None else (
                    1 if geo.use_cross else None
                )
                lvl = _partition_level(a, num_shards, dph, geometry=geo)
            elif devices_per_host is not None:
                lvl = _partition_level(a, num_shards, devices_per_host)
            elif exchange == "a2a":
                lvl = _partition_level(a, num_shards, 1)
            else:
                lvl = _partition_level(a, num_shards, None)
                if (exchange == "auto" and num_shards > 2
                        and len(lvl.offsets) >= max(2, num_shards // 2)):
                    lvl = _partition_level(a, num_shards, 1)
            levels.append(lvl)
        return GraphPartition(num_shards=num_shards, levels=levels)


def build_level_windows(
    part: GraphPartition,
    min_nodes: Optional[int] = None,
    block: Optional[int] = None,
    variant: FacetConvVariant = FacetConvVariant.DEFAULT,
) -> List[Optional[WindowedLaneTables]]:
    """Each level's :class:`..graph.convert.WindowedLaneTables`, or None
    where the level stays on K1/K2 (JAX ``build_level_windows``, array for
    array). A level windows when its shard has at least ``min_nodes`` rows
    (default :data:`WINDOWED_MIN_NODES`) and the pyramid has locality
    (``windowed_lane_tables`` gives None without RCM order). At D > 1 each
    shard's owned rows form an RCM band and its halo rows ride the tables'
    halo pack; the shards share one geometry (the widest windows), their
    arrays stacked [D, ...], and if one shard lacks locality the level stays
    flat on all. The rotation-invariant first conv stays flat (its
    assignment is K3's), so level 0 does under that variant. Built once a
    partition and ``block`` (default :data:`WINDOWED_BLOCK`)."""
    if min_nodes is None:
        min_nodes = WINDOWED_MIN_NODES
    if block is None:
        block = WINDOWED_BLOCK
    out = []
    for i, lvl in enumerate(part.levels):
        if lvl.block < min_nodes or (
                i == 0 and FacetConvVariant(variant) == FacetConvVariant.ROTATION_INVARIANT):
            out.append(None)
            continue
        key = (i, block)
        if key not in part._window_cache:
            part._window_cache[key] = _build_shard_windows(lvl, block)
        out.append(part._window_cache[key])
    return out


def _build_shard_windows(lvl: LevelPartition, block: int, force_window=None, force_bwd=None):
    """Every shard's window tables of one level under one geometry, stacked
    [D, ...] (unstacked at D = 1), or None when a shard lacks locality;
    ``force_window`` / ``force_bwd`` pin wider windows (JAX
    ``_build_shard_windows``)."""
    d = lvl.local_adj.shape[0]
    ext = lvl.lane_adj_t.shape[2]

    def build(s, window=force_window, bwd_window=force_bwd):
        return windowed_lane_tables(
            lvl.local_adj[s], num_sources=ext, block=block, window=window,
            bwd_window=bwd_window, tables=(lvl.lane_adj[s], lvl.lane_adj_t[s]))

    if d == 1:
        return build(0)
    per = [build(s) for s in range(d)]
    if any(wt is None for wt in per):
        return None
    wmax = max(wt.window for wt in per)
    bmax = max(wt.bwd_window for wt in per)
    per = [wt if (wt.window == wmax and wt.bwd_window == bmax)
           else build(s, window=wmax, bwd_window=bmax) for s, wt in enumerate(per)]
    ref = per[0]
    stacked = [np.stack([wt.arrays[j] for wt in per]) for j in range(len(ref.arrays))]
    names = ("out_starts", "win_starts", "relT", "validF", "bwd_starts", "relS", "validS",
             "not_tail", "tailT", "tailS", "tailV")
    return WindowedLaneTables(block=ref.block, window=wmax, bwd_window=bmax,
                              num_sources=ref.num_sources, num_out=ref.num_out,
                              **dict(zip(names, stacked)))


def unify_level_windows(
    parts: Sequence[GraphPartition],
    variant: FacetConvVariant = FacetConvVariant.DEFAULT,
    min_nodes: Optional[int] = None,
    block: Optional[int] = None,
) -> None:
    """Give several partitions of one geometry the same window geometry
    (JAX ``unify_level_windows``): a level's windows widen to the widest
    of any mesh, and a level that windows in one mesh but not in another
    stays flat in all, so that one step's table shapes serve every mesh.
    The results land in each partition's window cache, where
    :func:`build_level_windows` finds them."""
    if block is None:
        block = WINDOWED_BLOCK
    per_part = [build_level_windows(p, min_nodes=min_nodes, block=block, variant=variant)
                for p in parts]
    for i in range(len(parts[0].levels)):
        wts = [pp[i] for pp in per_part]
        if any(wt is None for wt in wts):
            for p in parts:
                p._window_cache[(i, block)] = None
            continue
        wmax = max(wt.window for wt in wts)
        bmax = max(wt.bwd_window for wt in wts)
        for p, wt in zip(parts, wts):
            if wt.window != wmax or wt.bwd_window != bmax:
                p._window_cache[(i, block)] = _build_shard_windows(
                    p.levels[i], block, force_window=wmax, force_bwd=bmax)


def extended_rows(part: GraphPartition, level: int, shard: int) -> np.ndarray:
    """The global node of each row of shard ``shard``'s extended index space
    at ``level`` (its owned rows, then its halo slots), −1 where a slot is
    inactive and holds a zero row: the rows :func:`halo_extend` assembles,
    here gathered on the host from the whole graph."""
    lvl = part.levels[level]
    n, d_sz = lvl.block, part.num_shards
    ids = [np.arange(shard * n, (shard + 1) * n, dtype=np.int64)]
    for j, d in enumerate(lvl.offsets):
        row = np.full(lvl.halo_size, -1, np.int64)
        src = shard + d
        if 0 <= src < d_sz:
            live = lvl.recv_mask[shard, j] > 0
            row[live] = src * n + lvl.send_idx[src, j][live]
        ids.append(row)
    if lvl.cross_send is not None:
        for o in range(d_sz):
            row = np.full(lvl.cross_halo, -1, np.int64)
            live = lvl.cross_mask[shard, o] > 0
            row[live] = o * n + lvl.cross_send[o, shard][live]
            ids.append(row)
    return np.concatenate(ids)


# ---------------------------------------------------------------------------
# One rank's tensors
# ---------------------------------------------------------------------------

class ExchangeTables(NamedTuple):
    """One rank's halo-exchange tables: ``send_idx`` [len(offsets), H]
    owned rows sent for each ring offset (to rank − d), ``recv_mask`` the
    same shape (1 where a received slot is a requested row), the batched
    cross-host ``cross_send`` / ``cross_mask`` [D, Hx] (None without), and
    ``send_t`` [n, len(offsets) (+ D)], the transpose map of everything
    sent: for each owned row, the one-indexed positions in the concatenated
    sent rows (rings first, then the cross blocks) that carry it live (0 =
    pad), as wide as a row can be sent. The backward sums the returned
    cotangents through it."""

    offsets: Tuple[int, ...]
    send_idx: Optional[torch.Tensor]
    recv_mask: Optional[torch.Tensor]
    cross_send: Optional[torch.Tensor]
    cross_mask: Optional[torch.Tensor]
    send_t: Optional[torch.Tensor]

    @property
    def local(self) -> bool:
        """Nothing to exchange (one rank)."""
        return not self.offsets and self.cross_send is None


class ShardWindows(NamedTuple):
    """One rank's window tables of a windowed level: the static
    ``geometry`` (block, window, bwd_window, num_sources, num_out) and the
    ``WindowedLaneTables.arrays`` of its shard as tensors."""

    geometry: Tuple[int, int, int, int, int]
    arrays: Tuple[torch.Tensor, ...]


class ShardTables(NamedTuple):
    """One rank's tensors of one level: the K1/K2 tables over the extended
    index space (``adj_sm`` [K', n] one-indexed into the n + halo source
    rows, ``adj_t_sm`` [n + halo, K_t] over the flat slots k·n + i; both
    None on a windowed level), ``mult_rows`` [K'+1, n, 1], multiplicity ×
    1/degree with the self slot first, the level's :class:`ExchangeTables`
    and, on a windowed level, its :class:`ShardWindows` (K5's tables)."""

    adj_sm: Optional[torch.Tensor]
    adj_t_sm: Optional[torch.Tensor]
    mult_rows: torch.Tensor
    exchange: ExchangeTables
    windows: Optional[ShardWindows] = None


def exchange_tables(offsets, send_idx, recv_mask, cross_send, cross_mask, shard: int,
                    block: int, device) -> ExchangeTables:
    """:class:`ExchangeTables` of shard ``shard`` (``block`` owned rows)
    from a partition's stacked [D, ...] tables (``cross_*`` may be None)."""
    offsets = tuple(int(d) for d in offsets)
    num_shards = send_idx.shape[0]
    sent, live = [], []
    for j, d in enumerate(offsets):
        sent.append(send_idx[shard, j])
        # the receiver of offset d is rank shard − d, and its mask says
        # which slots it asked for (all 0 where the ring wraps)
        live.append(recv_mask[(shard - d) % num_shards, j] > 0)
    if cross_send is not None:
        sent.append(cross_send[shard].reshape(-1))
        live.append(cross_mask[:, shard].reshape(-1) > 0)
    if not sent:
        return ExchangeTables((), None, None, None, None, None)
    sent, live = np.concatenate(sent).astype(np.int64), np.concatenate(live)
    send_t = transpose_adjacency(np.where(live, sent + 1, 0).reshape(-1, 1), num_targets=block)
    # a row is sent at most once a ring offset and once a destination of the
    # all-to-all: pad the map to that width, so that its shape follows the
    # partition's geometry and not the data (train_normals_sharded_multi)
    width = len(offsets) + (num_shards if cross_send is not None else 0)
    send_t = np.pad(send_t, ((0, 0), (0, width - send_t.shape[1])))

    def tensor(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=device)

    return ExchangeTables(
        offsets,
        tensor(send_idx[shard, :len(offsets)], torch.int64) if offsets else None,
        tensor(recv_mask[shard, :len(offsets)], torch.float32) if offsets else None,
        None if cross_send is None else tensor(cross_send[shard], torch.int64),
        None if cross_mask is None else tensor(cross_mask[shard], torch.float32),
        tensor(send_t, torch.int32))


def partition_operands(part: GraphPartition, rank: int, device="cuda",
                       windows: Optional[Sequence[Optional[WindowedLaneTables]]] = None,
                       ) -> List[ShardTables]:
    """Shard ``rank``'s :class:`ShardTables`, fine level first, on
    ``device`` (JAX ``partition_operands`` / ``partition_operands_nminor``
    for one shard, in the port's slot-major layout: ``adj_sm`` is the
    partition's ``lane_adj``, ``adj_t_sm`` its ``lane_adj_t`` transposed,
    ``mult_rows`` ``fused_mult_rows`` of ``mult`` and ``self_mult``).

    ``windows`` (:func:`build_level_windows`) puts a level on the windowed
    conv: its shard's window tables come along, and the flat K1/K2 tables,
    which that conv never reads, stay on the host (as JAX replaces them by
    dummies: at a million rows they would hold hundreds of MB)."""
    out = []
    for i, lvl in enumerate(part.levels):
        rows = fused_mult_rows(lvl.mult[rank], lvl.self_mult[rank])[:, :, None]
        ex = exchange_tables(lvl.offsets, lvl.send_idx, lvl.recv_mask, lvl.cross_send,
                             lvl.cross_mask, rank, lvl.block, device)
        rows = torch.as_tensor(np.ascontiguousarray(rows), device=device)
        wt = windows[i] if windows is not None else None
        if wt is not None:
            assert wt.has_tail == (not ex.local), (
                "windowed tables' halo pack must match the level's halo")
            arrays = wt.arrays if part.num_shards == 1 else [a[rank] for a in wt.arrays]
            out.append(ShardTables(None, None, rows, ex,
                                   ShardWindows(wt.geometry, window_tensors(arrays, device))))
            continue
        out.append(ShardTables(
            torch.as_tensor(np.ascontiguousarray(lvl.lane_adj[rank]), device=device),
            torch.as_tensor(np.ascontiguousarray(lvl.lane_adj_t[rank].T), device=device),
            rows, ex))
    return out


# ---------------------------------------------------------------------------
# The halo exchange
# ---------------------------------------------------------------------------

def _ring(blocks: Sequence[torch.Tensor], offsets: Sequence[int], group: GraphGroup,
          reverse: bool = False) -> List[torch.Tensor]:
    """One point-to-point pair a ring offset, all in flight at once: block j
    goes to rank − d and the block of the same shape comes from rank + d
    (JAX's ``ppermute`` with ``(src, (src − d) % D)``); ``reverse`` swaps
    the two (the backward). Tag j keeps two offsets between the same pair
    of ranks apart."""
    ops, received = [], []
    for j, (block, d) in enumerate(zip(blocks, offsets)):
        to, frm = (group.rank - d) % group.size, (group.rank + d) % group.size
        if reverse:
            to, frm = frm, to
        buf = torch.empty_like(block)
        ops.append(dist.P2POp(dist.isend, block.contiguous(), group.global_rank(to),
                              group.group, tag=j))
        ops.append(dist.P2POp(dist.irecv, buf, group.global_rank(frm), group.group, tag=j))
        received.append(buf)
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return received


def _all_to_all(rows: torch.Tensor, group: GraphGroup) -> torch.Tensor:
    """[D·Hx, C] rows, block t to rank t → block o from rank o."""
    out = torch.empty_like(rows)
    dist.all_to_all_single(out, rows.contiguous(), group=group.group)
    return out


def _masked(rows: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return rows * mask.reshape(-1, 1).to(rows.dtype)


class _HaloExtend(torch.autograd.Function):
    """[n, C] owned rows → [n + len(offsets)·H (+ D·Hx), C] (JAX
    ``_halo_extend``): per ring offset the rows ``send_idx[j]`` go to rank
    − d and H rows come from rank + d, masked by ``recv_mask[j]``; then the
    cross-host rows in one all-to-all, masked by ``cross_mask``. Inactive
    slots hold zeros. The backward returns each received block's cotangent
    to its sender, by the same collectives reversed, and adds what comes
    back into the owned rows through ``send_t`` (the adjoint of the sends'
    gathers, a gather-sum in a fixed order: no scatter, no atomics)."""

    @staticmethod
    def forward(ctx, x, ex: ExchangeTables, group: GraphGroup):
        ctx.ex, ctx.group, ctx.n = ex, group, x.shape[0]
        parts = [x]
        if ex.offsets:
            sent = [x.index_select(0, ex.send_idx[j]) for j in range(len(ex.offsets))]
            for j, rows in enumerate(_ring(sent, ex.offsets, group)):
                parts.append(_masked(rows, ex.recv_mask[j]))
        if ex.cross_send is not None:
            rows = _all_to_all(x.index_select(0, ex.cross_send.reshape(-1)), group)
            parts.append(_masked(rows, ex.cross_mask))
        return torch.cat(parts, dim=0)

    @staticmethod
    def backward(ctx, g):
        ex, group, n = ctx.ex, ctx.group, ctx.n
        pos, back = n, []
        if ex.offsets:
            h = ex.send_idx.shape[1]
            blocks = [_masked(g[pos + j * h: pos + (j + 1) * h], ex.recv_mask[j])
                      for j in range(len(ex.offsets))]
            pos += len(ex.offsets) * h
            back += _ring(blocks, ex.offsets, group, reverse=True)
        if ex.cross_send is not None:
            back.append(_all_to_all(_masked(g[pos:], ex.cross_mask), group))
        dx = g[:n] + _transpose_sum(torch.cat(back, dim=0), ex.send_t, 0)
        return dx, None, None


def halo_extend(x: torch.Tensor, ex: ExchangeTables, group: GraphGroup) -> torch.Tensor:
    """``x`` [n, C] with the halo rows appended (:class:`_HaloExtend`); ``x``
    itself where nothing is exchanged (one rank)."""
    return x if ex.local else _HaloExtend.apply(x, ex, group)


# ---------------------------------------------------------------------------
# The sharded conv, U-Net, normalization and loss
# ---------------------------------------------------------------------------

def sharded_conv(params, x: torch.Tensor, tables: ShardTables, group: GraphGroup,
                 variant: FacetConvVariant = FacetConvVariant.DEFAULT,
                 compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The facet conv on one shard (JAX ``_sharded_conv`` /
    ``_sharded_conv_rotinv``): :func:`..ops.conv.facet_conv` over the
    shard's tables, with ``cat = [x | x·projᵀ]`` (the raw ``x`` under the
    rotation-invariant variant) halo-extended before K1 (K3) gathers it.
    Degrees are the owned rows' full mult sums, so the bias gate deg > 0 and
    the 1/degree are globally exact. A windowed level (``tables.windows``)
    runs :func:`windowed_conv`."""
    if tables.windows is not None:
        return windowed_conv(params, x, tables, group, variant, compute_dtype)
    extend = None if tables.exchange.local else functools.partial(
        halo_extend, ex=tables.exchange, group=group)
    return facet_conv(params, x, tables.adj_sm, tables.mult_rows, variant=variant,
                      adj_t_sm=tables.adj_t_sm, compute_dtype=compute_dtype, extend=extend)


def windowed_conv(params, x: torch.Tensor, tables: ShardTables, group: GraphGroup,
                  variant: FacetConvVariant = FacetConvVariant.DEFAULT,
                  compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The facet conv of a windowed level (the ``win`` branch of JAX
    ``_sharded_conv_nminor``): ``cat = [x | x·projᵀ]`` in the compute dtype,
    halo-extended first where the level has halo rows, then by default K5
    (:func:`..ops.windowed_conv.make_windowed_fused_conv`: gather, softmax,
    slot sums and the ``[M·C → out]`` product in one pass, ``ux`` in f32);
    with ``_WINDOWED_FUSED`` off the unfused windowed gather
    (:func:`..ops.gather.make_windowed_lane_gather`), K3 (the softmax·mult
    and the slot sums) and the product. The degree-gated bias is added after either. The
    rotation-invariant conv has no windowed form: :func:`build_level_windows`
    keeps its level flat."""
    if FacetConvVariant(variant) == FacetConvVariant.ROTATION_INVARIANT:
        raise NotImplementedError(
            "the windowed conv has no rotation-invariant form (build_level_windows keeps "
            "level 0 flat for that variant)")
    u, c, w, b = params["u"], params["c"], params["w"], params["b"]
    n, in_ch = x.shape
    m, out_ch, _ = w.shape
    win = tables.windows
    translation = FacetConvVariant(variant) == FacetConvVariant.TRANSLATION_INVARIANT
    proj = -u if translation else params["v"]
    cat, ux = torch.cat([x, x @ proj.T], dim=-1), x @ u.T
    if compute_dtype is not None:
        cat = cat.to(compute_dtype)
    if not tables.exchange.local:
        cat = halo_extend(cat, tables.exchange, group)
    rows = tables.mult_rows[:, :, 0]
    wf = w.permute(1, 0, 2).reshape(out_ch, m * in_ch)
    if _WINDOWED_FUSED:
        y = make_windowed_fused_conv(win.geometry)(cat.contiguous(), ux.contiguous(), wf, c,
                                                   rows, *win.arrays)
    else:
        dtype = cat.dtype
        slots = torch.cat([cat[None, :n], make_windowed_lane_gather(win.geometry)(
            cat, *win.arrays)], dim=0)                                 # [K'+1, n, C+M]
        logits = ux.to(dtype)[None] + slots[..., in_ch:] + c.to(dtype)
        z = WeightedAggregate.apply(logits.float().contiguous(), rows.contiguous(),
                                    slots[..., :in_ch].contiguous())
        y = Bf16Matmul.apply(z, wf.to(dtype)) if dtype == torch.bfloat16 else z @ wf.T
    gate = (rows.sum(dim=0) > 0).to(y.dtype)
    return y + b[None, :] * gate[:, None]


def sharded_unet_forward_local(
    params, x: torch.Tensor, tables: Sequence[ShardTables], group: GraphGroup,
    coarsening_steps: int = 2, alpha: float = 0.1, multi_scale: bool = False,
    variant: FacetConvVariant = FacetConvVariant.DEFAULT,
    compute_dtype: Optional[torch.dtype] = None, remat: bool = False,
):
    """The U-Net forward on one shard's rows ``x`` [n, C] (JAX
    ``sharded_unet_forward_local`` / ``..._nminor``): the port's
    :func:`..models.unet._network` over :func:`sharded_conv`, pools and
    unpools shard-local. ``remat`` runs each conv and the fine fc head under
    ``torch.utils.checkpoint``: the backward recomputes each conv's halo
    exchange, K1 and projections instead of keeping their activations. K5's
    convs are not checkpointed (JAX's rule): K5 keeps only its inputs and
    recomputes the rest in its backward already."""
    v_first, v_rest = per_conv_variants(variant)

    def conv(name, h, level):
        def run(p, h):
            return sharded_conv(p, h, tables[level], group,
                                v_first if name == "conv1" else v_rest, compute_dtype)

        if remat and not (tables[level].windows is not None and _WINDOWED_FUSED):
            return checkpoint(run, params[name], h, use_reentrant=False)
        return run(params[name], h)

    return _network(params, x, conv, len(tables), coarsening_steps, alpha, multi_scale,
                    remat_head=remat)


class _AllReduceSum(torch.autograd.Function):
    """Σ over the ranks, differentiated: the cotangent of every rank's input
    is the sum of the ranks' cotangents of the output (JAX's ``psum``)."""

    @staticmethod
    def forward(ctx, t, group: GraphGroup):
        ctx.group = group
        out = t.clone()
        dist.all_reduce(out, group=group.group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group.group)
        return g, None


def all_reduce_sum(t: torch.Tensor, group: GraphGroup) -> torch.Tensor:
    """Σ of ``t`` over the group's ranks (differentiable); ``t`` at one rank."""
    return t if group.size == 1 else _AllReduceSum.apply(t, group)


def sharded_normalize_tensor(x: torch.Tensor, group: GraphGroup,
                             epsilon: float = 1e-5) -> torch.Tensor:
    """``normalize_tensor`` (utils.py:1700-1715) with the mean |x| prescale
    over every rank's rows (JAX ``_sharded_normalize_tensor``)."""
    total = all_reduce_sum(torch.sum(torch.abs(x)), group)
    x = x / (total / float(x.numel() * group.size) + epsilon)
    norm = torch.sqrt(epsilon + torch.sum(x * x, dim=-1))
    inv = torch.where(norm > epsilon, 1.0 / (norm + epsilon), torch.zeros_like(norm))
    return x * inv[..., None]


def sharded_face_normals_loss_share(pred: torch.Tensor, gt: torch.Tensor,
                                    sample_mask: torch.Tensor,
                                    group: GraphGroup) -> torch.Tensor:
    """This rank's share of ``faceNormalsLoss`` (train.py:1272-1294) over
    the ranks: its masked angle sum over the global count of real sampled
    nodes (JAX ``_sharded_face_normals_loss``, whose numerator is the psum
    of these shares). ``sample_mask`` [n] selects the loss faces."""
    ang = torch.acos(torch.clamp(dot_last(pred, gt), -_CLOSE_TO_ONE, _CLOSE_TO_ONE)) * (
        180.0 / math.pi)
    real = torch.where(_fake_node_mask(gt), 0.0, 1.0) * sample_mask
    with torch.no_grad():
        den = torch.sum(real)
        if group.size > 1:
            dist.all_reduce(den, group=group.group)
    return torch.sum(ang * real) / den


def shard_rows(a, group: GraphGroup, dtype=None) -> torch.Tensor:
    """This rank's block of the rows of ``a`` (a host array or tensor of a
    whole graph level), on its device."""
    n = a.shape[0] // group.size
    return torch.as_tensor(a[group.rank * n:(group.rank + 1) * n], dtype=dtype,
                           device=group.device)


def gather_rows(block: torch.Tensor, group: GraphGroup) -> torch.Tensor:
    """Every rank's block, concatenated in rank order, on every rank."""
    if group.size == 1:
        return block
    parts = [torch.empty_like(block) for _ in range(group.size)]
    dist.all_gather(parts, block.contiguous(), group=group.group)
    return torch.cat(parts, dim=0)


def sharded_unet_apply(
    params, x, part: GraphPartition, group: Optional[GraphGroup] = None,
    coarsening_steps: int = 2, normalize: bool = True, multi_scale: bool = False,
    compute_dtype: Optional[torch.dtype] = None,
    variant: FacetConvVariant = FacetConvVariant.DEFAULT, alpha: float = 0.1,
):
    """The full forward over the group (JAX ``sharded_unet_apply``): ``x``
    [N, C] is the whole graph (host order; each rank takes its block), and
    every rank gets the assembled [N, 3] output (a 3-tuple of per-level
    outputs with ``multi_scale``), equal to float tolerance to ``unet_apply``
    + ``normalize_tensor`` on one device. No gradient is taken. Levels that
    :func:`build_level_windows` picks run the windowed conv."""
    group = group or make_mesh()
    tables = partition_operands(part, group.rank, group.device,
                                build_level_windows(part, variant=variant))
    with torch.no_grad():
        y = sharded_unet_forward_local(
            params, shard_rows(x, group, torch.float32), tables, group,
            coarsening_steps=coarsening_steps, alpha=alpha, multi_scale=multi_scale,
            variant=variant, compute_dtype=compute_dtype)
        heads = y if multi_scale else (y,)
        if normalize:
            heads = tuple(sharded_normalize_tensor(h, group) for h in heads)
        heads = tuple(gather_rows(h, group) for h in heads)
    return heads if multi_scale else heads[0]


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------

def _all_reduce_grads(params, group: GraphGroup) -> None:
    """Sum every parameter's gradient over the ranks, in one all-reduce of
    their concatenation (JAX's psum through ``shard_map``'s autodiff)."""
    if group.size == 1:
        return
    leaves = _leaves(params)
    grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in leaves]
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=group.group)
    offset = 0
    for p in leaves:
        p.grad = flat[offset:offset + p.numel()].view_as(p).clone()
        offset += p.numel()


def sample_mask_from(indices, num_nodes: int, group: GraphGroup) -> torch.Tensor:
    """This rank's block of the [num_nodes] loss mask that is 1 at
    ``indices`` (the JAX driver's ``mask[rng.integers(...)] = 1``): the
    span ``fgc.sharded.sample_mask``."""
    with span("fgc.sharded.sample_mask"):
        mask = np.zeros(num_nodes, np.float32)
        mask[np.asarray(indices)] = 1.0
        return shard_rows(mask, group)


def make_sharded_train_step(
    cfg: Config,
    part: GraphPartition,
    group: Optional[GraphGroup] = None,
    remat: bool = False,
):
    """The train step over a partitioned graph (JAX
    ``make_sharded_train_step``): ``step(state, x, gt, sample_mask,
    rot=None) → (state, loss)`` on this rank's blocks ``x`` [n, C], ``gt``
    [n, 3] and ``sample_mask`` [n] (:func:`shard_rows`,
    :func:`sample_mask_from`). Each rank computes its owned nodes' share of
    the global loss and backpropagates it, the exchanges' backwards
    returning the halo cotangents to their owners; one all-reduce sums the
    gradients, then Adam (``training.trainer.adam_update``) updates each
    rank's copy of the parameters alike. The loss returned is the global
    one (0-d, detached, before the update).

    ``rot`` [3, 3] rotates the inputs and the GT first (None: no rotation);
    the caller draws it and the mask alike on every rank
    (:func:`train_normals_sharded` from one seeded generator), so the ranks
    stay in lockstep.
    ``cfg.model.compute_dtype="bfloat16"`` runs the bf16 K1/K2/K3;
    ``remat`` checkpoints each conv and the fc head. ``step.eval(params, x,
    gt, sample_mask)`` is the loss without rotation or gradient, in the
    same compute dtype (JAX's ``.eval``). Collectives are issued in the
    same order on every rank; the step runs eagerly (no CUDA graph). Levels
    that :func:`build_level_windows` picks (by default those of at least
    262,144 rows a shard, RCM-ordered) run the windowed conv, K5 by
    default. The step's phases are the device marks of
    ``utils/profiling.py::marked_step`` and the host spans
    ``fgc.sharded.forward``, ``.backward`` (with ``.grad_all_reduce``
    inside), ``.adam`` and ``.global_loss``."""
    group = group or make_mesh()
    variant, dtype = _config_variant(cfg), compute_dtype(cfg)
    with span("fgc.prep.windows"):
        tables = partition_operands(part, group.rank, group.device,
                                    build_level_windows(part, variant=variant))

    def loss_share(params, x, gt, sample_mask, rot):
        if rot is not None:
            rot = rot.to(group.device)
            x, gt = rotate_inputs(rot, x), rotate_vec3(rot, gt)
        y = sharded_unet_forward_local(
            params, x, tables, group, coarsening_steps=cfg.model.coarsening_steps,
            alpha=cfg.model.lrelu_alpha, variant=variant, compute_dtype=dtype, remat=remat)
        return sharded_face_normals_loss_share(sharded_normalize_tensor(y, group), gt,
                                               sample_mask, group)

    def global_loss(share: torch.Tensor) -> torch.Tensor:
        loss = share.detach().clone()
        if group.size > 1:
            dist.all_reduce(loss, group=group.group)
        return loss

    def step(state: TrainState, x, gt, sample_mask, rot=None):
        def backward(share):
            state.optimizer.zero_grad(set_to_none=True)
            share.backward()
            with span("fgc.sharded.grad_all_reduce"):
                _all_reduce_grads(state.params, group)

        share = marked_step(group.device,
                            lambda: loss_share(state.params, x, gt, sample_mask, rot),
                            backward, lambda: adam_update(state), spans="fgc.sharded")
        with span("fgc.sharded.global_loss"):
            return state, global_loss(share)

    def eval_loss(params, x, gt, sample_mask):
        with torch.no_grad():
            return global_loss(loss_share(params, x, gt, sample_mask, None))

    step.eval = eval_loss
    step.tables = tables
    step.group = group
    return step


def _prepare_sharded_mesh_arrays(cfg: Config, patch, group: GraphGroup):
    """Pad one whole-mesh patch to a multiple of the group's tree-aligned
    block, partition it over the group's ranks (host-aware when torchrun
    says how many ranks share a host) and stage this rank's input and GT
    blocks. Returns ``(part, x, gt, num_nodes)``."""
    align = (2 ** cfg.model.coarsening_steps) ** (cfg.model.coarsening_levels - 1) * group.size
    padded = pad_patch_to(patch, bucket_size(patch.num_nodes, align))
    dph = devices_per_host() if group.size > 1 else None
    part = build_partition(padded.adjs, group.size, devices_per_host=dph)
    with span("fgc.prep.upload"):
        x = shard_rows(padded.inputs, group, torch.float32)
        gt = shard_rows(padded.gt_normals, group, torch.float32)
    return part, x, gt, padded.num_nodes


def sharded_driver_loop(cfg: Config, group: GraphGroup, state: TrainState, num_iterations: int,
                        step_once: Callable[[int], torch.Tensor],
                        validate: Optional[Callable[[], float]], log_every: int,
                        checkpoint: bool, label: str, save_every: Optional[int] = None):
    """The loop of the sharded drivers (JAX ``train_normals_sharded`` and
    its kin): ``step_once(it)`` runs step ``it`` and returns its loss; a
    validation (``validate()``, when given) every ``valid_every``; every
    ``log_every`` steps the mean loss printed by rank 0 and a history row
    ``(mean, last validation)``, aborting on a non-finite mean; a
    checkpoint every ``save_every`` (default ``cfg.train.save_every``),
    aborting instead on a non-finite loss; resume from the latest
    checkpoint before the first step and a final save unless aborted (rank
    0 writes, every rank restores: ``<network_path>/<net_name>/``); the
    history appended to ``<network_path>/<net_name>.csv`` by rank 0.
    Returns ``(state, losses)``; the state is updated in place."""
    save_every = save_every or cfg.train.save_every
    ckpt = CheckpointManager(cfg.train.network_path, cfg.train.net_name) if checkpoint else None
    start_step = 0
    if ckpt is not None:
        state, start_step = ckpt.restore(state)

    def save(it):
        if group.rank == 0:
            ckpt.save(start_step + it, state)

    losses: List[float] = []
    loss_hist: List[Tuple[float, float]] = []
    last_valid = float("nan")
    aborted = False
    for it in range(num_iterations):
        losses.append(float(step_once(it)))
        if validate is not None and it % cfg.train.valid_every == 0:
            last_valid = validate()
        if it % log_every == 0:
            avg = float(np.mean(losses[-log_every:]))
            loss_hist.append((avg, last_valid))
            if group.rank == 0:
                print(f"iter {it}: {label} {avg:.4f}"
                      + (f" valid {last_valid:.4f}" if validate is not None else ""), flush=True)
            if not np.isfinite(avg):
                print("NaN training loss — aborting", flush=True)
                aborted = True
                break
        if ckpt is not None and it > 0 and it % save_every == 0:
            if not np.isfinite(losses[-1]):
                print("NaN training loss — aborting at checkpoint", flush=True)
                aborted = True
                break
            save(it)
    if ckpt is not None and not aborted:
        # a NaN abort leaves the state poisoned: never persist it
        save(num_iterations)
    if group.rank == 0 and loss_hist:
        os.makedirs(cfg.train.network_path, exist_ok=True)
        csv_path = os.path.join(cfg.train.network_path, cfg.train.net_name + ".csv")
        with open(csv_path, "ab") as fh:
            np.savetxt(fh, np.asarray(loss_hist, dtype=np.float64), delimiter=",")
    return state, np.asarray(losses)


def train_normals_sharded(
    cfg: Config,
    patch,
    num_iterations: int,
    group: Optional[GraphGroup] = None,
    valid_patches: Optional[Sequence] = None,
    loss_samples: Optional[int] = None,
    log_every: int = 50,
    seed: int = 0,
    checkpoint: bool = False,
    remat: bool = False,
    device: str = "cuda",
):
    """Train on ONE large partitioned mesh (JAX ``train_normals_sharded``):
    every step is a whole-graph forward over the group's ranks with a fresh
    random sample of loss faces. The same contract as JAX's: rotation in
    the step, checkpoints and resume (``checkpoint=True``: rank 0 writes
    ``<network_path>/<net_name>/step_<k>.pt`` and ``params.pt`` every
    ``save_every``, every rank resumes from the latest), a validation sweep
    over ``valid_patches`` every ``valid_every`` (each partitioned over the
    same group), the NaN abort (no final save then), and the loss history
    ``<network_path>/<net_name>.csv`` appended by rank 0 only
    (:func:`sharded_driver_loop`). Every step's rotation and loss samples,
    and the validation's samples, come from one ``torch.Generator`` seeded
    with ``seed``, alike on every rank, so the ranks stay in lockstep (JAX
    draws them from its key and a NumPy generator: other numbers).
    ``group`` defaults to :func:`..mesh.make_mesh` on ``device`` (CUDA
    unless ``"cpu"``). Returns ``(state, losses)``."""
    group = group or make_mesh(device)
    part, x, gt, n = _prepare_sharded_mesh_arrays(cfg, patch, group)
    state = create_train_state(cfg.replace(train={"seed": seed}), num_steps=num_iterations,
                               device=group.device)
    generator = torch.Generator().manual_seed(seed)
    step = make_sharded_train_step(cfg, part, group, remat=remat)
    valid = []
    for vp in valid_patches or []:
        vpart, vx, vgt, vn = _prepare_sharded_mesh_arrays(cfg, vp, group)
        valid.append((make_sharded_train_step(cfg, vpart, group).eval, vx, vgt, vn))
    samples = loss_samples or cfg.train.loss_samples

    def draw_mask(num_nodes, count):
        idx = torch.randint(0, num_nodes, (count,), generator=generator)
        return sample_mask_from(idx.numpy(), num_nodes, group)

    def step_once(it):
        nonlocal state
        rot = random_rotation(generator) if cfg.train.augment_rotations else None
        state, loss = step(state, x, gt, draw_mask(n, samples), rot=rot)
        return loss

    def validate():
        return sum(float(eval_fn(state.params, vx, vgt, draw_mask(vn, min(samples, vn))))
                   for eval_fn, vx, vgt, vn in valid) / len(valid)

    return sharded_driver_loop(cfg, group, state, num_iterations, step_once,
                               validate if valid else None, log_every, checkpoint,
                               "sharded loss")


# ---------------------------------------------------------------------------
# Several whole meshes through one step's table shapes
# ---------------------------------------------------------------------------

def prepare_sharded_mesh_bank(cfg: Config, patches: Sequence, group: GraphGroup):
    """Partition SEVERAL whole-mesh patches so that one sharded step's table
    shapes serve them all (JAX ``prepare_sharded_mesh_bank``): pad every
    mesh to the common node bucket, partition each (host-aware when
    torchrun says how many ranks share a host), unify each level's exchange
    mode (a level that batches its halo into the all-to-all in any mesh
    does so in all: :func:`merge_geometry` needs one mode), merge the
    levels' :class:`LevelGeometry` (offset union, widest tables) and
    partition again only the meshes whose geometry differs from the merge,
    then gives their windowed levels one window geometry
    (:func:`unify_level_windows`).

    Returns ``(parts, xs, gts, num_nodes)``: each mesh's partition and this
    rank's blocks of its inputs and GT normals."""
    n_dev = group.size
    align = (2 ** cfg.model.coarsening_steps) ** (cfg.model.coarsening_levels - 1)
    target = max(bucket_size(p.num_nodes, align * n_dev) for p in patches)
    padded = [pad_patch_to(p, target) for p in patches]
    dph = devices_per_host() if n_dev > 1 else None
    parts = [build_partition(pp.adjs, n_dev, devices_per_host=dph) for pp in padded]
    for i in range(len(parts[0].levels)):
        if any(pt.levels[i].cross_send is not None for pt in parts):
            for m, pt in enumerate(parts):
                if pt.levels[i].cross_send is None:
                    pt.levels[i] = _partition_level(np.asarray(padded[m].adjs[i]), n_dev,
                                                    dph or 1)
    geoms = [level_geometry(lvl) for lvl in parts[0].levels]
    for pt in parts[1:]:
        geoms = [merge_geometry(g, level_geometry(lvl)) for g, lvl in zip(geoms, pt.levels)]
    for m, pt in enumerate(parts):
        if any(level_geometry(lvl) != g for lvl, g in zip(pt.levels, geoms)):
            parts[m] = build_partition(padded[m].adjs, n_dev, devices_per_host=dph,
                                       geometry=geoms)
    unify_level_windows(parts, variant=_config_variant(cfg))
    with span("fgc.prep.upload"):
        xs = [shard_rows(pp.inputs, group, torch.float32) for pp in padded]
        gts = [shard_rows(pp.gt_normals, group, torch.float32) for pp in padded]
    return parts, xs, gts, target


def table_shapes(tables: Sequence[ShardTables]) -> List[Tuple]:
    """The shape and dtype of every tensor of a rank's tables, in order, and
    each level's offsets and window geometry (the port's form of JAX's
    operand-pytree signature)."""
    out = []
    for t in tables:
        ex = t.exchange
        win = t.windows.arrays if t.windows is not None else ()
        for a in (t.adj_sm, t.adj_t_sm, t.mult_rows, ex.send_idx, ex.recv_mask, ex.cross_send,
                  ex.cross_mask, ex.send_t, *win):
            out.append(None if a is None else (tuple(a.shape), a.dtype))
        out.append(ex.offsets)
        out.append(None if t.windows is None else t.windows.geometry)
    return out


def train_normals_sharded_multi(
    cfg: Config,
    patches: Sequence,
    num_iterations: int,
    group: Optional[GraphGroup] = None,
    loss_samples: Optional[int] = None,
    log_every: int = 50,
    seed: int = 0,
    checkpoint: bool = False,
    remat: bool = False,
    device: str = "cuda",
):
    """Dataset-scale sharded training (JAX ``train_normals_sharded_multi``):
    SEVERAL large partitioned meshes cycled in one driver call, a random
    mesh a step (the reference's random patch per iteration, train.py:558,
    with each "patch" a whole partitioned mesh). The meshes come from
    :func:`prepare_sharded_mesh_bank`; each has its step
    (:func:`make_sharded_train_step` over its partition), all updating one
    state. JAX's assertion that one compiled executable serves every mesh
    becomes this: every mesh's :class:`ShardTables` have the same shapes
    and offsets as the first's (:func:`table_shapes`), asserted before the
    first step. The driver contract is :func:`train_normals_sharded`'s (no
    validation); each step's mesh, rotation and loss samples come from one
    ``torch.Generator`` seeded with ``seed``, alike on every rank. Returns
    ``(state, losses)``."""
    group = group or make_mesh(device)
    parts, xs, gts, n = prepare_sharded_mesh_bank(cfg, patches, group)
    state = create_train_state(cfg.replace(train={"seed": seed}), num_steps=num_iterations,
                               device=group.device)
    steps = [make_sharded_train_step(cfg, pt, group, remat=remat) for pt in parts]
    want = table_shapes(steps[0].tables)
    for m, st in enumerate(steps[1:], 1):
        assert table_shapes(st.tables) == want, (
            f"mesh {m}: its tables' shapes differ from mesh 0's")
    generator = torch.Generator().manual_seed(seed)
    samples = loss_samples or cfg.train.loss_samples

    def step_once(it):
        nonlocal state
        m = int(torch.randint(0, len(steps), (1,), generator=generator))
        rot = random_rotation(generator) if cfg.train.augment_rotations else None
        idx = torch.randint(0, n, (samples,), generator=generator)
        state, loss = steps[m](state, xs[m], gts[m], sample_mask_from(idx.numpy(), n, group),
                               rot=rot)
        return loss

    return sharded_driver_loop(cfg, group, state, num_iterations, step_once, None, log_every,
                               checkpoint, "sharded multi-mesh loss")
