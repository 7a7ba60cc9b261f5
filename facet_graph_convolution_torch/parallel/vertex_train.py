"""Sharded end-to-end vertex training: the chamfer loss through the vertex
solver over one partitioned mesh (the port's counterpart of
``facet_graph_convolution_tpu/parallel/vertex_train.py``).

The graph-parallel form of the reference ``trainAccuracyNet``
(train.py:636-914): the three-head halo-exchange forward
(:func:`.halo.sharded_unet_forward_local` with ``multi_scale``, K1/K2 on
halo-extended sources), each head normalized over the ranks, the sharded
multi-scale solver on the live normals (:func:`.vertex_halo.
multiscale_solver_local_operator` or :func:`.vertex_halo.
multiscale_solver_local`, by ``cfg.eval.vertex_solver``; gradients through
every exchange), then the sampled chamfer loss with sharded distance
reductions.

Sampling parity: the refined vertices are all-gathered once a step (small,
[V, 3]), so the global sample indices pick the single-device trainer's
points; the distances to the FULL sets stay sharded, each rank's minimum
over its rows, then the minimum over the ranks. Every rank computes the
same loss and backpropagates its 1/D share through collectives whose
backward sums over the ranks (the gathers' backward is a sum then the
rank's block), and one all-reduce sums the gradients: the step's update
takes the gradient of the loss at every D. (JAX's step takes D times it:
inside ``shard_map`` each device's gradient of a replicated parameter is
already summed over the devices before its ``pmean``; Adam's update hides
the scale.)
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from facet_graph_convolution_torch.config import Config
from facet_graph_convolution_torch.data.dataset import bucket_size, pad_patch_to
from facet_graph_convolution_torch.models.augment import (
    random_rotation,
    rotate_inputs,
    rotate_vec3,
)
from facet_graph_convolution_torch.models.losses import _pairwise_dist, _threshold
from facet_graph_convolution_torch.parallel.halo import (
    GraphPartition,
    _all_reduce_grads,
    build_partition,
    gather_rows,
    partition_operands,
    shard_rows,
    sharded_driver_loop,
    sharded_normalize_tensor,
    sharded_unet_forward_local,
)
from facet_graph_convolution_torch.parallel.mesh import GraphGroup, make_mesh
from facet_graph_convolution_torch.parallel.vertex_halo import (
    OperatorSolverOperands,
    multiscale_solver_local,
    multiscale_solver_local_operator,
    prepare_multiscale_solver,
    prepare_multiscale_solver_operator,
)
from facet_graph_convolution_torch.training.trainer import (
    TrainState,
    _config_variant,
    adam_update,
    create_train_state,
)
from facet_graph_convolution_torch.utils.profiling import span

ACCURACY_THRESHOLD = 5000.0          # the chamfer's thresholds (JAX's acc_thresh)
GT_SENTINEL = 1e9                    # padded GT rows: far away, never a minimum


def prepare_vertex_training(patch, cfg: Config, num_shards: int):
    """Pad the patch's graph, vertex and GT spaces for ``num_shards`` ranks
    and build the partitions (JAX ``prepare_vertex_training``): the graph to
    a multiple of D × (2^steps)^(levels−1) nodes, the vertices and GT points
    to multiples of D (pad vertices masked, pad GT rows at a far sentinel),
    the faces with −1 rows to the padded node count. The solver's operands
    follow ``cfg.eval.vertex_solver``: ``"operator"`` (deduped tables, the
    static centre operator and the hoisted projector) or ``"naive"`` (the
    per-slot body: corners, centroids and K4 pools every iteration).
    Returns ``(arrays, conv_part, solver_ops)``, ``arrays`` a dict of host
    arrays of the whole patch (``x``, ``vertices``, ``v_mask``, ``gt``,
    ``gt_mask``) and the counts ``num_vertices`` and ``num_gt``."""
    if cfg.eval.vertex_solver not in ("operator", "naive"):
        raise ValueError(f"unknown vertex_solver {cfg.eval.vertex_solver!r} "
                         "(use 'operator' or 'naive')")
    group = 2 ** cfg.model.coarsening_steps
    align = group ** (cfg.model.coarsening_levels - 1) * num_shards
    padded = pad_patch_to(patch, bucket_size(patch.num_nodes, align))
    conv_part = build_partition(padded.adjs, num_shards)

    v = patch.vertices.shape[0]
    v_pad = (-v) % num_shards
    vertices = np.concatenate([patch.vertices, np.zeros((v_pad, 3), np.float32)])
    v_mask = np.concatenate([np.ones(v, np.float32), np.zeros(v_pad, np.float32)])
    v_faces = np.concatenate([patch.v_faces.astype(np.int64),
                              np.full((v_pad, patch.v_faces.shape[1]), -1, np.int64)])
    g = patch.gt_vertices.shape[0]
    g_pad = (-g) % num_shards
    gt = np.concatenate([patch.gt_vertices, np.full((g_pad, 3), GT_SENTINEL, np.float32)])
    gt_mask = np.concatenate([np.ones(g, np.float32), np.zeros(g_pad, np.float32)])
    faces = np.concatenate([patch.faces.astype(np.int64),
                            np.full((padded.num_nodes - patch.faces.shape[0], 3), -1, np.int64)])
    prep = (prepare_multiscale_solver_operator if cfg.eval.vertex_solver == "operator"
            else prepare_multiscale_solver)
    solver_ops = prep([padded.num_nodes // group ** s
                       for s in range(cfg.model.coarsening_levels)],
                      faces, v_faces, vertices.shape[0], num_shards,
                      coarsening_steps=cfg.model.coarsening_steps)
    arrays = {"x": padded.inputs, "vertices": vertices.astype(np.float32), "v_mask": v_mask,
              "gt": gt.astype(np.float32), "gt_mask": gt_mask, "num_vertices": v,
              "num_gt": g}
    return arrays, conv_part, solver_ops


class VertexShard(NamedTuple):
    """One rank's tensors of :func:`prepare_vertex_training`'s arrays: its
    blocks of the inputs, vertices, vertex mask, GT points and GT mask, and
    the whole GT point set (the completeness samples are drawn from it)."""

    x: torch.Tensor                  # [n, 6]
    vertices: torch.Tensor           # [vb, 3]
    v_mask: torch.Tensor             # [vb]
    gt: torch.Tensor                 # [gb, 3]
    gt_mask: torch.Tensor            # [gb]
    gt_points: torch.Tensor          # [num_gt, 3]
    num_vertices: int
    num_gt: int


def vertex_shard(arrays: Dict, group: GraphGroup) -> VertexShard:
    """This rank's :class:`VertexShard` of ``arrays``, on its device: an
    upload of set-up, the span ``fgc.prep.upload``."""
    with span("fgc.prep.upload"):
        return VertexShard(
            shard_rows(arrays["x"], group, torch.float32),
            shard_rows(arrays["vertices"], group), shard_rows(arrays["v_mask"], group),
            shard_rows(arrays["gt"], group), shard_rows(arrays["gt_mask"], group),
            torch.as_tensor(arrays["gt"][:arrays["num_gt"]], device=group.device),
            int(arrays["num_vertices"]), int(arrays["num_gt"]))


class _AllGatherRows(torch.autograd.Function):
    """Every rank's block concatenated in rank order; the backward sums the
    ranks' cotangents and returns this rank's block (JAX's ``all_gather``,
    whose transpose is ``psum_scatter``)."""

    @staticmethod
    def forward(ctx, block, group: GraphGroup):
        ctx.group, ctx.n = group, block.shape[0]
        return gather_rows(block, group)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group.group)
        r, n = ctx.group.rank, ctx.n
        return g[r * n:(r + 1) * n], None


def all_gather_rows(block: torch.Tensor, group: GraphGroup) -> torch.Tensor:
    """:class:`_AllGatherRows` (``block`` itself at one rank)."""
    return block if group.size == 1 else _AllGatherRows.apply(block, group)


def sharded_chamfer_loss(refined: torch.Tensor, shard: VertexShard, gt_block: torch.Tensor,
                         sp1: torch.Tensor, idx0: torch.Tensor,
                         group: GraphGroup) -> torch.Tensor:
    """The reference ``fullLoss`` (``models/losses.py::full_chamfer_loss``)
    over the ranks: precision of the sampled refined points
    ``refined_all[idx0]`` against every GT row (each rank its block
    ``gt_block``, pad rows masked), completeness of the sampled GT points
    ``sp1`` against every refined row (each rank its ``refined`` block, pad
    vertices masked); each minimum over a rank's rows, then over the ranks;
    thresholded, ×1000. The same value on every rank."""
    sp0 = all_gather_rows(refined, group)[idx0]
    d0 = torch.where(shard.gt_mask[None, :] > 0, _pairwise_dist(sp0, gt_block), torch.inf)
    prec = torch.amin(all_gather_rows(torch.amin(d0, dim=1)[None], group), dim=0)
    d1 = torch.where(shard.v_mask[None, :] > 0, _pairwise_dist(sp1, refined), torch.inf)
    comp = torch.amin(all_gather_rows(torch.amin(d1, dim=1)[None], group), dim=0)
    return 1000.0 * (torch.mean(_threshold(prec, ACCURACY_THRESHOLD))
                     + torch.mean(_threshold(comp, ACCURACY_THRESHOLD)))


def make_sharded_vertex_train_step(
    cfg: Config,
    conv_part: GraphPartition,
    solver_ops,
    group: Optional[GraphGroup] = None,
):
    """The graph-parallel end-to-end step (JAX
    ``make_sharded_vertex_train_step``): ``step(state, shard, idx0, idx1,
    rot=None) → (state, loss)`` on this rank's :class:`VertexShard`, with
    ``idx0`` / ``idx1`` GLOBAL sample indices into the refined vertices and
    the GT points (train.py:781, 1373) and ``rot`` [3, 3] the rotation of
    the inputs, vertices and GT (None: none). The caller draws all three
    alike on every rank (:func:`train_with_vertices_sharded` from one
    seeded generator); the step draws nothing. The loss is the global one
    (0-d, detached, before the update), the update Adam's on the gradients
    summed over the ranks. ``step.eval(params, shard, idx0, idx1)`` is the
    loss without rotation or gradient. Collectives are issued in one order
    on every rank; the step runs eagerly."""
    group = group or make_mesh()
    dev = group.device
    with span("fgc.prep.windows"):
        tables = partition_operands(conv_part, group.rank, dev)
    sop = solver_ops.rank_operands(group.rank, dev)
    solver = (multiscale_solver_local_operator
              if isinstance(solver_ops, OperatorSolverOperands) else multiscale_solver_local)
    variant = _config_variant(cfg)

    def loss_fn(params, shard: VertexShard, idx0, idx1, rot):
        x, verts, gt_block = shard.x, shard.vertices, shard.gt
        sp1 = shard.gt_points[idx1.to(dev)]
        if rot is not None:
            rot = rot.to(dev)
            x, verts, sp1 = rotate_inputs(rot, x), rotate_vec3(rot, verts), rotate_vec3(rot, sp1)
            gt_block = torch.where(shard.gt_mask[:, None] > 0, rotate_vec3(rot, gt_block),
                                   gt_block)
        heads = sharded_unet_forward_local(
            params, x, tables, group, coarsening_steps=cfg.model.coarsening_steps,
            alpha=cfg.model.lrelu_alpha, multi_scale=True, variant=variant)
        normals = [sharded_normalize_tensor(h, group) for h in heads]
        refined, _ = solver(verts, normals, sop, group, cfg.model.coarsening_steps,
                            cfg.eval.ms_solver_iterations)
        return sharded_chamfer_loss(refined, shard, gt_block, sp1, idx0.to(dev), group)

    def step(state: TrainState, shard: VertexShard, idx0, idx1, rot=None):
        loss = loss_fn(state.params, shard, idx0, idx1, rot)
        state.optimizer.zero_grad(set_to_none=True)
        (loss / group.size).backward()
        _all_reduce_grads(state.params, group)
        return adam_update(state), loss.detach()

    def eval_loss(params, shard: VertexShard, idx0, idx1):
        with torch.no_grad():
            return loss_fn(params, shard, idx0, idx1, None)

    step.eval = eval_loss
    step.loss = loss_fn
    return step


def train_with_vertices_sharded(
    cfg: Config,
    patch,
    num_iterations: int,
    group: Optional[GraphGroup] = None,
    valid_patches: Optional[Sequence] = None,
    seed: int = 0,
    log_every: int = 10,
    checkpoint: bool = False,
    device: str = "cuda",
) -> Tuple[TrainState, np.ndarray]:
    """Graph-parallel end-to-end vertex training driver (JAX
    ``train_with_vertices_sharded``; the sharded counterpart of
    ``training.trainer.train_with_vertices``): one large partitioned mesh,
    the chamfer-through-solver loss each step, rotation augmentation
    (``cfg.train.augment_rotations``), ``torch.save`` checkpoints every
    ``min(save_every, 500)`` steps (the reference's 500) and a resume from
    the latest, a validation over ``valid_patches`` every ``valid_every``
    (each partitioned over the same group, evaluated without rotation), the
    loss-history CSV and the NaN abort (no final save then), as
    :func:`.halo.sharded_driver_loop` runs them. Each step's rotation, then
    its ``chamfer_samples`` vertex and GT indices, and the validation's
    indices, come from one ``torch.Generator`` seeded with ``seed``, drawn
    here once and alike on every rank (JAX draws them from its key and a
    NumPy generator: other numbers). Returns ``(state, losses)``."""
    group = group or make_mesh(device)
    arrays, conv_part, solver_ops = prepare_vertex_training(patch, cfg, group.size)
    shard = vertex_shard(arrays, group)
    state = create_train_state(cfg.replace(train={"seed": seed}), device=group.device,
                               multi_scale=True)
    step = make_sharded_vertex_train_step(cfg, conv_part, solver_ops, group)
    valid = []
    for vp in valid_patches or []:
        v_arrays, v_part, v_ops = prepare_vertex_training(vp, cfg, group.size)
        valid.append((make_sharded_vertex_train_step(cfg, v_part, v_ops, group).eval,
                      vertex_shard(v_arrays, group)))
    generator = torch.Generator().manual_seed(seed)
    samples = cfg.train.chamfer_samples

    def draw(s: VertexShard):
        return (torch.randint(0, s.num_vertices, (samples,), generator=generator),
                torch.randint(0, s.num_gt, (samples,), generator=generator))

    def step_once(it):
        nonlocal state
        rot = random_rotation(generator) if cfg.train.augment_rotations else None
        state, loss = step(state, shard, *draw(shard), rot=rot)
        return loss

    def validate():
        return sum(float(eval_fn(state.params, s, *draw(s))) for eval_fn, s in valid) / len(valid)

    return sharded_driver_loop(cfg, group, state, num_iterations, step_once,
                               validate if valid else None, log_every, checkpoint,
                               "sharded vertex loss", save_every=min(cfg.train.save_every, 500))
