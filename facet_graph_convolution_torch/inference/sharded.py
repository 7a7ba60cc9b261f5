"""Whole-mesh sharded inference: no patch cutting, no overlap averaging (the
port's counterpart of ``facet_graph_convolution_tpu/inference/sharded.py``).

The reference splits big meshes into BFS patches and averages overlapping
predictions (train.py:123-126) because one GPU cannot hold the whole graph.
With the halo-exchange runtime (:mod:`..parallel.halo`) the whole facet
graph is partitioned over the group's ranks and predicted in ONE exact
forward, whose shard boundaries reproduce the unsharded math — on one H100
a million-face mesh fits whole. :func:`infer_normals_sharded` refines the
vertices with the sharded edge solver; :func:`infer_with_vertices_sharded`
runs the three heads and the sharded multi-scale solver.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from facet_graph_convolution_torch.config import Config
from facet_graph_convolution_torch.data.dataset import bucket_size, pad_patch_to
from facet_graph_convolution_torch.geometry.mesh_math import normalize_rows
from facet_graph_convolution_torch.ops.normalization import normalize_tensor
from facet_graph_convolution_torch.ops.pooling import tree_unpool
from facet_graph_convolution_torch.parallel.halo import build_partition, sharded_unet_apply
from facet_graph_convolution_torch.parallel.mesh import GraphGroup, make_mesh
from facet_graph_convolution_torch.parallel.vertex_halo import (
    sharded_update_positions_edges,
    sharded_update_positions_multiscale,
)


def _whole_patch(mesh_data):
    if len(mesh_data.patches) != 1:
        raise ValueError("sharded inference takes the whole mesh as one patch; raise "
                         "max_patch_size")
    return mesh_data.patches[0]


def _partitioned(cfg: Config, patch, group: GraphGroup):
    """The patch padded to a multiple of the group's tree-aligned block, and
    its partition over the group's ranks."""
    align = (2 ** cfg.model.coarsening_steps) ** (cfg.model.coarsening_levels - 1) * group.size
    padded = pad_patch_to(patch, bucket_size(patch.num_nodes, align))
    return padded, build_partition(padded.adjs, group.size)


def infer_normals_sharded(
    mesh_data,
    cfg: Config,
    params,
    group: Optional[GraphGroup] = None,
    solver_iterations: Optional[int] = None,
    device: str = "cuda",
) -> Tuple[np.ndarray, np.ndarray]:
    """Predict the facet normals of a whole mesh over the group's ranks,
    then refine its vertices with the sharded edge-map solver. ``mesh_data``
    (an :class:`..data.dataset.InferenceMesh`) must hold ONE patch
    (``max_patch_size`` ≥ F: the point of sharding is not to cut the mesh);
    ``params`` are on the group's device. Returns ``(vertices, normals)`` on
    every rank, as :func:`..inference.driver.infer_normals` does. ``group``
    defaults to :func:`..parallel.mesh.make_mesh` on ``device`` (CUDA unless
    ``"cpu"``)."""
    patch = _whole_patch(mesh_data)
    group = group or make_mesh(device)
    padded, part = _partitioned(cfg, patch, group)
    out = sharded_unet_apply(params, padded.inputs, part, group,
                             coarsening_steps=cfg.model.coarsening_steps,
                             alpha=cfg.model.lrelu_alpha).cpu().numpy()
    if patch.perm_inv is not None:
        out = out[patch.perm_inv]
    normals = normalize_rows(out[: patch.num_real].astype(np.float32))
    refined = sharded_update_positions_edges(
        mesh_data.vertices, normals, mesh_data.edge_map, mesh_data.v_e_map, group,
        iter_num=solver_iterations or cfg.eval.solver_iterations,
        lmbd=1.0 / 18.0 if cfg.eval.solver_lambda == "reference" else cfg.eval.solver_lambda,
        adaptive_tol=cfg.eval.solver_adaptive_tol, trust=cfg.eval.solver_trust)
    return refined, normals


def infer_with_vertices_sharded(
    mesh_data,
    cfg: Config,
    params,
    group: Optional[GraphGroup] = None,
    device: str = "cuda",
) -> Dict[str, np.ndarray]:
    """Whole-mesh multi-scale inference over the group's ranks (JAX
    ``infer_with_vertices_sharded``, the sharded counterpart of
    :func:`..inference.driver.infer_with_vertices`): the halo-exchange
    forward with the three heads (:func:`..parallel.halo.sharded_unet_apply`
    with ``multi_scale``), then the sharded multi-scale solver
    (:func:`..parallel.vertex_halo.sharded_update_positions_multiscale`,
    the naive form whatever ``cfg.eval.vertex_solver`` says, as JAX's).
    ``mesh_data`` is an :class:`..data.dataset.InferenceMesh` built by
    ``add_mesh_with_vertices`` with ONE patch. Returns the fine, mid and
    coarse points [V, 3] (in the patch's frame: the input scaled by its
    bounding-box diagonal, as ``infer_with_vertices`` gives them) and the
    three normal sets [F, 3] in the input's face order (``perm_inv``).
    ``group`` defaults to :func:`..parallel.mesh.make_mesh` on ``device``."""
    patch = _whole_patch(mesh_data)
    group = group or make_mesh(device)
    padded, part = _partitioned(cfg, patch, group)
    steps = cfg.model.coarsening_steps
    n0, n1, n2 = sharded_unet_apply(params, padded.inputs, part, group, coarsening_steps=steps,
                                    alpha=cfg.model.lrelu_alpha, multi_scale=True)
    # the solver's normals match the unpadded patch's faces, level by level
    fn = [n0[:patch.num_nodes], n1[:patch.num_nodes // 2 ** steps],
          n2[:patch.num_nodes // 4 ** steps]]
    refined, dx = sharded_update_positions_multiscale(
        patch.vertices, [t.cpu().numpy() for t in fn], patch.faces, patch.v_faces, group,
        coarsening_steps=steps, iter_nums=cfg.eval.ms_solver_iterations)
    refined_mid = refined - dx[2]
    with torch.no_grad():
        up1 = normalize_tensor(tree_unpool(fn[1], steps)).cpu().numpy()
        up2 = normalize_tensor(tree_unpool(fn[2], 2 * steps)).cpu().numpy()

    def reorder(vals):
        return vals[patch.perm_inv][:patch.num_real]

    return {
        "points": refined.astype(np.float32),
        "points_mid": refined_mid.astype(np.float32),
        "points_coarse": (refined_mid - dx[1]).astype(np.float32),
        "fine_normals": reorder(fn[0].cpu().numpy()),
        "mid_normals": reorder(up1),
        "coarse_normals": reorder(up2),
    }
