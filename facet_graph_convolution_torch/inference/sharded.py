"""Whole-mesh sharded inference: no patch cutting, no overlap averaging (the
port's counterpart of ``facet_graph_convolution_tpu/inference/sharded.py``,
its ``infer_normals_sharded``).

The reference splits big meshes into BFS patches and averages overlapping
predictions (train.py:123-126) because one GPU cannot hold the whole graph.
With the halo-exchange runtime (:mod:`..parallel.halo`) the whole facet
graph is partitioned over the group's ranks and predicted in ONE exact
forward, whose shard boundaries reproduce the unsharded math — on one H100
a million-face mesh fits whole. ``infer_with_vertices_sharded`` (the
multi-scale solver's form) is not ported yet (``inference.NOT_YET_PORTED``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from facet_graph_convolution_torch.config import Config
from facet_graph_convolution_torch.data.dataset import bucket_size, pad_patch_to
from facet_graph_convolution_torch.geometry.mesh_math import normalize_rows
from facet_graph_convolution_torch.parallel.halo import build_partition, sharded_unet_apply
from facet_graph_convolution_torch.parallel.mesh import GraphGroup, make_mesh
from facet_graph_convolution_torch.parallel.vertex_halo import sharded_update_positions_edges


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
    if len(mesh_data.patches) != 1:
        raise ValueError("sharded inference takes the whole mesh as one patch; raise "
                         "max_patch_size")
    patch = mesh_data.patches[0]
    group = group or make_mesh(device)
    align = (2 ** cfg.model.coarsening_steps) ** (cfg.model.coarsening_levels - 1) * group.size
    padded = pad_patch_to(patch, bucket_size(patch.num_nodes, align))
    part = build_partition(padded.adjs, group.size)
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
