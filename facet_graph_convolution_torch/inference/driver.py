"""Inference drivers (counterparts of
``facet_graph_convolution_tpu/inference/driver.py``; reference
``inferNetOld`` train.py:29-144, ``inferNet`` train.py:148-376 and
``infer.py:32-123``).

- :func:`infer_normals`: the U-Net forward on each patch, the outputs mapped
  back to mesh order, overlapping patches summed and normalized, then the
  edge-map solver over the whole mesh;
- :func:`infer_with_vertices`: the three-head forward on each patch, the
  multi-scale vertex solver per patch (the operator form or the naive one,
  per ``cfg.eval.vertex_solver``), normals assigned per face and points
  averaged over the patches;
- :func:`infer_directory`: either pipeline over a directory of OBJ files.

The forward is the kernel configuration
(:func:`facet_graph_convolution_torch.models.unet.unet_apply`).
"""

from __future__ import annotations

import os
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from facet_graph_convolution_torch import params as params_io
from facet_graph_convolution_torch.config import Config, default_config, resolve_device
from facet_graph_convolution_torch.data.dataset import InferenceMesh
from facet_graph_convolution_torch.geometry.mesh_math import normalize_rows
from facet_graph_convolution_torch.geometry.obj_io import (
    colored_mesh,
    load_obj,
    normals_to_colors,
    write_obj,
)
from facet_graph_convolution_torch.models.unet import graph_tensors, unet_apply
from facet_graph_convolution_torch.ops.normalization import normalize_tensor
from facet_graph_convolution_torch.ops.pooling import tree_unpool
from facet_graph_convolution_torch.ops.vertex_update import (
    build_solver_tables,
    update_positions_edges,
    update_positions_multiscale,
    update_positions_multiscale_operator,
)

MULTI_SCALE_HEADS = ("fc_mid", "out1", "fc_coarse", "out2")


def _restore_params(cfg: Config, device: torch.device):
    path = params_io.checkpoint_path(cfg.train.network_path, cfg.train.net_name)
    if not os.path.isfile(path):
        raise FileNotFoundError(
            f"no checkpoint at {path} (the reference hard-errors here too, "
            "train.py:82-87)")
    return params_io.load(path, device=str(device))


def _require_heads(params) -> None:
    missing = [name for name in MULTI_SCALE_HEADS if name not in params]
    if missing:
        raise ValueError(
            f"the vertex pipeline needs a multi-scale network; these parameters lack the "
            f"head layers {missing} (a normals-only checkpoint cannot serve "
            "--include_vertices)")


def _require_default_conv1(params) -> None:
    """Raises unless every conv is the default variant, naming the variant
    from the keys: a translation-invariant network has no ``v`` in any conv
    (v = -u there), a rotation-invariant one none in conv1 only. Neither
    package serves either: the JAX package's inference drivers run the
    default variant."""
    convs = [layer for layer, p in params.items() if "u" in p]
    if all("v" not in params[layer] for layer in convs):
        raise ValueError(
            "these parameters hold a translation-invariant network (no 'v' in any conv): "
            "serving a translation-invariant network is not supported, here or in the JAX "
            "package, whose inference drivers run the default variant")
    if "v" not in params["conv1"]:
        raise ValueError(
            "these parameters hold a rotation-invariant conv1 (no 'v'): serving a "
            "rotation-invariant network is not supported, here or in the JAX package, "
            "whose inference drivers run the default variant")


def forward_patch(params, patch, cfg: Config, device: torch.device, multi_scale: bool = False):
    """Normalized U-Net output of one patch, [N, 3] on ``device``, tree
    order (fake nodes included); with ``multi_scale``, the three heads
    ``(fine [N, 3], mid [N/4^s, 3], coarse)``, each normalized."""
    adjs, rows = graph_tensors(patch.adjs, device)
    x = torch.as_tensor(patch.inputs, device=device)
    y = unet_apply(params, x, adjs, rows, coarsening_steps=cfg.model.coarsening_steps,
                   alpha=cfg.model.lrelu_alpha, multi_scale=multi_scale)
    if multi_scale:
        return tuple(normalize_tensor(head) for head in y)
    return normalize_tensor(y)


def predict_normals(mesh, cfg: Config, params, device: torch.device) -> np.ndarray:
    """Per-face predicted normals of the whole mesh: patch outputs mapped to
    mesh order, summed where patches overlap (train.py:123-126), then
    normalized; the sum is taken in float64 on the host."""
    num_faces = mesh.faces.shape[0] if mesh.faces is not None else max(
        int(np.max(p.patch_indices)) + 1 for p in mesh.patches
    )
    predicted = np.zeros((num_faces, 3), np.float64)
    with torch.no_grad():
        for patch in mesh.patches:
            out = forward_patch(params, patch, cfg, device).cpu().numpy()
            if patch.perm_inv is not None:
                out = out[patch.perm_inv]
            predicted[patch.patch_indices] += out[: patch.num_real]
    return normalize_rows(predicted.astype(np.float32))


def solve_vertices(mesh, cfg: Config, normals: np.ndarray, device: torch.device,
                   solver_iterations: Optional[int] = None) -> Tuple[np.ndarray, int]:
    """Edge-map solver over the whole mesh; returns (vertices, iterations)."""
    with torch.no_grad():
        refined, iters = update_positions_edges(
            torch.as_tensor(mesh.vertices, device=device),
            torch.as_tensor(normals, device=device),
            torch.as_tensor(mesh.edge_map, device=device),
            torch.as_tensor(mesh.v_e_map, device=device),
            iter_num=solver_iterations or cfg.eval.solver_iterations,
            lmbd=(1.0 / 18.0 if cfg.eval.solver_lambda == "reference"
                  else cfg.eval.solver_lambda),
            adaptive_tol=cfg.eval.solver_adaptive_tol,
            trust=cfg.eval.solver_trust,
        )
        return refined.cpu().numpy(), iters


def infer_normals(
    mesh,
    cfg: Config,
    params=None,
    solver_iterations: Optional[int] = None,
    device: str = "cuda",
) -> Tuple[np.ndarray, np.ndarray]:
    """Predict facet normals patch by patch and solve the vertex positions
    over the edge map. ``mesh`` is an :class:`InferenceMesh` (or any object
    with its fields). Returns (updated vertices [V,3], predicted normals
    [F,3]). Runs on CUDA unless ``device="cpu"``."""
    dev = resolve_device(device)
    params = params if params is not None else _restore_params(cfg, dev)
    predicted = predict_normals(mesh, cfg, params, dev)
    refined, _ = solve_vertices(mesh, cfg, predicted, dev, solver_iterations)
    return refined, predicted


def solver_tables(cfg: Config, patch, device: torch.device):
    """Static tables of the operator solver for one vertex patch
    (``facet_graph_convolution_tpu/training/trainer.py::_solver_tables``)."""
    return build_solver_tables(
        patch.v_faces, [a.shape[0] for a in patch.adjs], patch.vertices.shape[0],
        coarsening_steps=cfg.model.coarsening_steps, faces=patch.faces, device=device)


def solve_patch(patch, cfg: Config, heads, device: torch.device):
    """The multi-scale solver over one vertex patch, from its three
    normalized heads; returns ``(x [V, 3], [dx coarse, dx mid, dx fine])``
    on ``device``. ``cfg.eval.vertex_solver`` picks the operator form
    (static tables, no pooling) or the naive one (face centres pooled by K4
    every iteration)."""
    kw = dict(coarsening_steps=cfg.model.coarsening_steps,
              iter_nums=cfg.eval.ms_solver_iterations)
    x = torch.as_tensor(patch.vertices, device=device)
    faces = torch.as_tensor(patch.faces, device=device)
    v_faces = torch.as_tensor(patch.v_faces, device=device)
    with torch.no_grad():
        if cfg.eval.vertex_solver == "operator":
            return update_positions_multiscale_operator(
                x, list(heads), faces, v_faces, solver_tables(cfg, patch, device), **kw)
        if cfg.eval.vertex_solver == "naive":
            return update_positions_multiscale(x, list(heads), faces, v_faces, **kw)
    raise ValueError(f"unknown vertex_solver {cfg.eval.vertex_solver!r} "
                     "(use 'operator' or 'naive')")


def _infer_with_vertices(mesh, cfg: Config, params, device: torch.device):
    """:func:`infer_with_vertices` with the seconds of its forward and of its
    solver (each phase ends in copies to the host, which wait for the
    device)."""
    _require_heads(params)
    steps = cfg.model.coarsening_steps
    t0 = time.perf_counter()
    heads, normals = [], []
    with torch.no_grad():
        for patch in mesh.patches:
            n0, n1, n2 = forward_patch(params, patch, cfg, device, multi_scale=True)
            heads.append((n0, n1, n2))
            # mid and coarse heads upsampled to the fine faces
            up1 = normalize_tensor(tree_unpool(n1, steps))
            up2 = normalize_tensor(tree_unpool(n2, 2 * steps))
            normals.append([t.cpu().numpy() for t in (n0, up1, up2)])
    t1 = time.perf_counter()
    solved = []
    for patch, h in zip(mesh.patches, heads):
        refined, dx = solve_patch(patch, cfg, h, device)
        solved.append((refined.cpu().numpy(), [d.cpu().numpy() for d in dx]))
    t2 = time.perf_counter()

    num_v, num_f = mesh.num_vertices, mesh.num_faces
    points = [np.zeros((num_v, 3), np.float64) for _ in range(3)]
    weights = np.zeros((num_v, 1), np.float64)
    face_normals = [np.zeros((num_f, 3), np.float32) for _ in range(3)]
    for patch, per_level, (refined, dx) in zip(mesh.patches, normals, solved):
        # normals are assigned per face: where patches overlap the last wins
        for target, vals in zip(face_normals, per_level):
            target[patch.f_old_idx] = vals[patch.perm_inv][: patch.num_real]
        # points are averaged over the patches: fine, then before the fine
        # scale's moves (mid), then before the mid scale's too (coarse)
        refined_mid = refined - dx[2]
        for target, vals in zip(points, (refined, refined_mid, refined_mid - dx[1])):
            target[patch.v_old_idx] += vals
        weights[patch.v_old_idx] += 1.0
    w = np.maximum(weights, 1.0)
    out = {
        "points": (points[0] / w).astype(np.float32),
        "points_mid": (points[1] / w).astype(np.float32),
        "points_coarse": (points[2] / w).astype(np.float32),
        "fine_normals": face_normals[0],
        "mid_normals": face_normals[1],
        "coarse_normals": face_normals[2],
    }
    return out, t1 - t0, t2 - t1


def infer_with_vertices(mesh, cfg: Config, params=None, device: str = "cuda") -> Dict[str, np.ndarray]:
    """Multi-scale inference with the vertex solver (reference ``inferNet``,
    train.py:148-376). ``mesh`` is an :class:`InferenceMesh` built by
    ``add_mesh_with_vertices`` (or any object with its fields); ``params``
    must hold the multi-scale heads. Returns the fine, mid and coarse points
    [V, 3], in the patches' frame (the input scaled by its bounding-box
    diagonal), and the fine, mid and coarse normals [F, 3]. Runs on CUDA
    unless ``device="cpu"``."""
    dev = resolve_device(device)
    params = params if params is not None else _restore_params(cfg, dev)
    return _infer_with_vertices(mesh, cfg, params, dev)[0]


def infer_directory(
    input_dir: str,
    cfg: Optional[Config] = None,
    with_vertices: Optional[bool] = None,
    params=None,
    device: str = "cuda",
    seed: Optional[int] = None,
) -> List[Dict]:
    """Denoise every ``.obj`` in a directory (reference ``infer``,
    infer.py:32-123): skip existing results unless ``overwrite_results``,
    write ``<stem>_denoised.obj`` and the normal-colored meshes.

    ``with_vertices`` (default ``cfg.model.include_vertices``) serves the
    vertex pipeline (:func:`infer_with_vertices`), which also writes the mid
    and coarse points (``_d_mid.obj``, ``_d_coarse.obj``) and the three
    heads' colored meshes (``_fine_normals_s.obj``, ``_mid_normals_s.obj``,
    ``_coarse_normals_s.obj``); otherwise the normals pipeline
    (:func:`infer_normals`, ``_inferred_normals.obj``). Both write
    ``_original_normals.obj``. ``seed`` fixes each mesh's coarsening seed
    (unseeded by default, as in the JAX package).

    Returns one record per mesh processed: its name, face and patch counts,
    the solver's iterations, the seconds spent in preprocessing, forward and
    solver, the :class:`InferenceMesh`, and for the vertex pipeline its
    outputs."""
    cfg = cfg or default_config()
    if with_vertices is None:
        with_vertices = cfg.model.include_vertices
    dev = resolve_device(device)
    params = params if params is not None else _restore_params(cfg, dev)
    _require_default_conv1(params)
    if with_vertices:
        _require_heads(params)
    results = cfg.eval.results_path
    os.makedirs(results, exist_ok=True)

    records = []
    for noisy_file in sorted(os.listdir(input_dir)):
        if not noisy_file.endswith(".obj"):
            continue
        stem = noisy_file[:-4]
        denoised_path = os.path.join(results, stem + "_denoised.obj")
        if os.path.isfile(denoised_path) and not cfg.eval.overwrite_results:
            print(f"skipping {noisy_file}: result exists")
            continue

        print(f"processing {noisy_file}")
        t0 = time.perf_counter()
        vertices, faces, _ = load_obj(input_dir, noisy_file)
        mesh = InferenceMesh(
            max_patch_size=cfg.data.max_patch_size,
            coarsening_steps=cfg.model.coarsening_steps,
            coarsening_levels=cfg.model.coarsening_levels,
            k_faces=cfg.data.k_faces,
            k_vertices=cfg.data.k_vertices,
            max_edges=cfg.data.max_edges,
            seed=seed,
        )
        record = {"name": stem, "path": denoised_path, "faces": int(faces.shape[0]),
                  "mesh": mesh}
        if with_vertices:
            mesh.add_mesh_with_vertices(vertices, faces)
            preprocess_s = time.perf_counter() - t0
            out, forward_s, solver_s = _infer_with_vertices(mesh, cfg, params, dev)
            iters = sum(int(i) for i in cfg.eval.ms_solver_iterations)
            write_obj(out["points"], mesh.faces, denoised_path)
            write_obj(out["points_mid"], mesh.faces, os.path.join(results, stem + "_d_mid.obj"))
            write_obj(out["points_coarse"], mesh.faces,
                      os.path.join(results, stem + "_d_coarse.obj"))
            colored = [("_fine_normals_s.obj", out["fine_normals"]),
                       ("_mid_normals_s.obj", out["mid_normals"]),
                       ("_coarse_normals_s.obj", out["coarse_normals"])]
            record["outputs"] = out
        else:
            mesh.add_mesh(vertices, faces)
            t1 = time.perf_counter()
            pred_normals = predict_normals(mesh, cfg, params, dev)
            t2 = time.perf_counter()
            # both phases end in a copy to the host, which waits for the device
            points, iters = solve_vertices(mesh, cfg, pred_normals, dev)
            preprocess_s, forward_s, solver_s = t1 - t0, t2 - t1, time.perf_counter() - t2
            write_obj(points, mesh.faces, denoised_path)
            colored = [("_inferred_normals.obj", pred_normals)]
        print(f"  preprocessing: {preprocess_s:.2f}s  forward: {forward_s:.2f}s  "
              f"solver: {solver_s:.2f}s ({iters} iterations)")

        # normal-colored visualization meshes (infer.py:105-123)
        for suffix, normals in colored + [("_original_normals.obj", mesh.normals)]:
            nv, nf = colored_mesh(mesh.vertices, mesh.faces, normals_to_colors(normals))
            write_obj(nv, nf, os.path.join(results, stem + suffix))
        records.append({**record, "patches": len(mesh.patches), "solver_iterations": iters,
                        "preprocess_s": preprocess_s, "forward_s": forward_s,
                        "solver_s": solver_s})
    return records
