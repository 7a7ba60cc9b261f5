"""Inference drivers, normals pipeline (counterparts of
``facet_graph_convolution_tpu/inference/driver.py::infer_normals`` and
``infer_directory``; reference ``inferNetOld`` train.py:29-144 and
``infer.py:32-123``).

:func:`infer_normals` runs the U-Net forward on each patch, maps the outputs
back to mesh order, sums overlapping patches, normalizes, and moves the
vertices with the edge-map solver. The forward is the kernel configuration
(:func:`facet_graph_convolution_torch.models.unet.unet_apply`).
"""

from __future__ import annotations

import os
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from facet_graph_convolution_torch import params as params_io
from facet_graph_convolution_torch.config import Config, default_config
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
from facet_graph_convolution_torch.ops.vertex_update import update_positions_edges


def resolve_device(device: str) -> torch.device:
    """``device`` as a torch device; raises for CUDA when no card is present
    (the entry points never fall back to the CPU on their own)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but no CUDA device is available; "
            "pass device='cpu' (or --device cpu) to run on the CPU")
    return dev


def _restore_params(cfg: Config, device: torch.device):
    path = params_io.checkpoint_path(cfg.train.network_path, cfg.train.net_name)
    if not os.path.isfile(path):
        raise FileNotFoundError(
            f"no checkpoint at {path} (the reference hard-errors here too, "
            "train.py:82-87)")
    return params_io.load(path, device=str(device))


def forward_patch(params, patch, cfg: Config, device: torch.device) -> torch.Tensor:
    """Normalized U-Net output of one patch, [N, 3] on ``device``, tree
    order (fake nodes included)."""
    adjs, rows = graph_tensors(patch.adjs, device)
    x = torch.as_tensor(patch.inputs, device=device)
    y = unet_apply(params, x, adjs, rows, coarsening_steps=cfg.model.coarsening_steps,
                   alpha=cfg.model.lrelu_alpha)
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


def infer_directory(
    input_dir: str,
    cfg: Optional[Config] = None,
    params=None,
    device: str = "cuda",
) -> List[Dict]:
    """Denoise every ``.obj`` in a directory (reference ``infer``,
    infer.py:32-123): skip existing results unless ``overwrite_results``,
    write ``<stem>_denoised.obj`` and the normal-colored meshes.

    Returns one record per mesh processed: its name, face and patch counts,
    the solver's iterations, the seconds spent in preprocessing, forward and
    solver, and the :class:`InferenceMesh`."""
    cfg = cfg or default_config()
    dev = resolve_device(device)
    params = params if params is not None else _restore_params(cfg, dev)
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
            max_edges=cfg.data.max_edges,
        )
        mesh.add_mesh(vertices, faces)
        t1 = time.perf_counter()
        pred_normals = predict_normals(mesh, cfg, params, dev)
        t2 = time.perf_counter()
        # both phases end in a copy to the host, which waits for the device
        points, iters = solve_vertices(mesh, cfg, pred_normals, dev)
        t3 = time.perf_counter()
        write_obj(points, mesh.faces, denoised_path)
        print(f"  preprocessing: {t1 - t0:.2f}s  forward: {t2 - t1:.2f}s  "
              f"solver: {t3 - t2:.2f}s ({iters} iterations)")

        # normal-colored visualization meshes (infer.py:105-123)
        nv, nf = colored_mesh(mesh.vertices, mesh.faces, normals_to_colors(pred_normals))
        write_obj(nv, nf, os.path.join(results, stem + "_inferred_normals.obj"))
        ov, of = colored_mesh(mesh.vertices, mesh.faces, normals_to_colors(mesh.normals))
        write_obj(ov, of, os.path.join(results, stem + "_original_normals.obj"))
        records.append({
            "name": stem, "path": denoised_path, "faces": int(faces.shape[0]),
            "patches": len(mesh.patches), "solver_iterations": iters,
            "preprocess_s": t1 - t0, "forward_s": t2 - t1, "solver_s": t3 - t2,
            "mesh": mesh,
        })
    return records
