"""Offline evaluation driver (host): the port's copy of
``facet_graph_convolution_tpu/evaluation/driver.py`` (reference
``computeMetrics``, computeMetrics.py:12-139). For each ground-truth mesh ×
noise level: the oversampled Hausdorff distance and the angular error with
its interior/border split, an angular-error heatmap OBJ, a CSV row, and the
per-face angular errors in ``angDiffFinal.mat``."""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import scipy.io

from facet_graph_convolution_torch.config import Config, default_config
from facet_graph_convolution_torch.evaluation.metrics import (
    angular_error,
    angular_error_stats,
    hausdorff_oversampled,
)
from facet_graph_convolution_torch.geometry.mesh_math import border_faces, compute_face_normals
from facet_graph_convolution_torch.geometry.obj_io import (
    colored_mesh,
    heatmap_colors,
    load_obj,
    write_obj,
)
from facet_graph_convolution_torch.geometry.pointset import dense_point_cloud


def compute_metrics(
    cfg: Optional[Config] = None,
    noise_suffixes=("_n1", "_n2", "_n3"),
) -> None:
    """Score every ``<results>/<stem><suffix>_denoised.obj`` against
    ``<test_gt_data_path>/<stem>.obj``: append a row a result to
    ``results_heat.csv`` (name, Hausdorff max and mean, angle mean and std,
    faces, interior angle mean and std, border angle mean and std), write
    ``<stem><suffix>_heatmap.obj`` and ``angDiffFinal.mat``. A result whose
    heatmap exists is skipped (the runs resume)."""
    cfg = cfg or default_config()
    gt_folder = cfg.data.test_gt_data_path
    results = cfg.eval.results_path
    csv_path = os.path.join(results, "results_heat.csv")
    ang_dict = {}

    for gt_name in sorted(os.listdir(gt_folder)):
        if not gt_name.endswith(".obj"):
            continue
        stem = gt_name[:-4]
        names, rows = [], []
        gt_vertices, gt_faces, _ = load_obj(gt_folder, gt_name)
        gt_normals = compute_face_normals(gt_vertices, gt_faces)
        dense_gt = dense_point_cloud(gt_vertices, gt_faces, res=1)
        border = border_faces(gt_faces)

        for suffix in noise_suffixes:
            denoised = f"{stem}{suffix}_denoised.obj"
            heat_file = f"{stem}{suffix}_heatmap.obj"
            if os.path.isfile(os.path.join(results, heat_file)):
                continue
            if not os.path.isfile(os.path.join(results, denoised)):
                continue
            v0, _, _ = load_obj(results, denoised)
            normals0 = compute_face_normals(v0, gt_faces)

            haus_max, _, haus_mean, _ = hausdorff_oversampled(
                v0, gt_vertices, v0, dense_gt, accuracy_only=True
            )
            ang_vec = angular_error(normals0, gt_normals)
            ang_in = ang_vec[border == 0]
            ang_out = ang_vec[border == 1]
            ang_mean, ang_std = angular_error_stats(normals0, gt_normals)
            rms = float(np.sqrt(np.mean(np.square(ang_vec))))
            print(f"{denoised}: angle {ang_mean:.3f}±{ang_std:.3f}°, rms {rms:.3f}°, "
                  f"hausdorff {haus_max:.6f}/{haus_mean:.6f}")

            ang_dict[denoised[:-4].replace("-", "_")] = ang_vec

            # heatmap OBJ (computeMetrics.py:102-112)
            heat = 1.0 - np.maximum(1.0 - ang_vec / cfg.eval.heatmap_max_angle, 0.0)
            hv, hf = colored_mesh(v0, gt_faces, heatmap_colors(heat))
            write_obj(hv, hf, os.path.join(results, heat_file))

            names.append(denoised)
            rows.append([
                haus_max, haus_mean, ang_mean, ang_std, gt_faces.shape[0],
                float(ang_in.mean()) if ang_in.size else 0.0,
                float(ang_in.std()) if ang_in.size else 0.0,
                float(ang_out.mean()) if ang_out.size else 0.0,
                float(ang_out.std()) if ang_out.size else 0.0,
            ])

        if not names:
            continue
        with open(csv_path, "a") as fh:
            for name, row in zip(names, rows):
                fh.write(name + " " + " ".join("%.7f" % x for x in row) + " \n")
        scipy.io.savemat(os.path.join(results, "angDiffFinal.mat"), mdict=ang_dict)
