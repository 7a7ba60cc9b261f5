"""A cell of the benchmark at a size a CPU test run holds: the paper's
network cut to a few channels over two small meshes. Written into a
temporary directory with a manifest of its own, it drives the harness's
own code paths end to end without a card."""

from __future__ import annotations

import json
import os

TINY_CONFIG = {
    "name": "tiny", "source": "a test configuration", "channels": [4, 8, 8],
    "num_filters": 3, "fc_channels": 16, "out_channels": 3, "in_channels": 6,
    "coarsening_levels": 3, "coarsening_steps": 2, "k_faces": 23, "k_vertices": 25,
    "lrelu_alpha": 0.1, "std_dev": 0.05, "std_dev_bias": 0.01, "include_vertices": False,
    "rotation_invariance": False, "translation_invariance": False, "compute_dtype": "float32",
    "precision": "float32", "loss_samples": 200, "chamfer_samples": 50, "learning_rate": 0.001,
    "augment_rotations": True, "vertex_solver": "operator", "ms_solver_iterations": [4, 2, 2],
    "num_iterations": None, "reduced": {}, "assumed": {}}

TINY_TRAFFIC = {
    "meshes": [{"shape": "icosphere", "args": {"subdiv": 3}},
               {"shape": "torus", "args": {"nu": 24, "nv": 12}}],
    "noise": 0.2, "max_patch_size": 400, "bucket_align": 64, "steps_per_call": 3,
    "trace_calls": 2}

LIMITS = {"loss_gap": 1e-4, "grad_gap": 1e-3, "change_gap": 1e-3}


def write_tiny(root: str, driver: str = "patch_chunks", name: str = "tiny.cell",
               config: dict = None, traffic: dict = None, limits: dict = None) -> str:
    """Write a tiny cell under ``root`` (its workload and configuration
    files and a manifest); returns the manifest's path."""
    config = dict(TINY_CONFIG if config is None else config)
    os.makedirs(os.path.join(root, "configs"), exist_ok=True)
    os.makedirs(os.path.join(root, "workloads"), exist_ok=True)
    with open(os.path.join(root, "configs", config["name"] + ".json"), "w") as fh:
        json.dump(config, fh)
    workload = {"config": config["name"], "driver": driver, "chips": 1, "why": "a test",
                "traffic": TINY_TRAFFIC if traffic is None else traffic,
                "limits": LIMITS if limits is None else limits}
    with open(os.path.join(root, "workloads", name + ".json"), "w") as fh:
        json.dump(workload, fh)
    manifest = {
        "configs": [{"name": config["name"]}],
        "workloads": [{"name": name, "config": config["name"], "traffic": "tiny", "chips": 1}],
        "end_to_end": [{"name": "train_faces_per_s", "unit": "faces/s"},
                       {"name": "step_ms_p95", "unit": "ms"},
                       {"name": "setup_s", "unit": "s"}],
        "per_layer": [{"name": "step_mfu_pct", "unit": "%"}]}
    path = os.path.join(root, "BENCHMARK.json")
    with open(path, "w") as fh:
        json.dump(manifest, fh)
    return path
