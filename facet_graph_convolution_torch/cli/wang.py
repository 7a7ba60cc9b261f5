"""Wang-dataset runner of the port: one command from the raw dataset to the
paper's angular-error table.

    python -m facet_graph_convolution_torch.cli.wang --device cuda \
        --data_root /path/to/wang_synthetic --base_path ./wang_run/

``--data_root`` is the Wang et al. synthetic dataset ("Mesh Denoising via
Cascaded Normal Regression", the reference's training data, README.md:45,
61-72,96-98): a tree with ``train/`` and ``test/`` each holding ``noisy/``
(``<mesh>_n1/_n2/_n3.obj``) and ``original/`` (``<mesh>.obj``), the
``_nK`` → GT mapping of the reference's ``getGTFilename``
(settings.py:44-47). A root that already contains ``Synthetic/`` (the
reference's default layout) is also accepted.

Stages (all resumable — each is skipped when its artifacts exist):

1. stage the dataset into ``<base_path>/Data/Synthetic/`` (symlinks);
2. preprocess → ``Preprocessed_Data/trainingSet.npz`` (+ validSet when a
   ``train/valid`` dir exists);
3. train the 300,000-iteration reference schedule (settings.py:33; override
   with ``--num_iterations``), ``--steps_per_call`` steps a call (default
   100 on the card, each call replaying a captured CUDA graph of the step,
   and 1 on the CPU; a last, shorter call runs the remainder), checkpointed
   every ``save_every``;
4. infer every ``test/noisy/*.obj`` → ``Results/…_denoised.obj``;
5. metrics → ``results_heat.csv`` and a per-noise-level summary table (mean
   angular error, the paper's comparison metric).

Each stage prints its seconds. ``--device`` defaults to ``cuda``; without a
card, pass ``--device cpu``.
"""

from __future__ import annotations

import argparse
import gc
import os
import sys
import time
from collections import defaultdict
from typing import Dict, List, Optional

import torch

from facet_graph_convolution_torch.config import default_config, parse_device, resolve_device


def _stage(data_root: str, base_path: str) -> None:
    src = data_root
    if os.path.isdir(os.path.join(data_root, "Synthetic")):
        src = os.path.join(data_root, "Synthetic")
    dst = os.path.join(base_path, "Data", "Synthetic")
    os.makedirs(os.path.dirname(dst), exist_ok=True)
    if not os.path.exists(dst):
        os.symlink(os.path.abspath(src), dst)
    for sub in ("train/noisy", "train/original", "test/noisy", "test/original"):
        if not os.path.isdir(os.path.join(dst, sub)):
            raise SystemExit(
                f"dataset layout error: missing {sub!r} under {src!r} "
                "(expected the Wang et al. train/test noisy/original tree)"
            )


def _summarize(results_path: str) -> None:
    csv_path = os.path.join(results_path, "results_heat.csv")
    if not os.path.isfile(csv_path):
        print("no results_heat.csv produced — nothing to summarize")
        return
    by_level = defaultdict(list)
    with open(csv_path) as fh:
        for line in fh:
            parts = line.split()
            if len(parts) < 5:
                continue
            name = parts[0]
            ang_mean = float(parts[3])
            for lvl in ("_n1", "_n2", "_n3"):
                if f"{lvl}_denoised" in name:
                    by_level[lvl].append(ang_mean)
    print("\n== Wang synthetic test set: mean angular error (degrees) ==")
    print(f"{'noise':>6} {'meshes':>7} {'mean angle':>11}")
    for lvl in ("_n1", "_n2", "_n3"):
        vals = by_level.get(lvl, [])
        if vals:
            print(f"{lvl:>6} {len(vals):>7} {sum(vals) / len(vals):>11.3f}")
    all_vals = [v for vals in by_level.values() for v in vals]
    if all_vals:
        print(f"{'all':>6} {len(all_vals):>7} {sum(all_vals) / len(all_vals):>11.3f}")


def run(argv: Optional[List[str]] = None) -> Dict:
    """The runner's stages; returns ``{"seconds": {stage: s}, "records":
    infer_directory's records}``."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--data_root", required=True,
                    help="Wang synthetic dataset root (train/ + test/)")
    ap.add_argument("--base_path", default="./wang_run/",
                    help="working tree for staged data/dumps/networks/results")
    ap.add_argument("--num_iterations", type=int, default=None,
                    help="override the 300k reference schedule")
    ap.add_argument("--net_name", default="wang")
    ap.add_argument("--steps_per_call", type=int, default=None,
                    help="train steps a call (default 100 on the card, 1 on the CPU)")
    ap.add_argument("--skip_train", action="store_true",
                    help="reuse the existing checkpoint (infer+metrics only)")
    ap.add_argument("--device", type=str, default=None,
                    help="torch device (default cuda; cpu without a card)")
    args = ap.parse_args(argv)
    device = parse_device(args.device)
    dev = resolve_device(device)

    base = os.path.abspath(args.base_path) + os.sep
    os.makedirs(base, exist_ok=True)
    _stage(args.data_root, base)

    cfg = default_config(base_path=base).replace(
        train={"net_name": args.net_name,
               "network_path": os.path.join(base, "Networks") + os.sep},
        eval={"results_path": os.path.join(base, "Results") + os.sep},
        data={"test_data_path": os.path.join(
            base, "Data", "Synthetic", "test", "noisy") + os.sep},
    )
    if args.num_iterations is not None:
        cfg = cfg.replace(train={"num_iterations": args.num_iterations})
    seconds: Dict[str, float] = {}

    # 1. preprocess (resumable: skip when the dump exists)
    t0 = time.perf_counter()
    dump = os.path.join(cfg.data.binary_dump_path, "trainingSet.npz")
    if os.path.isfile(dump):
        print(f"[wang] preprocess: {dump} exists — skipping")
    else:
        from facet_graph_convolution_torch.data.preprocess import preprocess_directory

        preprocess_directory(cfg)
    seconds["preprocess"] = time.perf_counter() - t0

    # 2. train (resumes from the latest checkpoint automatically)
    t0 = time.perf_counter()
    if not args.skip_train:
        from facet_graph_convolution_torch.data.dataset import load_dataset
        from facet_graph_convolution_torch.training.trainer import train_normals

        steps_per_call = args.steps_per_call
        if steps_per_call is None:
            steps_per_call = 100 if dev.type == "cuda" else 1
        valid_path = os.path.join(cfg.data.binary_dump_path, "validSet.npz")
        valid_set = load_dataset(valid_path) if os.path.isfile(valid_path) else None
        train_normals(cfg, load_dataset(dump), valid_set,
                      steps_per_call=steps_per_call, device=device)
        if dev.type == "cuda":
            # the step's CUDA graph and its memory pool die with the trainer;
            # hand their memory back before serving
            gc.collect()
            torch.cuda.synchronize(dev)
            torch.cuda.empty_cache()
    seconds["train"] = time.perf_counter() - t0

    # 3. infer the test set
    from facet_graph_convolution_torch.inference.driver import infer_directory

    t0 = time.perf_counter()
    test_noisy = os.path.join(base, "Data", "Synthetic", "test", "noisy")
    records = infer_directory(test_noisy, cfg, device=device)
    seconds["infer"] = time.perf_counter() - t0

    # 4. metrics + summary table
    from facet_graph_convolution_torch.evaluation.driver import compute_metrics

    t0 = time.perf_counter()
    os.makedirs(cfg.eval.results_path, exist_ok=True)
    compute_metrics(cfg)
    seconds["metrics"] = time.perf_counter() - t0
    _summarize(cfg.eval.results_path)
    print("[wang] seconds: " + ", ".join(f"{k} {v:.2f}" for k, v in seconds.items()))
    return {"seconds": seconds, "records": records}


def main(argv=None):
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
