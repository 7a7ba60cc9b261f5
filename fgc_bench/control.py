"""The control and the planted faults of a cell's comparison, read on the
card at the cell's own size: the readings its limits are set from.

    python3 fgc_bench/control.py --workload <cell> --seeds 11,12,13

For each seed the cell's set-up and first steps run as in a run of
``run.py`` (no window), then the plain reference in float32 (TF32 off),
and the numbers of ``reference.train.compare`` are printed, one JSON line
a seed, for:

- ``sound``: the program's first steps (the lower readings);
- ``control``: the reference again with its products in TF32, the nearest
  precision below the configuration's float32;
- ``half_batch``: the reference with each step's loss over half its
  samples (a step that loses half its batch).

A cell with a ``tie_tolerance`` (near-tied chamfer terms, see
``reference.train.compare``) can be read at other tolerances too
(``--tolerances 1e-6,1e-5``), each with the first step's near ties.

A step that leaves the state unchanged reads 1 on ``change_gap`` by the
measure itself and needs no run. The last line is the summary: the largest
sound reading and the smallest control and fault reading of each number.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

import numpy as np

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from fgc_bench.core import manifest  # noqa: E402
from fgc_bench.reference.train import leaf_norms, compare, run_steps  # noqa: E402


def worst_leaves(got, ref, count=3):
    """The leaves that read the widest gaps of the first gradient and of
    the change, ``[gap, layer.name, got norm, reference norm]`` each."""
    out = {}
    for part in ("first_grads", "change"):
        a, b = leaf_norms(getattr(got, part)), leaf_norms(getattr(ref, part))
        med = float(np.median(list(b.values())))
        rows = sorted(((abs(a[k] - b[k]) / max(b[k], med), ".".join(k), a[k], b[k]) for k in b),
                      reverse=True)
        out[part] = [list(r) for r in rows[:count]]
    return out


def readings(workload: str, seed: int, device: str = "cuda", manifest_path=None, root=None,
             tolerances=()):
    """The three readings of one seed, as ``{kind: {number: value}}``, at
    the cell's ``tie_tolerance``; for a cell that has one, also at each of
    ``tolerances`` (under ``by_tolerance``) and the first step's near ties."""
    import torch

    cell = manifest.load_cell(workload, manifest_path, root)
    session = manifest.driver(cell).Session(cell, seed, device)
    prog = session.first_steps()
    session.release()
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    lr = cell.config["learning_rate"]
    tol = float(cell.workload.get("tie_tolerance", 0.0))
    search = {}
    if "tie_tolerance" in cell.workload:
        search = {"tolerance": max([tol, *tolerances])}

    def steps(fault="", tf32=False):
        return run_steps(session.host_params0, session.reference_losses(device, fault, **search),
                         lr, device, tf32=tf32)

    ref = steps()
    sides = {"sound": prog, "control": steps(tf32=True), "half_batch": steps("half_batch")}
    out = {kind: compare(side, ref, tol) for kind, side in sides.items()}
    out["sound_leaves"] = worst_leaves(prog, ref)
    if search:
        out["ties"] = sorted(ref.tie_margins.tolist())
        out["by_tolerance"] = {str(t): {kind: compare(side, ref, t) for kind, side in sides.items()}
                               for t in tolerances}
    return out


def summary(lines):
    keys = lines[0]["sound"].keys()

    def extremes(rows):
        return {"sound_max": {k: max(r["sound"][k] for r in rows) for k in keys},
                "control_min": {k: min(r["control"][k] for r in rows) for k in keys},
                "half_batch_min": {k: min(r["half_batch"][k] for r in rows) for k in keys}}

    out = extremes(lines)
    for t in lines[0].get("by_tolerance", {}):
        out[f"tolerance {t}"] = extremes([r["by_tolerance"][t] for r in lines])
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True, help="comma-separated")
    parser.add_argument("--tolerances", default="",
                        help="comma-separated tie tolerances to read besides the cell's")
    args = parser.parse_args(argv)
    tolerances = [float(t) for t in args.tolerances.split(",") if t]
    lines = []
    for seed in [int(s) for s in args.seeds.split(",")]:
        t0 = time.perf_counter()
        r = readings(args.workload, seed, tolerances=tolerances)
        r.update(seed=seed, seconds=time.perf_counter() - t0)
        print(json.dumps(r), flush=True)
        lines.append(r)
    print(json.dumps({"summary": summary(lines)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
