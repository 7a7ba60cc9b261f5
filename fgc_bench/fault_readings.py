"""The readings a cell's limits are set from, with the faults its driver
plants besides ``control.py``'s: one set-up a seed, on the card at the
cell's own size.

    python3 fgc_bench/fault_readings.py --workload rotinv.patch20k --seeds 11,12 \\
        --faults half_batch,no_rotation

For each seed the cell's set-up and first steps run as in a run of
``run.py`` (no window), then the plain reference in float32 (TF32 off),
and the numbers of ``reference.train.compare`` are printed, one JSON line
a seed, for ``sound`` (the program's first steps), ``control`` (the
reference with its products in TF32) and each fault named (the reference
with the fault, ``session.reference_losses(device, fault)``). The last
line is the summary: the largest sound reading and the smallest reading
of the control and of each fault, number by number.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from fgc_bench.control import worst_leaves  # noqa: E402
from fgc_bench.core import manifest  # noqa: E402
from fgc_bench.reference.train import compare, run_steps  # noqa: E402


def readings(workload: str, seed: int, faults, device: str = "cuda", manifest_path=None,
             root=None):
    """``{kind: {number: value}}`` of one seed for ``sound``, ``control`` and
    each of ``faults``, and the sound side's widest leaves."""
    import torch

    cell = manifest.load_cell(workload, manifest_path, root)
    session = manifest.driver(cell).Session(cell, seed, device)
    prog = session.first_steps()
    session.release()
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    lr = cell.config["learning_rate"]

    def steps(fault="", tf32=False):
        return run_steps(session.host_params0, session.reference_losses(device, fault), lr,
                         device, tf32=tf32)

    ref = steps()
    sides = {"sound": prog, "control": steps(tf32=True)}
    sides.update((fault, steps(fault)) for fault in faults)
    out = {kind: compare(side, ref) for kind, side in sides.items()}
    out["sound_leaves"] = worst_leaves(prog, ref)
    return out


def summary(lines, faults):
    keys = lines[0]["sound"].keys()
    out = {"sound_max": {k: max(r["sound"][k] for r in lines) for k in keys}}
    for kind in ("control", *faults):
        out[f"{kind}_min"] = {k: min(r[kind][k] for r in lines) for k in keys}
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True, help="comma-separated")
    parser.add_argument("--faults", default="half_batch", help="comma-separated")
    args = parser.parse_args(argv)
    faults = [f for f in args.faults.split(",") if f]
    lines = []
    for seed in [int(s) for s in args.seeds.split(",")]:
        t0 = time.perf_counter()
        r = readings(args.workload, seed, faults)
        r.update(seed=seed, seconds=time.perf_counter() - t0)
        print(json.dumps(r), flush=True)
        lines.append(r)
    print(json.dumps({"summary": summary(lines, faults)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
