"""One run of a cell: set-up, the measured window (or the traced stretch),
the check of the first steps against the plain reference, and the result
line.

    python fgc_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The run prints, as the last lines of standard error, each number compared
beside its limit, and as the last line of standard output one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics``, ``device``, with
``--trace 1`` the ``breakdown``, then ``card`` and, last, ``checks``.
"""

from __future__ import annotations

import gc
import json
import sys
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from fgc_bench.core import manifest
from fgc_bench.core.stats import WindowRecord, step_ms_percentile
from fgc_bench.reference.train import compare, run_steps

FORBIDDEN = ("jax", "jaxlib", "flax", "facet_graph_convolution_tpu")
TRACE_WARM_CALLS = 2


@dataclass
class Context:
    """What a per-layer metric's reader gets."""

    cell: "manifest.Cell"
    session: object
    stretch: object                 # core.trace.Stretch
    steps: List[int]                # the run's step indices inside the stretch


def _card_line() -> str:
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi: not read"


def forbidden_modules() -> List[str]:
    """The JAX packages (compared by whole top-level name) in this process."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def drive(session, seconds: float = 0.0, calls: int = 0) -> WindowRecord:
    """Calls of the session until ``seconds`` have passed (or ``calls``
    calls), each call's losses read one call late as the program's loop
    reads them; a call's time runs from the previous completion to its
    own (the host clock where its losses are read, or where a call that
    returns only once complete says it completed)."""
    from torch.profiler import record_function

    record = WindowRecord(time.perf_counter())
    pending, made = None, 0
    while True:
        with record_function("fgcb.enqueue_call"):
            call = session.call()
        made += 1
        if pending is not None:
            with record_function("fgcb.wait_for_losses"):
                record.add(pending.steps, pending.faces, pending.wait(), pending.done)
        pending = call
        elapsed = time.perf_counter() - record.start
        if (calls and made >= calls) or (not calls and elapsed >= seconds):
            break
    record.add(pending.steps, pending.faces, pending.wait(), pending.done)
    return record


def _quarters(step_ms: List[float]) -> List[float]:
    return [round(float(np.median(q)), 4) for q in np.array_split(np.asarray(step_ms), 4)
            if q.size]


def result_line(correct: bool, attempted: int, failed: int, metrics: Dict, device: Dict,
                breakdown: Optional[Dict], card: str, checks: Dict) -> Dict:
    """The run's last line: the contract's keys, the card's name and power
    limit, and last the numbers compared beside their limits."""
    out = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed),
           "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["card"] = card
    out["checks"] = checks
    return out


def run(workload: str, seed: int, seconds: float, trace: bool, *,
        started: Optional[float] = None, manifest_path: Optional[str] = None,
        root: Optional[str] = None, require_card: bool = True,
        device: str = "cuda") -> Tuple[int, Optional[Dict]]:
    """Run the cell; returns ``(exit code, result)`` after printing them."""
    started = time.perf_counter() if started is None else started
    cell = manifest.load_cell(workload, manifest_path, root)
    import torch

    if require_card and (not torch.cuda.is_available() or
                         torch.cuda.device_count() < cell.chips):
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"fgc_bench: {workload} needs {cell.chips} CUDA device(s), found {have}",
              file=sys.stderr)
        return 2, None
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    t_import = time.perf_counter()
    session = manifest.driver(cell).Session(cell, seed, device)
    t_session = time.perf_counter()
    prog = session.first_steps()
    t_first = time.perf_counter()
    session.warm()
    load_s = float(cell.traffic.get("warm_seconds", 0.0))
    if load_s > 0:
        # calls under load until the card's step time has settled (see PERF.md)
        warm = drive(session, seconds=load_s)
        print(f"warm-up under load: {warm.steps} steps in {warm.window_s:.3f} s; median step "
              f"ms by quarter {_quarters(warm.step_ms)}", file=sys.stderr)
    setup_s = time.perf_counter() - started
    print(f"set-up: {setup_s:.3f} s: start to the cell's files and torch "
          f"{t_import - started:.3f}, the program's set-up {t_session - t_import:.3f}, "
          f"the first steps {t_first - t_session:.3f}, the warm-up "
          f"{started + setup_s - t_first:.3f}", file=sys.stderr)

    metrics: Dict[str, Dict] = {}
    breakdown = None
    if trace:
        from fgc_bench.core.trace import profile

        drive(session, calls=TRACE_WARM_CALLS)
        first = len(session.steps_done)
        calls = int(cell.traffic.get("trace_calls", 3))
        stretch, record = profile(lambda: drive(session, calls=calls))
        ctx = Context(cell, session, stretch, list(range(first, len(session.steps_done))))
        for m in cell.per_layer:
            value = manifest.metric_reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
        breakdown = {"device_ops": stretch.top_ops(), "idle_gaps": stretch.idle_gaps()}
        device_extra = {"busy_s": stretch.busy_s, "window_s": stretch.window_s}
    else:
        record = drive(session, seconds=seconds)
        device_extra = {}
        print(f"window: {record.steps} steps in {record.window_s:.3f} s; median step ms "
              f"by quarter {_quarters(record.step_ms)}", file=sys.stderr)
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    if not trace:
        values = {"train_faces_per_s": record.faces / record.window_s,
                  "step_ms_p95": step_ms_percentile(record.step_ms, 95),
                  "peak_mem_gib": peak / 2**30, "setup_s": setup_s}
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": float(values[m["name"]]), "unit": m["unit"]}

    session.release()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    ref = run_steps(session.host_params0, session.reference_losses(device),
                    cell.config["learning_rate"], device)
    print(f"reference: {time.perf_counter() - t_ref:.3f} s", file=sys.stderr)
    if ref.tie_margins is not None:
        print(f"reference: {ref.tie_margins.size} near-tied chamfer terms at the first step "
              f"(margins {np.sort(ref.tie_margins).tolist()})", file=sys.stderr)
    numbers = compare(prog, ref, float(cell.workload.get("tie_tolerance", 0.0)))
    limits = cell.workload["limits"]
    checks = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    checks["failed_steps"] = {"value": record.failed, "limit": 0}
    correct = all(v["limit"] is not None and v["value"] <= v["limit"] for v in checks.values())
    bad = forbidden_modules()
    if bad:
        print(f"fgc_bench: JAX packages loaded in the run's process: {bad}", file=sys.stderr)
        return 3, None
    device_info = {"platform": "gpu" if on_card else "cpu",
                   "kind": torch.cuda.get_device_name() if on_card else "cpu",
                   "count": cell.chips, "memory_peak_bytes": int(peak), **device_extra}
    out = result_line(correct, record.steps, record.failed, metrics, device_info,
                      breakdown, _card_line() if on_card else "cpu", checks)
    for k, v in checks.items():
        limit = "not set" if v["limit"] is None else f"{v['limit']:.6e}"
        print(f"check {k}: {v['value']:.6e} (limit {limit})", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0, out
