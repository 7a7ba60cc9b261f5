"""Where a benchmark cell's traced stretch spends its time, by the
program's own spans and marks. Card only (``--spans_cost`` runs anywhere).

    python3 tools/trace_cell.py --workload <cell> --seed <n>
    python3 tools/trace_cell.py --spans_cost

Runs the cell as ``fgc_bench/run.py --trace 1`` does (``runner.run``: its
result line is printed first), keeps the stretch that the run traced, and
prints one JSON line, also written to ``chiprun_out/trace_<cell>.json``:

- ``metrics``: the run's per-layer metrics, ``step_ms_traced_median`` its
  median step ms under the profiler;
- ``idle_by_span``: the stretch's idle seconds by the innermost named span
  (``fgc.*`` of the program, ``fgcb.*`` of the harness) over each part;
- ``gaps_1ms``: every idle gap of 1 ms or more, with the named spans that
  hold it whole and the host operation at its middle;
- ``replays``: each ``fgc.loop.replay`` span's host ms, whether its call
  followed a graph switch, and the device idle inside it (all of it, and
  less the gaps that overlap the profiler's own work);
- ``marks``: the mark kernels' summed device seconds, launches and share of
  the busy time; ``phases_s``: the step's three phases summed over the
  stretch, beside ``busy_s``, and ``solver_walls_s`` the solver's two
  phases from mark to mark, idle included;
- ``spans``: the stretch's program spans by name (count, host seconds), and
  ``prep``: the set-up's ``fgc.prep.*`` span totals.

``--spans_cost`` times a span with no profiler recording, in µs, on this
host.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def spans_cost(reps: int = 200_000) -> dict:
    """µs a span costs with no profiler recording, against an empty
    ``with`` of a do-nothing context manager."""
    import contextlib

    from facet_graph_convolution_torch.utils.profiling import reset, span

    def loop(make):
        t0 = time.perf_counter()
        for _ in range(reps):
            with make():
                pass
        return 1e6 * (time.perf_counter() - t0) / reps

    empty = min(loop(contextlib.nullcontext) for _ in range(3))
    timed = min(loop(lambda: span("fgc.cost.probe")) for _ in range(3))
    reset()
    return {"span_us": timed, "empty_with_us": empty, "reps": reps}


def _named(host):
    return [(n, a, b) for n, a, b in host if n.startswith("fgc.") or n.startswith("fgcb.")]


def idle_by_span(stretch, idle):
    """Idle seconds by the innermost named span over each part of each
    idle interval ("none" where no named span holds it)."""
    named = _named(stretch.host)
    out = {}
    for a, b in idle:
        cuts = sorted({a, b} | {t for _, s0, s1 in named for t in (s0, s1) if a < t < b})
        for x, y in zip(cuts, cuts[1:]):
            mid = 0.5 * (x + y)
            inside = [(s1 - s0, n) for n, s0, s1 in named if s0 <= mid <= s1]
            name = min(inside)[1] if inside else "none"
            out[name] = out.get(name, 0.0) + 1e-6 * (y - x)
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def gaps(stretch, idle, least_us=1000.0):
    """Every idle gap of ``least_us`` or more: its ms, its start from the
    stretch's first event, the named spans that hold it whole, its ms by
    innermost named span, and the host operation at its middle."""
    named = _named(stretch.host)
    t0 = min([a for _, a, _ in stretch.events] + [a for _, a, _ in stretch.host])
    out = []
    for a, b in idle:
        if b - a < least_us:
            continue
        mid = 0.5 * (a + b)
        whole = sorted((s1 - s0, n) for n, s0, s1 in named if s0 <= a and b <= s1)
        at_mid = [(hb - ha, n) for n, ha, hb in stretch.host if ha <= mid <= hb]
        parts = {k: 1e3 * v for k, v in idle_by_span(stretch, [(a, b)]).items()}
        out.append({"ms": 1e-3 * (b - a), "at_ms": 1e-3 * (a - t0),
                    "held_by": [n for _, n in whole], "parts_ms": parts,
                    "host_op": min(at_mid)[1] if at_mid else "none"})
    return out


def replays(stretch, idle):
    """Each ``fgc.loop.replay`` span: its host ms, whether its call
    followed a graph switch, the device idle ms inside it, the same less
    the profiler's own gaps, and its idle gaps of 0.2 ms or more (ms,
    start from the span's start)."""
    from fgc_bench.core import program_trace as pt

    after_switch = set(pt.switch_replays(stretch))
    spans = pt.spans(stretch, lambda n: n == "fgc.loop.replay")
    own = pt.replay_idle_ms(stretch, spans)
    out = []
    for (a, b), own_ms in zip(spans, own):
        inside = pt.intersect(idle, [(a, b)])
        out.append({"host_ms": 1e-3 * (b - a), "switch": (a, b) in after_switch,
                    "idle_ms": 1e-3 * pt.length(inside), "own_idle_ms": own_ms,
                    "gaps": [[1e-3 * (y - x), 1e-3 * (x - a)] for x, y in inside
                             if y - x >= 200.0]})
    return out


def phase_walls_s(stretch, begin, end):
    """Seconds from each ``begin`` mark's end to the next ``end`` mark's
    start, summed: the phase on the device's clock, idle included."""
    from fgc_bench.core import program_trace as pt

    ends = pt.marks(stretch, end)
    total = 0.0
    for _, b0 in pt.marks(stretch, begin):
        later = [a for a, _ in ends if a >= b0]
        if later:
            total += later[0] - b0
    return 1e-6 * total


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload")
    parser.add_argument("--seed", type=int, default=5100000004)
    parser.add_argument("--spans_cost", action="store_true")
    args = parser.parse_args(argv)
    if args.spans_cost:
        print(json.dumps(spans_cost()))
        return 0

    import torch

    from fgc_bench.core import program_trace as pt
    from fgc_bench.core import runner, trace
    from facet_graph_convolution_torch.utils.profiling import totals

    kept = {}
    profile = trace.profile

    def keep(run):
        kept["stretch"], kept["record"] = profile(run)
        return kept["stretch"], kept["record"]

    trace.profile = keep            # runner.run imports it when it traces
    code, result = runner.run(args.workload, args.seed, 0.0, True)
    if code != 0 or "stretch" not in kept:
        return code or 1
    stretch = kept["stretch"]

    idle = pt.idle(stretch)
    mark_s, mark_n = stretch.device_time(pt.is_mark)
    phases = {f"{a}->{b}": 1e-6 * sum(pt.phases(stretch, a, b))
              for a, b in (("step_begin", "fwd_end"), ("fwd_end", "bwd_end"),
                           ("bwd_end", "opt_end"), ("solver_begin", "solver_end"),
                           ("solver_bwd_begin", "solver_bwd_end"))}
    by_name = {}
    for n, a, b in stretch.host:
        if n.startswith("fgc."):
            c = by_name.setdefault(n, [0, 0.0])
            c[0] += 1
            c[1] += 1e-6 * (b - a)
    out = {
        "workload": args.workload, "seed": args.seed,
        "card": torch.cuda.get_device_name(), "correct": result["correct"],
        "steps": len(pt.marks(stretch, "step_begin")),
        "busy_s": stretch.busy_s, "window_s": stretch.window_s,
        "step_ms_traced_median": statistics.median(kept["record"].step_ms),
        "metrics": {k: v["value"] for k, v in result["metrics"].items()},
        "marks": {"seconds": mark_s, "launches": mark_n,
                  "share_of_busy": mark_s / stretch.busy_s if stretch.busy_s else None},
        "phases_s": phases,
        "idle_s": 1e-6 * pt.length(idle),
        "own_idle_s": 1e-6 * pt.length(pt.own_idle(stretch)),
        "idle_by_span": idle_by_span(stretch, idle),
        "gaps_1ms": gaps(stretch, idle),
        "replays": replays(stretch, idle),
        "solver_walls_s": [phase_walls_s(stretch, "solver_begin", "solver_end"),
                           phase_walls_s(stretch, "solver_bwd_begin", "solver_bwd_end")],
        "spans": by_name,
        "prep": {k: v for k, v in totals().items() if k.startswith("fgc.prep.")},
    }
    line = json.dumps(out)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", f"trace_{args.workload}.json"), "w") as fh:
        fh.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
