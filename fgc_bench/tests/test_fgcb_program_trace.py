"""The readers of the program's spans and marks against stretches made by
hand: a step split by its marks (overlapping activities counted once, an
idle hole between marks left out), idle inside the program's spans (not
inside the losses' wait or the harness's own code, nor a gap that overlaps
the profiler's own work), the idle in the replays, all of them and those
that followed a graph switch, the solver's two phases, the set-up's prep
seconds, and nothing read from a program without the tracer."""

from types import SimpleNamespace

import pytest

from fgc_bench.core import program_trace
from fgc_bench.core.trace import Stretch, _union_s
from fgc_bench.metrics import (
    graph_switch_ms,
    host_prep_s,
    host_stall_pct,
    replay_idle_ms,
    solver_step_ms,
    step_bwd_ms,
    step_fwd_ms,
    step_opt_ms,
)

# two steps (microseconds on the profiler's clock)
DEVICE = [
    ("fgc_mark_step_begin", 0, 1), ("gemm", 2, 10), ("add", 8, 12), ("fgc_mark_fwd_end", 14, 15),
    ("k2", 16, 20), ("k2", 30, 34),            # an idle hole 20..30 inside the backward
    ("fgc_mark_bwd_end", 35, 36), ("adam", 37, 40), ("fgc_mark_opt_end", 41, 42),
    ("fgc_mark_step_begin", 100, 101), ("gemm", 101, 111), ("fgc_mark_fwd_end", 111, 112),
    ("k2", 112, 120), ("fgc_mark_bwd_end", 120, 121), ("adam", 121, 123),
    ("fgc_mark_opt_end", 123, 124),
]
HOST = [
    ("fgc.loop.stage_draws", 18, 25),          # 20..25 of the hole: a stall
    ("fgc.loop.read_losses", 25, 32),          # 25..30: the host waits
    ("fgcb.enqueue_call", 42, 100),            # harness code: not the program's
    ("fgc.sharded.forward", 43, 60),           # 43..45 and 50..60 stall
    ("fgc.loop.read_losses", 45, 50),          # a wait inside it does not
    ("fgc.loop.stage_draws", 90, 100),         # 90..100 stall
    ("aten::copy_", 91, 99),
    ("fgcb.wait_for_losses", 124, 200),
]


def _ctx(device=DEVICE, host=HOST, window_s=200e-6):
    return SimpleNamespace(stretch=Stretch(list(device), list(host), window_s, _union_s(device)))


def test_marks_split_a_step_and_skip_an_idle_hole():
    ctx = _ctx()
    # forward: 2..12 (the overlap once) and 101..111; backward: 16..20 + 30..34, 112..120;
    # Adam: 37..40, 121..123
    assert step_fwd_ms.read(ctx) == pytest.approx(1e-3 * (10 + 10) / 2)
    assert step_bwd_ms.read(ctx) == pytest.approx(1e-3 * (8 + 8) / 2)
    assert step_opt_ms.read(ctx) == pytest.approx(1e-3 * (3 + 2) / 2)
    phases = sum(sum(program_trace.phases(ctx.stretch, a, b))
                 for a, b in (("step_begin", "fwd_end"), ("fwd_end", "bwd_end"),
                              ("bwd_end", "opt_end")))
    marks = 8.0
    assert phases + marks == pytest.approx(1e6 * ctx.stretch.busy_s)


def test_a_phase_without_its_end_mark_is_not_counted():
    device = [e for e in DEVICE if not (e[0] == "fgc_mark_fwd_end" and e[1] == 111)]
    # the second step's forward has no end: only the first counts
    assert step_fwd_ms.read(_ctx(device)) == pytest.approx(1e-3 * 10)


def test_idle_inside_program_spans_but_not_inside_a_wait():
    stall_us = 5 + (2 + 10) + 10
    assert host_stall_pct.read(_ctx()) == pytest.approx(100.0 * stall_us / 200)


def test_idle_in_the_replays_after_a_graph_switch():
    host = [
        ("fgc.loop.replay", -10, -5),                                  # no get before it
        ("fgc.graphs.get", 0, 2), ("fgc.graphs.switch", 0.5, 1.5), ("fgc.loop.replay", 3, 13),
        ("fgc.graphs.get", 20, 22), ("fgc.loop.replay", 23, 25),      # same graph
        ("fgc.graphs.get", 30, 33), ("fgc.graphs.switch", 31, 32), ("fgc.loop.replay", 34, 64),
        ("fgc.graphs.get", 70, 72), ("fgc.graphs.switch", 70.5, 71), ("fgc.loop.replay", 73, 93),
    ]
    # device busy -10..5, 8..40, 44..60, 65..75, 80..100: idle 5..8, 40..44, 60..65, 75..80
    device = [("k", -10, 5), ("k", 8, 40), ("k", 44, 60), ("k", 65, 75), ("k", 80, 100)]
    ctx = _ctx(device, host)
    assert program_trace.switch_replays(ctx.stretch) == [(3, 13), (34, 64), (73, 93)]
    # idle inside each: 5..8 (3 us); 40..44 and 60..64 (8 us); 75..80 (5 us)
    switched = program_trace.switch_replays(ctx.stretch)
    assert program_trace.replay_idle_ms(ctx.stretch, switched) == pytest.approx(
        [0.003, 0.008, 0.005])
    assert graph_switch_ms.read(ctx) == pytest.approx(0.005)
    # every replay: -10..-5 and 23..25 hold no idle
    assert program_trace.replay_idle_ms(ctx.stretch) == pytest.approx(
        [0.0, 0.003, 0.0, 0.008, 0.005])
    assert replay_idle_ms.read(ctx) == pytest.approx(0.003)


def test_idle_that_overlaps_the_profilers_own_work_is_left_out():
    # the first idle hole of the replays (5..8) meets a buffer flush, the stall
    # in the draws' span (20..25 of DEVICE's hole) a buffer request
    device = [("k", -10, 5), ("k", 8, 40), ("k", 44, 60)]
    host = [("fgc.graphs.get", 0, 2), ("fgc.graphs.switch", 0.5, 1.5),
            ("fgc.loop.replay", 3, 58), ("Buffer Flush", 6, 7)]
    ctx = _ctx(device, host)
    assert program_trace.own_idle(ctx.stretch) == [(40, 44)]
    assert graph_switch_ms.read(ctx) == replay_idle_ms.read(ctx) == pytest.approx(0.004)
    host = HOST + [("Activity Buffer Request", 21, 22)]
    stall_us = (2 + 10) + 10              # the 20..30 hole overlaps it: all of it goes
    assert host_stall_pct.read(_ctx(host=host)) == pytest.approx(100.0 * stall_us / 200)


def test_solver_phases_forward_and_backward():
    device = [("fgc_mark_solver_begin", 0, 1), ("gather", 1, 5), ("fgc_mark_solver_end", 6, 7),
              ("chamfer", 7, 9), ("fgc_mark_solver_bwd_begin", 9, 10), ("scatter", 10, 16),
              ("fgc_mark_solver_bwd_end", 20, 21), ("gemm", 21, 30)]
    assert solver_step_ms.read(_ctx(device)) == pytest.approx(1e-3 * (4 + 6))


def test_nothing_is_read_from_a_program_without_the_tracer():
    device = [(n, a, b) for n, a, b in DEVICE if not n.startswith("fgc_mark_")]
    host = [(n, a, b) for n, a, b in HOST if not n.startswith("fgc.")]
    ctx = _ctx(device, host)
    for metric in (step_fwd_ms, step_bwd_ms, step_opt_ms, solver_step_ms, graph_switch_ms,
                   replay_idle_ms, host_stall_pct):
        assert metric.read(ctx) is None, metric.__name__


def test_host_prep_s_sums_the_outermost_prep_spans():
    from facet_graph_convolution_torch.utils.profiling import reset, span

    reset()
    try:
        assert host_prep_s.read(_ctx()) is None
        with span("fgc.prep.dataset") as dataset:
            with span("fgc.prep.coarsen"):
                pass
        with span("fgc.prep.upload") as upload:
            pass
        with span("fgc.loop.replay"):
            pass
        assert host_prep_s.read(_ctx()) == pytest.approx(dataset.seconds + upload.seconds)
    finally:
        reset()


def test_interval_arithmetic():
    xs = program_trace.merge([(5, 8), (0, 2), (1, 3), (8, 9)])
    assert xs == [(0, 3), (5, 9)]
    assert program_trace.intersect(xs, [(2, 6)]) == [(2, 3), (5, 6)]
    assert program_trace.subtract(xs, [(1, 2), (6, 7)]) == [(0, 1), (2, 3), (5, 6), (7, 9)]
    busy = program_trace.Busy([("a", 0, 3), ("b", 5, 9)])
    assert busy.within(2, 6) == 2 and busy.within(-5, 20) == 7 and busy.within(4, 4.5) == 0
