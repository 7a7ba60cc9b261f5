"""``host_stall_pct``: the share of the traced stretch in which the device
sat idle while the host was inside a stage of the program (layer: training
loop): the idle intervals (no device activity) that fall inside a program
span (``fgc.*``) other than the losses' wait, over the stretch. Idle in
the harness's own code, or while the host waits, is not counted, nor a gap
that overlaps the profiler's own work (``program_trace.own_idle``). A
program without spans reads nothing."""

from fgc_bench.core import program_trace


def read(ctx):
    s = ctx.stretch
    stall = program_trace.host_stall_s(s)
    if stall is None or s.window_s <= 0:
        return None
    return 100.0 * stall / s.window_s
