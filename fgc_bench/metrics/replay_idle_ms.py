"""``replay_idle_ms``: the device's idle in a call's graph replays (layer:
training loop): the median, over every call of the traced stretch, of the
device idle ms inside the call's ``fgc.loop.replay`` span, less the gaps
that overlap the profiler's own work (``program_trace.own_idle``). Beside
``graph_switch_ms``, the same over the calls that switched graphs. A
program without the span reads nothing."""

import statistics

from fgc_bench.core import program_trace


def read(ctx):
    idle = program_trace.replay_idle_ms(ctx.stretch)
    return statistics.median(idle) if idle else None
