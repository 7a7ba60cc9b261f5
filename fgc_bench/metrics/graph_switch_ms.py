"""``graph_switch_ms``: the device's idle in a call's replays after a
switch of graphs (layer: training loop): the median, over the traced
stretch's calls whose ``GraphCache`` get changed the key (the span
``fgc.graphs.switch`` inside ``fgc.graphs.get``), of the device idle ms
inside the call's ``fgc.loop.replay`` span, less the gaps that overlap the
profiler's own work (``program_trace.own_idle``). Idle, not the span's
host ms: the host blocks in the replays' graph launches until the device
has room, so the span lasts about as long as the call's device work.
``replay_idle_ms`` reads the same over every call: the two side by side
say whether a switch adds idle. A program without those spans reads
nothing."""

import statistics

from fgc_bench.core import program_trace


def read(ctx):
    s = ctx.stretch
    stalls = program_trace.replay_idle_ms(s, program_trace.switch_replays(s))
    return statistics.median(stalls) if stalls else None
