"""``step_bwd_ms``: the device time of a train step in the backward and its
gradient all-reduce, from the mark ``fwd_end`` to ``bwd_end`` (layer:
train step): the union of the device activities between the two marks of
the program's step (the marks left out), in ms, the mean over the steps of
the traced stretch. A graph step captures the marks, so every replay shows
them. A program without marks reads nothing."""

from fgc_bench.core import program_trace


def read(ctx):
    return program_trace.phase_ms(ctx.stretch, "fwd_end", "bwd_end")
