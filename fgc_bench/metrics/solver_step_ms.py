"""``solver_step_ms``: the multi-scale solver's device time in a train
step as the graph step runs it (layer: multi-scale solver): the union of
the device activities from the mark ``solver_begin`` to ``solver_end``
(its forward) plus from ``solver_bwd_begin`` to ``solver_bwd_end`` (its
backward), in ms, the mean over the steps of the traced stretch. Beside
``solver_fwd_bwd_ms``, which times a separate graph of the solver alone. A
program without the solver's marks reads nothing."""

from fgc_bench.core import program_trace


def read(ctx):
    fwd = program_trace.phase_ms(ctx.stretch, "solver_begin", "solver_end")
    bwd = program_trace.phase_ms(ctx.stretch, "solver_bwd_begin", "solver_bwd_end")
    if fwd is None or bwd is None:
        return None
    return fwd + bwd
