"""``solver_fwd_bwd_ms``: one forward and backward of the operator
multi-scale solver (layer: multi-scale solver) at the cell's largest
patch, on its inputs and the heads of the current weights, captured in a
CUDA graph as the train step runs it and timed from outside by CUDA events
over replays after a warm-up, in the traced run.
A cell whose driver runs no solver reads nothing."""


def read(ctx):
    timer = getattr(ctx.session, "solver_ms", None)
    return None if timer is None else timer()
