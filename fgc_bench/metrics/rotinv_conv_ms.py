"""``rotinv_conv_ms``: the rotation-invariant conv's device time in a train
step (layer: rotation-invariant conv): the union of the device activities
from the mark ``rotinv_begin`` to ``rotinv_end`` (its forward: the gather,
the rotation features, the logits and K3) plus from ``rotinv_bwd_begin`` to
``rotinv_bwd_end`` (its backward: K3's backward and the logits'), in ms,
the mean over the steps of the traced stretch. A program without these
marks reads nothing."""

from fgc_bench.core import program_trace


def read(ctx):
    fwd = program_trace.phase_ms(ctx.stretch, "rotinv_begin", "rotinv_end")
    bwd = program_trace.phase_ms(ctx.stretch, "rotinv_bwd_begin", "rotinv_bwd_end")
    if fwd is None or bwd is None:
        return None
    return fwd + bwd
