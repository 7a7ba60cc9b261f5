"""``k3_fwd_roofline_pct``: K3, the rotation-invariant conv's assignment
and slot sums (``weighted_aggregate_kernel``), against its roofline (layer:
rotation-invariant conv). Σ bound ÷ Σ device time over K3's launches in
the traced stretch.

A launch's bound is the larger of its bytes at the HBM rate and its
operations at the float32 rate (gathers of rows, a softmax and slot sums,
outside the tensor cores). On the real nodes N of the conv's level, with S
live slots (the node and each neighbour), input width C and M filters:
bytes read once each, the logits S·M and the slot multipliers S (float32),
the slots' rows ``x_slots`` S·C, and ``z`` N·M·C written once; operations
S·M·(2C+6) (the aggregation's multiply-adds as two, ~6 a filter for the
softmax and the multiplier)."""

from fgc_bench.core import model_shapes, peaks

KERNEL = "weighted_aggregate_kernel"


def launch_bound_s(n, slots, c, m, width):
    nbytes = 4 * (slots * m + slots) + width * (slots * c + n * m * c)
    ops = slots * m * (2 * c + 6)
    return max(nbytes / peaks.HBM_BYTES_PER_S, ops / peaks.F32_FLOPS)


def k3_share(ctx, kernel, bound_s):
    """100 × Σ bound ÷ Σ device time of ``kernel``'s launches, a bound a conv
    a step from ``bound_s(n, slots, c, m, width)``; None where the stretch
    holds no launch or the session names no conv of K3."""
    # the whole name: the kernels sit in an anonymous namespace, whose
    # "(anonymous namespace)::" a cut at the argument list would stop at
    seconds, launches = ctx.stretch.device_time(lambda name: kernel in name)
    convs = [c for c in model_shapes.convs(ctx.cell.config)
             if c[0] in ctx.session.kernel_convs("k3")]
    if not launches or not convs:
        return None
    m, width = ctx.cell.config["num_filters"], model_shapes.storage_bytes(ctx.cell.config)
    bound = 0.0
    for levels in ctx.session.step_levels(ctx.steps):
        for _, level, cin, _ in convs:
            g = levels[level]
            bound += bound_s(int(g.real.sum()), g.live_slots, cin, m, width)
    # fixed a conv a step: where the profiler dropped launches, scaled down to the
    # launches it saw, never up (a design with more launches a conv keeps its bound)
    bound *= min(1.0, launches / (len(convs) * len(ctx.steps)))
    return 100.0 * bound / seconds


def read(ctx):
    return k3_share(ctx, KERNEL, launch_bound_s)
