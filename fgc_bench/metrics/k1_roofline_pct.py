"""``k1_roofline_pct``: K1, the facet conv's forward kernel, against its
roofline (layer: facet conv kernels). Σ bound ÷ Σ device time over K1's
launches in the traced stretch.

A launch's bound is the larger of its bytes at the HBM rate and its
operations at the float32 rate (the kernel's work is gathers, a softmax
and slot sums, outside the tensor cores). On the real nodes N of the
conv's level, with S live slots (the node and each neighbour), input
width C and M filters: bytes read once each, ``cat`` N·(C+M), ``ux`` N·M,
the neighbour indices S−N, the slot multipliers S, ``c`` M, and ``z``
N·M·C written once; operations S·M·(2C+6) (the aggregation's multiply-adds
as two, ~6 a filter for the softmax)."""

from fgc_bench.core import model_shapes, peaks

KERNEL = "facet_conv_fwd_kernel"


def launch_bound_s(n, slots, c, m, width):
    nbytes = width * (n * (c + m) + n * m + m + n * m * c) + 4 * ((slots - n) + slots)
    ops = slots * m * (2 * c + 6)
    return max(nbytes / peaks.HBM_BYTES_PER_S, ops / peaks.F32_FLOPS)


def read(ctx):
    seconds, launches = ctx.stretch.device_time(lambda name: KERNEL in name)
    convs = [c for c in model_shapes.convs(ctx.cell.config) if c[0] in ctx.session.kernel_convs("k1")]
    if not launches or not convs:
        return None
    m, width = ctx.cell.config["num_filters"], model_shapes.storage_bytes(ctx.cell.config)
    bound = 0.0
    for levels in ctx.session.step_levels(ctx.steps):
        for _, level, cin, _ in convs:
            g = levels[level]
            bound += launch_bound_s(int(g.real.sum()), g.live_slots, cin, m, width)
    # fixed a conv a step: where the profiler dropped launches, scaled down to the
    # launches it saw, never up (a design with more launches a conv keeps its bound)
    bound *= min(1.0, launches / (len(convs) * len(ctx.steps)))
    return 100.0 * bound / seconds
