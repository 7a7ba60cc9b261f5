"""``k2_roofline_pct``: K2, the facet conv's backward kernels (the slot
pass and the transpose sum), against their roofline (layer: facet conv
kernels). Σ bound ÷ Σ device time over K2's launches in the traced
stretch.

A conv's bound, on the real nodes N of its level with S live slots, input
width C and M filters: bytes read once each, ``cat`` N·(C+M), ``ux`` N·M,
the neighbour indices S−N, the transpose map S−N, the multipliers S, ``c``
M, ``dz`` N·M·C, and written once ``dcat`` N·(C+M) and ``dux`` N·M;
operations S·M·(4C+10) (dx and dq, the softmax's Jacobian) plus (S−N)·(C+M)
adds of the transpose sum, at the float32 rate."""

from fgc_bench.core import model_shapes, peaks

KERNELS = ("slot_cotangents", "transpose_sum_kernel")


def conv_bound_s(n, slots, c, m, width):
    nbytes = width * (2 * n * (c + m) + 2 * n * m + m + n * m * c) + 4 * (2 * (slots - n) + slots)
    ops = slots * m * (4 * c + 10) + (slots - n) * (c + m)
    return max(nbytes / peaks.HBM_BYTES_PER_S, ops / peaks.F32_FLOPS)


def read(ctx):
    seconds, _ = ctx.stretch.device_time(lambda name: any(k in name for k in KERNELS))
    _, passes = ctx.stretch.device_time(lambda name: "transpose_sum_kernel" in name)
    convs = [c for c in model_shapes.convs(ctx.cell.config) if c[0] in ctx.session.kernel_convs("k2")]
    if not passes or not convs:
        return None
    m, width = ctx.cell.config["num_filters"], model_shapes.storage_bytes(ctx.cell.config)
    bound = 0.0
    for levels in ctx.session.step_levels(ctx.steps):
        for _, level, cin, _ in convs:
            g = levels[level]
            bound += conv_bound_s(int(g.real.sum()), g.live_slots, cin, m, width)
    # fixed a conv a step: where the profiler dropped launches, scaled down to the
    # launches it saw, never up (a design with more launches a conv keeps its bound)
    bound *= min(1.0, passes / (len(convs) * len(ctx.steps)))
    return 100.0 * bound / seconds
