"""``k5_fwd_roofline_pct``: K5's forward, the windowed conv's one kernel a
conv (layer: windowed conv), against its roofline. Σ bound ÷ Σ device time
over its launches in the traced stretch.

A conv's bound is the largest of three terms (the tensor cores and the
CUDA cores run at once): its bytes at the HBM rate, each read once
(``cat`` N·(C+M), ``ux`` N·M, the flat weights out·M·C, ``c`` M, the
multipliers S, the neighbour indices S−N) and ``y`` N·out written once;
its product 2·N·M·C·out at the tensor-core peak of the configuration's
precision; and its slot work S·M·(2C+6) at the float32 rate. N is the real
nodes of the conv's level, S their live slots, C its input width."""

from fgc_bench.core import model_shapes, peaks

KERNEL = "windowed_conv_fwd_kernel"


def conv_bound_s(n, slots, c, m, out, width, precision):
    nbytes = width * (n * (c + m) + n * m + out * m * c + n * out) + 4 * (m + slots + slots - n)
    return max(nbytes / peaks.HBM_BYTES_PER_S,
               2 * n * m * c * out / peaks.TENSOR_FLOPS[precision],
               slots * m * (2 * c + 6) / peaks.F32_FLOPS)


def read(ctx):
    seconds, launches = ctx.stretch.device_time(lambda name: KERNEL in name)
    convs = [c for c in model_shapes.convs(ctx.cell.config) if c[0] in ctx.session.kernel_convs("k5")]
    if not launches or not convs:
        return None
    config = ctx.cell.config
    m, width = config["num_filters"], model_shapes.storage_bytes(config)
    bound = 0.0
    for levels in ctx.session.step_levels(ctx.steps):
        for _, level, cin, cout in convs:
            g = levels[level]
            bound += conv_bound_s(int(g.real.sum()), g.live_slots, cin, m, cout, width,
                                  config["compute_dtype"])
    # fixed a conv a step: where the profiler dropped launches, scaled down to the
    # launches it saw, never up (a design with more launches a conv keeps its bound)
    bound *= min(1.0, launches / (len(convs) * len(ctx.steps)))
    return 100.0 * bound / seconds
