"""``k5_bwd_roofline_pct``: K5's backward (its slot, weight-gradient,
source-gradient and partial-sum kernels; layer: windowed conv) against its
roofline. Σ bound ÷ Σ device time over those launches in the traced
stretch.

A conv's bound is the largest of: its bytes at the HBM rate, each read
once (``cat`` N·(C+M), ``ux`` N·M, the flat weights out·M·C, ``c`` M, the
multipliers S, the neighbour indices and their transpose 2·(S−N), ``gy``
N·out) and each gradient written once (``dcat`` N·(C+M), ``dux`` N·M,
``dW`` out·M·C, ``dc`` M); its two products (dz and dW), 2 · 2·N·M·C·out, at
the tensor-core peak of the configuration's precision; and its slot work
at the float32 rate, S·M·(4C+10) for dx, dq and the softmax's Jacobian, as
K2 counts the same function (nothing recomputed is counted)."""

from fgc_bench.core import model_shapes, peaks

KERNELS = ("windowed_bwd_", "windowed_sum_")
PER_CONV = "windowed_bwd_slots_kernel"


def conv_bound_s(n, slots, c, m, out, width, precision):
    nbytes = (width * (2 * n * (c + m) + 2 * n * m + 2 * out * m * c + n * out)
              + 4 * (2 * m + slots + 2 * (slots - n)))
    return max(nbytes / peaks.HBM_BYTES_PER_S,
               2 * 2 * n * m * c * out / peaks.TENSOR_FLOPS[precision],
               slots * m * (4 * c + 10) / peaks.F32_FLOPS)


def read(ctx):
    seconds, _ = ctx.stretch.device_time(lambda name: any(k in name for k in KERNELS))
    _, launches = ctx.stretch.device_time(lambda name: PER_CONV in name)
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
