"""``step_mfu_pct``: the whole train step's share of the card's peak (layer:
train step). The model's products over the traced steps, forward and
backward (three times the forward's: the input's and the weights'
gradients each cost a forward), over the stretch's seconds times the
tensor-core peak of the configuration's precision.

Products counted a step, on the real nodes N_l of each level: per conv of
``in`` → ``out`` channels with M filters, the two assignment projections
(2·N·in·M each) and the transform (2·N·M·in·out); per dense layer
2·N·in·out. Nothing recomputed is counted."""

from fgc_bench.core import model_shapes, peaks


def step_products(config, heads, real_nodes):
    m = config["num_filters"]
    total = 0
    for _, level, cin, cout in model_shapes.convs(config):
        n = real_nodes[level]
        total += 2 * n * cin * m * 2 + 2 * n * m * cin * cout
    for _, level, cin, cout in model_shapes.dense(config, heads):
        total += 2 * real_nodes[level] * cin * cout
    return total


def read(ctx):
    s = ctx.stretch
    if s.window_s <= 0 or not ctx.steps:
        return None
    config = ctx.cell.config
    ops = 0
    for levels in ctx.session.step_levels(ctx.steps):
        ops += 3 * step_products(config, ctx.session.heads, [int(g.real.sum()) for g in levels])
    return 100.0 * ops / (s.window_s * peaks.TENSOR_FLOPS[config["compute_dtype"]])
