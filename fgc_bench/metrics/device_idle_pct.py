"""``device_idle_pct``: the share of the traced stretch in which no
device activity ran (layer: device). From the profiler's CUDA activities:
100 · (1 − busy / window), busy the union of the activities' intervals."""


def read(ctx):
    s = ctx.stretch
    if s.window_s <= 0 or not s.events:
        return None
    return 100.0 * (1.0 - s.busy_s / s.window_s)
