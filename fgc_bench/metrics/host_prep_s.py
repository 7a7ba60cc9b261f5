"""``host_prep_s``: the host seconds of the program's preprocessing in the
run's set-up (layer: host preprocessing). The outermost ``fgc.prep.*``
spans of the program's tracer (its dataset, partition, windows and
uploads), summed from its in-memory totals; the loop opens none, so what
the totals hold when the traced stretch is read is the set-up's. A program
without the tracer reads nothing."""


def read(ctx):
    try:
        from facet_graph_convolution_torch.utils.profiling import totals
    except ImportError:
        return None
    prep = [t["outer_seconds"] for name, t in totals().items() if name.startswith("fgc.prep.")]
    return sum(prep) if prep else None
