"""Utilities: NaN guards, and the tracer (``utils.profiling``: spans,
device marks and their totals; see its docstring)."""

from facet_graph_convolution_torch.utils.guards import (  # noqa: F401
    has_nonfinite,
    assert_finite_tree,
)

# the JAX package's profiling helpers (a step timer, a trace exporter, an
# edges/s division), which the port's tracer replaces
JAX_ONLY = ("StepTimer", "trace_context", "edges_per_second")
