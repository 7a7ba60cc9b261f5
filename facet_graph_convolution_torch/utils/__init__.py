"""Utilities: profiling, NaN guards."""

from facet_graph_convolution_torch.utils.profiling import (  # noqa: F401
    StepTimer,
    trace_context,
    edges_per_second,
)
from facet_graph_convolution_torch.utils.guards import (  # noqa: F401
    has_nonfinite,
    assert_finite_tree,
)
