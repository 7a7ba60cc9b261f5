"""Evaluation (the port's copy of the JAX package's): angular/Hausdorff
metrics, heatmaps, CSV reports, the TF1 checkpoint bridge and activation
parity."""

from facet_graph_convolution_torch.evaluation.metrics import (  # noqa: F401
    angular_error,
    angular_error_stats,
    one_sided_hausdorff,
    hausdorff_oversampled,
)
from facet_graph_convolution_torch.evaluation.driver import compute_metrics  # noqa: F401
from facet_graph_convolution_torch.evaluation.parity import (  # noqa: F401
    capture_activations,
    compare_activations,
    export_activations,
)
from facet_graph_convolution_torch.evaluation.tf_checkpoint import (  # noqa: F401
    export_unet_to_tf,
    load_reference_unet,
    read_tf_checkpoint,
    write_tf_checkpoint,
)
