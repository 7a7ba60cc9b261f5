"""Training: the train steps, Adam, checkpoints and the drivers."""

from facet_graph_convolution_torch.training.checkpoint import (  # noqa: F401
    CheckpointManager,
)
from facet_graph_convolution_torch.training.trainer import (  # noqa: F401
    TrainState,
    create_train_state,
    make_normals_train_step,
    make_vertex_train_step,
    train_normals,
    train_with_vertices,
)
