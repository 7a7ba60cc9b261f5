"""facet_graph_convolution_torch — the PyTorch and CUDA port of
``facet_graph_convolution_tpu`` for NVIDIA Hopper (H100).

It keeps its own copies of the host code (``config``, ``geometry``,
``graph``, ``data``) and imports nothing of the JAX package. The device path
is PyTorch, with every kernel that the JAX package wrote in Pallas rewritten
by hand in CUDA C++ under ``csrc/`` (see ``ops/facet_conv_kernel.py``).

Layers of the inference path, entry point first:

- ``cli.infer`` → ``inference.driver.infer_directory`` → ``infer_normals``;
- ``data.dataset.InferenceMesh`` builds the coarsened patches on the host;
- ``models.unet.unet_apply`` runs the U-Net forward per patch;
- ``ops.conv.facet_conv`` wraps the hand-written kernels of
  ``ops.facet_conv_kernel`` (K1 forward, K2 backward, one autograd Function);
- ``ops.vertex_update.update_positions_edges`` moves the vertices.

Layers of the training path:

- ``cli.preprocess`` → ``data.preprocess.preprocess_directory`` writes the
  ``.npz`` training set (host, one process per mesh);
- ``cli.train`` → ``training.trainer.train_normals`` → one train step per
  iteration (augmentation, U-Net forward, loss, backward, Adam);
- ``training.checkpoint.CheckpointManager`` writes ``step_<n>.pt`` and the
  ``params.pt`` that ``cli.infer`` serves.
"""

__version__ = "0.1.0"

from facet_graph_convolution_torch.config import Config, default_config  # noqa: F401
