"""Multi-rank runtime: the graph-parallel (halo-exchange) path over
``torch.distributed`` (the port's counterpart of
``facet_graph_convolution_tpu/parallel``).

- :mod:`mesh` — the :class:`~.mesh.GraphGroup` of ranks a partitioned graph
  runs on;
- :mod:`halo` — ONE large facet graph partitioned over the ranks with a
  per-conv halo exchange, reproducing the single-device result exactly: the
  sharded train step and ``train_normals_sharded``; at one rank it trains a
  million-face mesh whole on one H100;
- :mod:`vertex_halo` — the vertex-partitioned edge solver;
- :mod:`distributed` / :mod:`launch` — process-group bootstrap and the
  one-command launcher.

The port has one layout (row-major [N, C]), so JAX's node-minor forms are
not ported twice (:data:`JAX_ONLY`); :data:`NOT_YET_PORTED` names the JAX
re-exports that wait for later slices, and
:data:`.distributed.NO_COUNTERPART` the JAX functions that
``torch.distributed`` has no use for.
"""

from facet_graph_convolution_torch.parallel.mesh import (  # noqa: F401
    make_mesh,
    local_device_count,
)
from facet_graph_convolution_torch.parallel.halo import (  # noqa: F401
    GraphPartition,
    build_partition,
    sharded_unet_apply,
    make_sharded_train_step,
    train_normals_sharded,
)
from facet_graph_convolution_torch.parallel.vertex_halo import (  # noqa: F401
    partition_index_map,
    sharded_update_positions_edges,
)

# node-minor forms of names the port has in its one layout
# (partition_operands, sharded_unet_forward_local)
JAX_ONLY = ("partition_operands_nminor", "sharded_unet_forward_local_nminor")

# JAX re-exports that wait for later slices: data parallelism, tensor
# parallelism, the sharded multi-scale solver and the sharded vertex trainer
NOT_YET_PORTED = (
    "make_dp_train_step", "stack_patches", "train_normals_dp",
    "shard_unet_params", "unet_param_shardings",
    "sharded_update_positions_multiscale",
    "make_sharded_vertex_train_step", "prepare_vertex_training",
    "train_with_vertices_sharded",
)
