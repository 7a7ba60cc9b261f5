"""Multi-rank runtime over ``torch.distributed`` (the port's counterpart of
``facet_graph_convolution_tpu/parallel``).

- :mod:`mesh` — the :class:`~.mesh.GraphGroup` of ranks a partitioned graph
  runs on;
- :mod:`data_parallel` — patch-batch data parallelism: a patch a rank a
  step, gradients averaged over the ranks;
- :mod:`halo` — ONE large facet graph partitioned over the ranks with a
  per-conv halo exchange, reproducing the single-device result exactly: the
  sharded train step, ``train_normals_sharded`` and, over several meshes,
  ``train_normals_sharded_multi``; at one rank it trains a million-face
  mesh whole on one H100, its two finest levels through K5, the windowed
  fused conv;
- :mod:`vertex_halo` — the vertex-partitioned solvers: the edge solver and
  the multi-scale solver (K4 pools every iteration on the card);
- :mod:`vertex_train` — sharded end-to-end vertex training (chamfer through
  the sharded multi-scale solver);
- :mod:`tensor_parallel` — the fc head split over the ranks (Megatron);
- :mod:`distributed` / :mod:`launch` — process-group bootstrap and the
  one-command launcher.

The port has one layout (row-major [N, C]), so JAX's node-minor forms are
not ported twice (:data:`JAX_ONLY`); :data:`NOT_YET_PORTED` is empty: every
other JAX re-export has its counterpart. :data:`.distributed.NO_COUNTERPART`
names the JAX functions that ``torch.distributed`` has no use for.
"""

from facet_graph_convolution_torch.parallel.mesh import (  # noqa: F401
    make_mesh,
    local_device_count,
)
from facet_graph_convolution_torch.parallel.data_parallel import (  # noqa: F401
    make_dp_train_step,
    stack_patches,
    train_normals_dp,
)
from facet_graph_convolution_torch.parallel.tensor_parallel import (  # noqa: F401
    shard_unet_params,
    unet_param_shardings,
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
    sharded_update_positions_multiscale,
)
from facet_graph_convolution_torch.parallel.vertex_train import (  # noqa: F401
    make_sharded_vertex_train_step,
    prepare_vertex_training,
    train_with_vertices_sharded,
)

# node-minor forms of names the port has in its one layout
# (partition_operands, sharded_unet_forward_local)
JAX_ONLY = ("partition_operands_nminor", "sharded_unet_forward_local_nminor")

# every other JAX re-export has its counterpart
NOT_YET_PORTED = ()
