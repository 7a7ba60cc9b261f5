"""Datasets and preprocessing: mesh → padded facet-graph patches, the
``.npz`` sets and the streaming shards."""

from facet_graph_convolution_torch.data.dataset import (  # noqa: F401
    FacetPatch,
    MeshDataset,
    TrainingSet,
    InferenceMesh,
    build_patch,
    save_dataset,
    load_dataset,
)
from facet_graph_convolution_torch.data.preprocess import preprocess_directory  # noqa: F401
from facet_graph_convolution_torch.data.stream import (  # noqa: F401
    PrefetchLoader,
    ShardedDataset,
    save_sharded,
)
