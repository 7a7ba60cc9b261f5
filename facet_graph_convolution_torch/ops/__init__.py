"""Device ops: normalization, pooling, the facet conv and its kernel, the vertex solver."""
