"""The facet-graph U-Net."""
