"""Host facet-graph construction, coarsening, patching and host tables."""
