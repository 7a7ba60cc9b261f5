"""Inference: patch prediction, overlap reassembly, vertex refinement,
batched serving and the exported forward.

The JAX package's names are re-exported lazily, at their first use:
importing ``inference.exported`` (which runs an exported program) must load
no model code.
"""

import importlib

_EXPORTS = {
    "infer_normals": "driver",
    "infer_with_vertices": "driver",
    "infer_directory": "driver",
    "InferenceServer": "serving",
    "export_forward": "serving",
    "load_forward": "exported",
    "infer_normals_sharded": "sharded",
    "infer_with_vertices_sharded": "sharded",
}
__all__ = sorted(_EXPORTS)

# every JAX re-export has its counterpart
NOT_YET_PORTED = ()


def __getattr__(name):
    if name in _EXPORTS:
        return getattr(importlib.import_module(f"{__name__}.{_EXPORTS[name]}"), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
