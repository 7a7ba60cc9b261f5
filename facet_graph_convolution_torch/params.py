"""Parameter interchange with the JAX package, and the port's checkpoints.

The port keeps the JAX pytree's structure: a dict of layers, each a dict of
float32 tensors with the layouts of ``facet_graph_convolution_tpu/ops/
conv.py:53-90``:

- facet conv: ``w`` [M, out, in], ``b`` [out], ``u`` [M, in], ``c`` [M], and
  ``v`` [M, in] for the default variant;
- linear: ``w`` [in, out], ``b`` [out].

A checkpoint is ``torch.save`` of the dict, on the CPU, in
``<network_path>/<net_name>/params.pt``; the JAX package's Orbax checkpoints
are not read (convert their restored pytree with :func:`params_from_jax`).
"""

from __future__ import annotations

import os
from typing import Dict, Mapping

import numpy as np
import torch

CHECKPOINT_FILE = "params.pt"


def params_from_jax(tree: Mapping, device: str = "cuda") -> Dict[str, Dict[str, torch.Tensor]]:
    """The port's parameters from a JAX parameter pytree whose leaves are
    already numpy arrays (e.g. ``jax.tree.map(np.asarray, params)``)."""
    return {
        layer: {name: torch.tensor(np.asarray(arr, np.float32), device=device)
                for name, arr in leaves.items()}
        for layer, leaves in tree.items()
    }


def params_to_numpy(params: Mapping) -> Dict[str, Dict[str, np.ndarray]]:
    """The same dict with numpy leaves (the JAX package's layout)."""
    return {
        layer: {name: t.detach().cpu().numpy() for name, t in leaves.items()}
        for layer, leaves in params.items()
    }


def checkpoint_path(network_path: str, net_name: str) -> str:
    return os.path.join(network_path, net_name, CHECKPOINT_FILE)


def save(params: Mapping, path: str) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save({layer: {name: t.detach().cpu() for name, t in leaves.items()}
                for layer, leaves in params.items()}, path)


def load(path: str, device: str = "cuda") -> Dict[str, Dict[str, torch.Tensor]]:
    # weights_only: the file holds nested dicts of tensors and nothing that
    # unpickling could execute
    tree = torch.load(path, map_location="cpu", weights_only=True)
    return {layer: {name: t.to(device) for name, t in leaves.items()}
            for layer, leaves in tree.items()}
