"""Run an exported batched forward (the loading side of
:func:`facet_graph_convolution_torch.inference.serving.export_forward`; the
JAX package's ``load_forward``, ``save_exported`` and ``load_exported``,
``inference/serving.py:348-370``).

An exported forward is the bytes of a ``torch.export`` program of the
batched U-Net forward (the kernel configuration, with the per-patch
normalization), together with a small JSON record of its shapes. The program
takes the kernel's tables, which are built beside it on the host: the
callable of :func:`load_forward` takes ``([params,] x [B, N, 6], adj0, adj1,
adj2)`` as the JAX one does, the raw one-indexed K-lists ``[B, N/4^l, K_l]``
of B patches padded to one bucket, builds the block-diagonal tables of
:func:`..graph.convert.batched_level_tables` with the widths the program was
exported for, and runs the program.

A loading process imports this module, which imports the port's ops modules
:mod:`..ops.facet_conv_kernel` and :mod:`..ops.bias_lrelu_kernel` (importing
them registers K1 and the bias + lrelu kernel as the operators
``torch.ops.facet_graph_convolution.facet_conv_fwd`` and ``.bias_lrelu``,
which the program calls), the NumPy table builder :mod:`..graph.convert` and
:mod:`..config`, and nothing of the model code (``models/``). On CUDA inputs
the program launches the kernels; on CPU inputs, their plain versions.
"""

from __future__ import annotations

import io
import json
import os
from typing import Callable

import numpy as np
import torch

from facet_graph_convolution_torch.config import resolve_device
from facet_graph_convolution_torch.graph.convert import batched_level_tables
from facet_graph_convolution_torch.ops import bias_lrelu_kernel  # noqa: F401  (registers it)
from facet_graph_convolution_torch.ops import facet_conv_kernel  # noqa: F401  (registers K1)

META_FILE = "facet_graph_convolution_forward.json"


def program_bytes(program: "torch.export.ExportedProgram", meta: dict) -> bytes:
    """``program`` and its record ``meta`` as the bytes of one artifact."""
    buf = io.BytesIO()
    torch.export.save(program, buf, extra_files={META_FILE: json.dumps(meta)})
    return buf.getvalue()


def load_forward(data: bytes, device: str = "cuda") -> Callable:
    """The exported forward of ``data`` as a callable ``([params,] x,
    adj0, adj1, adj2) → normals [B, N, 3]`` (the three heads' tuple for a
    multi-scale export) on ``device``: pass the params dict first unless the
    export baked them in. Inputs may be NumPy arrays or tensors; the tables
    are built on the host and everything is moved to ``device``."""
    dev = resolve_device(device)
    extra = {META_FILE: ""}
    program = torch.export.load(io.BytesIO(data), extra_files=extra)
    meta = json.loads(extra[META_FILE])
    module = program.module()

    def run(*args):
        if len(args) != (4 if meta["baked"] else 5):
            raise TypeError(f"the exported forward takes {'' if meta['baked'] else 'params, '}"
                            f"x, adj0, adj1, adj2; got {len(args)} arguments")
        x, adjs = args[-4], args[-3:]
        host = [a.cpu().numpy() if torch.is_tensor(a) else np.asarray(a) for a in adjs]
        tables = batched_level_tables(host, meta["group"], meta["widths"])
        flat = [torch.as_tensor(t, device=dev) for level in tables for t in level]
        x = torch.as_tensor(x, dtype=torch.float32, device=dev)
        with torch.no_grad():
            if meta["baked"]:
                return module(x, *flat)
            params = {layer: {name: t.to(dev) for name, t in leaves.items()}
                      for layer, leaves in args[0].items()}
            return module(params, x, *flat)

    run.meta = meta
    return run


def save_exported(path: str, data: bytes) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as fh:
        fh.write(data)


def load_exported(path: str) -> bytes:
    with open(path, "rb") as fh:
        return fh.read()
