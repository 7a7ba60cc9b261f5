"""Reference-parity harness: per-layer activation comparison.

The port's counterpart of ``facet_graph_convolution_tpu/evaluation/
parity.py``. BASELINE.md's verification plan calls for per-layer activation
``allclose`` against the reference network on identical inputs. The
reference is TF1, so the harness works over an exported ``.npz`` exchange
format:

- :func:`export_activations` runs the U-Net capturing every intermediate and
  writes them (plus the inputs and the raw K-lists) to npz;
- :func:`compare_activations` loads two such files (ours against a
  reference export with matching names, or the JAX package's) and reports
  per-layer max-abs differences.

:func:`capture_activations` takes a patch's raw one-indexed K-lists, as the
JAX one does, builds their kernel tables
(:func:`..models.unet.graph_tensors`) and runs the U-Net of
:mod:`..models.unet` on them, so each of the 8 convs is
:func:`..ops.conv.facet_conv`: K1 on the card, its plain version on the CPU.
The JAX capture gathers node 0 into pad slots and zeroes them by
multiplicity; the port's tables skip them. Both record conv outputs, not
gathered rows, so the two agree.

Layer names follow the reference scopes (model.py:853-941): conv1,
conv1_act, pool1, conv2, pool2, conv3, dconv3, upsamp2, upconv2, dconv2,
upsamp1, upconv1, dconv1, fc1, out0.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from facet_graph_convolution_torch.config import resolve_device
from facet_graph_convolution_torch.models.unet import _network, graph_tensors
from facet_graph_convolution_torch.ops.conv import FacetConvVariant, facet_conv


def capture_activations(
    params: Dict,
    x,
    adjs: Sequence[np.ndarray],
    coarsening_steps: int = 2,
    alpha: float = 0.1,
    device: str = "cuda",
) -> Dict[str, np.ndarray]:
    """The single-scale forward of :func:`..models.unet.unet_apply` on a
    patch's inputs ``x`` [N, 6] and raw K-lists ``adjs`` (3 levels), every
    named intermediate copied to the host. ``params`` lie on ``device``;
    raises without a card unless ``device`` is ``cpu``."""
    dev = resolve_device(device)
    x = torch.as_tensor(np.asarray(x, np.float32), device=dev)
    tables, rows = graph_tensors(adjs, dev)
    acts: Dict[str, np.ndarray] = {}

    def record(name, t):
        acts[name] = t.detach().cpu().numpy()

    def conv(name, h, level):
        out = facet_conv(params[name], h, tables[level], rows[level],
                         variant=FacetConvVariant.DEFAULT)
        record(name, out)
        return out

    record("input", x)
    with torch.no_grad():
        _network(params, x, conv, len(adjs), coarsening_steps, alpha, False, record)
    return acts


def export_activations(path: str, params, x, adjs, **kwargs) -> Dict[str, np.ndarray]:
    """:func:`capture_activations`, written to ``path`` as ``act_<name>``
    beside ``input_x`` and ``adj_<level>``."""
    acts = capture_activations(params, x, adjs, **kwargs)
    arrays = {f"act_{k}": v for k, v in acts.items()}
    arrays["input_x"] = acts["input"]
    for i, a in enumerate(adjs):
        arrays[f"adj_{i}"] = np.asarray(a)
    np.savez_compressed(path, **arrays)
    return acts


def compare_activations(
    path_a: str, path_b: str, atol: float = 1e-4
) -> Dict[str, float]:
    """Per-layer max-abs difference between two exports; raises AssertionError
    listing offending layers when any exceeds ``atol``."""
    a = np.load(path_a)
    b = np.load(path_b)
    report: Dict[str, float] = {}
    failures = []
    for key in sorted(a.files):
        if not key.startswith("act_"):
            continue
        if key not in b.files:
            failures.append(f"{key}: missing in {path_b}")
            continue
        diff = float(np.max(np.abs(a[key] - b[key])))
        report[key[4:]] = diff
        if diff > atol:
            failures.append(f"{key[4:]}: max|Δ| = {diff:.3e}")
    if failures:
        raise AssertionError("activation parity failed:\n  " + "\n  ".join(failures))
    return report
