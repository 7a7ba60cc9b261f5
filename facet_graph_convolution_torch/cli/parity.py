"""Activation-parity CLI of the port: BASELINE.md's verification plan on
the card.

    python -m facet_graph_convolution_torch.cli.parity --device cuda \
        --checkpoint Networks/net-300000 \
        --mesh Data/noisy/sphere_n1.obj \
        --out ours.npz [--reference reference_acts.npz] [--atol 1e-4]

Reads the reference's TF1 checkpoint (pure-Python reader,
``evaluation/tf_checkpoint.py``) onto ``--device``, builds the mesh's graph
pyramid as serving does (coarsening seed 0) and runs the forward of its first
patch through K1, capturing every intermediate, into ``--out``. With
``--reference`` (another export on the same inputs: a TF run's, the JAX
package's ``cli.parity``, or the port's on the plain conv) it asserts
per-layer allclose at ``--atol`` and prints a JSON line with
``"parity": "PASS"`` and the per-layer max-abs report. ``--device``
defaults to ``cuda``; without a card, pass ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import sys

from facet_graph_convolution_torch.config import default_config, parse_device
from facet_graph_convolution_torch.data.dataset import InferenceMesh
from facet_graph_convolution_torch.evaluation.parity import (
    compare_activations,
    export_activations,
)
from facet_graph_convolution_torch.evaluation.tf_checkpoint import load_reference_unet
from facet_graph_convolution_torch.geometry.obj_io import load_obj


def parity_patch(mesh_path: str):
    """The patch the CLI captures: the first of the mesh's patches, built
    with the default config's sizes and coarsening seed 0."""
    cfg = default_config()
    vertices, faces, _ = load_obj(mesh_path)
    ds = InferenceMesh(
        max_patch_size=cfg.data.max_patch_size,
        min_patch_size=cfg.data.min_patch_size,
        coarsening_steps=cfg.model.coarsening_steps,
        coarsening_levels=cfg.model.coarsening_levels,
        k_faces=cfg.data.k_faces, seed=0,
    )
    ds.add_mesh(vertices, faces)
    return ds.patches[0]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--checkpoint", required=True,
                    help="reference TF1 checkpoint prefix (…/net-300000)")
    ap.add_argument("--mesh", required=True, help="input .obj mesh")
    ap.add_argument("--out", required=True, help="our activations npz")
    ap.add_argument("--reference", default=None,
                    help="reference activations npz to compare against")
    ap.add_argument("--atol", type=float, default=1e-4)
    ap.add_argument("--device", type=str, default=None,
                    help="torch device (default cuda; cpu without a card)")
    args = ap.parse_args(argv)
    device = parse_device(args.device)

    params, multi_scale = load_reference_unet(args.checkpoint, device=device)
    print(f"imported reference checkpoint ({'multi-scale' if multi_scale else 'single-scale'})")

    patch = parity_patch(args.mesh)
    acts = export_activations(args.out, params, patch.inputs, patch.adjs, device=device)
    print(f"wrote {args.out}: {sorted(acts)}")

    if args.reference:
        report = compare_activations(args.out, args.reference, atol=args.atol)
        print(json.dumps({"parity": "PASS",
                          "max_abs_diff": max(report.values()),
                          "layers": report}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
