"""Inference CLI of the port (reference ``infer.py:126-164``):

    python -m facet_graph_convolution_torch.cli.infer --device cuda \
        --input_dir <dir of .obj> --network_path <dir> --results_path <dir>

Denoises every OBJ of ``--input_dir`` (default: the config's test data path)
with the checkpoint ``<network_path>/<net_name>/params.pt``. With
``--include_vertices`` it serves the vertex pipeline (a multi-scale
checkpoint's three heads and the multi-scale vertex solver, per the config's
``vertex_solver``) and writes the denoised, mid and coarse points and the
three heads' colored meshes; without it, the normals pipeline. ``--device``
defaults to ``cuda``; without a card, pass ``--device cpu``.

As the JAX package's CLI (its ``cli/infer.py:18-72``), two serving
extensions the reference lacks:

- ``--batch`` serves every input mesh through the batched
  :class:`~facet_graph_convolution_torch.inference.serving.InferenceServer`
  (one forward for every patch of every mesh; under ``--include_vertices``
  the naive vertex solver) and writes ``<name>_denoised.obj`` a mesh;
- ``--export_forward <path>`` writes the batched forward as a
  ``torch.export`` program for ``--export_nodes`` nodes and the K-list widths
  ``--export_widths`` (the three heads under ``--include_vertices``), with
  the parameters as an argument unless ``--bake_params``, and exits.

``--seed`` fixes the coarsening seed: without it the per-mesh path builds
each pyramid unseeded (as the JAX package's does) and the server seeds 0.
"""

import argparse
import glob
import os

from facet_graph_convolution_torch.config import (
    add_cli_overrides,
    config_from_args,
    parse_device,
    resolve_device,
)
from facet_graph_convolution_torch.inference.driver import infer_directory


def main(argv=None):
    parser = add_cli_overrides(argparse.ArgumentParser())
    parser.add_argument("--batch", action="store_true",
                        help="serve all meshes via one batched forward")
    parser.add_argument("--export_forward", type=str, default=None,
                        help="write an exported forward program to this path and exit")
    parser.add_argument("--export_nodes", type=int, default=21504,
                        help="node bucket size for --export_forward")
    parser.add_argument("--export_widths", type=str, default="23,23,23",
                        help="per-level adjacency widths for --export_forward")
    parser.add_argument("--bake_params", action="store_true",
                        help="freeze weights into the exported program (default: params "
                             "are a call argument, so checkpoints swap without re-export)")
    parser.add_argument("--seed", type=int, default=None,
                        help="coarsening seed (default: unseeded per mesh, 0 with --batch)")
    args = parser.parse_args(argv)
    cfg = config_from_args(args)
    device = parse_device(args.device)

    if args.export_forward:
        from facet_graph_convolution_torch.inference.driver import _restore_params
        from facet_graph_convolution_torch.inference.serving import export_forward, save_exported

        multi = cfg.model.include_vertices
        params = _restore_params(cfg, resolve_device(device))
        widths = [int(w) for w in args.export_widths.split(",")]
        data = export_forward(cfg, params, args.export_nodes, widths, multi_scale=multi,
                              bake_params=args.bake_params)
        save_exported(args.export_forward, data)
        print(f"Exported {'multi-scale ' if multi else ''}forward → {args.export_forward} "
              f"({len(data)} bytes, params {'baked' if args.bake_params else 'as argument'})")
        return

    input_dir = args.input_dir or cfg.data.test_data_path
    if args.batch:
        from facet_graph_convolution_torch.geometry.obj_io import load_obj, write_obj
        from facet_graph_convolution_torch.inference.serving import InferenceServer

        with_verts = cfg.model.include_vertices
        server = InferenceServer(cfg, include_vertices=with_verts, device=device,
                                 seed=0 if args.seed is None else args.seed)
        paths = sorted(glob.glob(os.path.join(input_dir, "*.obj")))
        meshes = []
        for p in paths:
            v, f, _ = load_obj(p)
            meshes.append((v, f))
        results = server.denoise_batch(meshes)
        os.makedirs(cfg.eval.results_path, exist_ok=True)
        for p, (_, f), res in zip(paths, meshes, results):
            name = os.path.splitext(os.path.basename(p))[0]
            out = os.path.join(cfg.eval.results_path, name + "_denoised.obj")
            refined = res["points"] if with_verts else res[0]
            write_obj(refined, f, out)
            print(f"{name}: {refined.shape[0]} vertices → {out}")
    else:
        infer_directory(input_dir, cfg, with_vertices=cfg.model.include_vertices,
                        device=device, seed=args.seed)
    print(f"Inference complete. Results saved to {cfg.eval.results_path}")


if __name__ == "__main__":
    main()
