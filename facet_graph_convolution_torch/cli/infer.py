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
"""

import argparse

from facet_graph_convolution_torch.config import (
    add_cli_overrides,
    config_from_args,
    parse_device,
)
from facet_graph_convolution_torch.inference.driver import infer_directory


def main(argv=None):
    args = add_cli_overrides(argparse.ArgumentParser()).parse_args(argv)
    cfg = config_from_args(args)
    infer_directory(args.input_dir or cfg.data.test_data_path, cfg,
                    with_vertices=cfg.model.include_vertices, device=parse_device(args.device))
    print(f"Inference complete. Results saved to {cfg.eval.results_path}")


if __name__ == "__main__":
    main()
