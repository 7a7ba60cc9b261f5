"""Training CLI of the port (reference ``train.py:1942-1978`` →
``mainFunction``):

    python -m facet_graph_convolution_torch.cli.train --device cuda \
        --base_path <dir> --num_iterations 300000 --net_name net

Trains the normals network on ``<base_path>/Preprocessed_Data/
trainingSet.npz`` (and ``validSet.npz`` when present; ``cli.preprocess``
writes both) and checkpoints into ``<network_path>/<net_name>/``, whose
``params.pt`` ``cli.infer`` serves. With ``--include_vertices`` it trains
the multi-scale network through the vertex solver on
``trainingSetWithVertices.npz`` (and ``validSetWithVertices.npz``;
``cli.preprocess --include_vertices`` writes both), whose ``params.pt``
``cli.infer --include_vertices`` serves. ``--stream_dir <dir>`` trains the
normals network from the streaming shards in ``<dir>`` (``cli.preprocess
--shard_size`` writes ``trainingShards/``), loading them as it goes, with
``validSet{suffix}.npz`` as above (``training.trainer.
train_normals_streaming``; as in the JAX package it trains the normals
network under ``--include_vertices`` too). ``--device`` defaults to ``cuda``;
without a card, pass ``--device cpu``. ``--steps_per_call`` defaults as the
JAX package's does (``cli/train.py:36-37``): 100 on the card, where each
call replays a captured CUDA graph of the step 100 times, and 1 on the CPU.
"""

import argparse
import os

import torch

from facet_graph_convolution_torch.config import (
    add_cli_overrides,
    config_from_args,
    parse_device,
)
from facet_graph_convolution_torch.data.dataset import load_dataset
from facet_graph_convolution_torch.training.trainer import (
    train_normals,
    train_normals_streaming,
    train_with_vertices,
)


def main(argv=None):
    parser = add_cli_overrides(argparse.ArgumentParser())
    parser.add_argument(
        "--steps_per_call", type=int, default=None,
        help="train steps per call: a CUDA graph replayed a step on the card "
             "(default 100 there, 1 on the CPU)")
    parser.add_argument(
        "--stream_dir", type=str, default=None,
        help="train the normals network from streaming shards (cli.preprocess "
             "--shard_size writes them) instead of loading the whole set")
    args = parser.parse_args(argv)
    cfg = config_from_args(args)
    suffix = "WithVertices" if cfg.model.include_vertices else ""
    valid_path = os.path.join(cfg.data.binary_dump_path, f"validSet{suffix}.npz")
    valid_set = load_dataset(valid_path) if os.path.isfile(valid_path) else None
    device = parse_device(args.device)
    steps_per_call = args.steps_per_call
    if steps_per_call is None:
        steps_per_call = 100 if torch.device(device).type == "cuda" else 1
    if args.stream_dir:
        train_normals_streaming(cfg, args.stream_dir, valid_set=valid_set,
                                steps_per_call=steps_per_call, device=device)
        return
    train_set = load_dataset(os.path.join(cfg.data.binary_dump_path, f"trainingSet{suffix}.npz"))
    train = train_with_vertices if cfg.model.include_vertices else train_normals
    train(cfg, train_set, valid_set, steps_per_call=steps_per_call, device=device)


if __name__ == "__main__":
    main()
