"""Preprocessing CLI of the port (reference ``preprocess.py:51-58``):

    python -m facet_graph_convolution_torch.cli.preprocess --base_path <dir>

Reads ``<base_path>/Data/Synthetic/train/{noisy,original,valid}/`` and writes
``<base_path>/Preprocessed_Data/{trainingSet,validSet}.npz``; with
``--include_vertices``, ``{trainingSet,validSet}WithVertices.npz``, whose
patches carry the vertex pipeline's fields (for ``cli.train
--include_vertices``). ``--shard_size N`` also writes the training set as
streaming shards of N patches into ``trainingShards/`` (or
``trainingShardsWithVertices/``), which ``cli.train --stream_dir`` reads.
Host work only (NumPy, one process per mesh); the
device is not used.
"""

import argparse

from facet_graph_convolution_torch.config import add_cli_overrides, config_from_args
from facet_graph_convolution_torch.data.preprocess import preprocess_directory


def main(argv=None):
    parser = add_cli_overrides(argparse.ArgumentParser())
    parser.add_argument(
        "--shard_size", type=int, default=None,
        help="also write the training set as streaming shards of this many patches "
             "into trainingShards/ (for cli.train --stream_dir)")
    args = parser.parse_args(argv)
    cfg = config_from_args(args)
    preprocess_directory(cfg, shard_size=args.shard_size)
    print(f"Preprocessing complete. Dumps saved to {cfg.data.binary_dump_path}")


if __name__ == "__main__":
    main()
