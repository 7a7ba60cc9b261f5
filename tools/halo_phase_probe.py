"""Run chip_smoke.py's halo phase alone on one card after building the
kernels: K1/K2 on halo-extended sources, the 1,048,576-face torus trained
windowed (K5 at levels 0 and 1) and flat in f32 and bf16, the windowed
phase (K5 against its plain versions, its times and bounds beside the flat
path's K1 + GEMM), the torus served, the multi-GPU phases 19b-19g and the
launcher. Card only; ~10 minutes with its dataset builds.

    python3 tools/halo_phase_probe.py [--windowed]

``--windowed`` runs only the windowed phase (K5 at the torus's 6 windowed
convs in f32 and bf16 against its plain versions, its ms warm and cold,
bounds, device-memory bytes and plans, the flat path's K1 + GEMM beside it;
K5 on a 4-way shard of the 25,600-node patch, M = 33 / out = 256 among
them), ~3 minutes.
"""

import argparse

import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402


def main() -> int:
    import torch

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--windowed", action="store_true", help="the windowed phase only")
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("halo_phase_probe: no CUDA device", file=sys.stderr)
        return 2
    from facet_graph_convolution_torch.config import default_config
    from facet_graph_convolution_torch.data.dataset import TrainingSet, bucket_size, pad_patch_to
    from facet_graph_convolution_torch.data.synthetic import (
        add_vertex_noise,
        chamfered_box,
        icosphere,
        torus,
    )
    from facet_graph_convolution_torch.ops import cuda_library

    print(chip_smoke.card_line())
    t0 = time.perf_counter()
    print(f"build: {cuda_library.build()} in {time.perf_counter() - t0:.1f} s")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    # the training phase's whole subdivision-5 icosphere (noise 0.01, padded
    # to a multiple of 1024, as bench.py builds it)
    v, f = icosphere(5)
    ds = TrainingSet(max_patch_size=10**9, coarsening_steps=2, coarsening_levels=3,
                     k_faces=23, seed=0)
    ds.add_mesh((v + np.random.default_rng(0).normal(scale=0.01, size=v.shape)
                 ).astype(np.float32), f, gt_vertices=v)
    bench = pad_patch_to(ds.patches[0], bucket_size(ds.patches[0].num_nodes, 1024))
    if args.windowed:
        from facet_graph_convolution_torch.parallel import halo
        from facet_graph_convolution_torch.parallel.mesh import GraphGroup

        tv, tf = torus(nu=chip_smoke.HALO_TORUS[0], nv=chip_smoke.HALO_TORUS[1])
        tds = TrainingSet(max_patch_size=10**9, coarsening_steps=2, coarsening_levels=3,
                          k_faces=23, seed=0)
        tds.add_mesh(add_vertex_noise(tv, tf, 0.2, np.random.default_rng(0)), tf, gt_vertices=tv)
        part = halo._prepare_sharded_mesh_arrays(default_config(), tds.patches[0],
                                                 GraphGroup(0, 1, dev))[0]
        print(chip_smoke.windowed_phase(dev, part, bench))
        return 0
    train_set = TrainingSet(max_patch_size=20000, coarsening_steps=2, coarsening_levels=3,
                            k_faces=23, seed=0)
    for v, f in (icosphere(5), torus(nu=128, nv=64), chamfered_box(24)):
        train_set.add_mesh(add_vertex_noise(v, f, 0.2, rng), f, gt_vertices=v)
    with tempfile.TemporaryDirectory() as workdir:
        trained = {"cfg": default_config().replace(train={"network_path": workdir}),
                   "train_set": train_set, "bench_patch": bench}
        out = chip_smoke.halo_phase(dev, workdir, trained)
    print(out["launches"])
    print(out["windowed"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
