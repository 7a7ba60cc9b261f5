"""The million-face regime on the port: one whole mesh, partitioned by the
halo path (``facet_graph_convolution_torch/parallel/halo.py``) and trained
with its sharded step on the card, with the time of each host stage.

    python tools/big_mesh_bench_torch.py                        # 1,048,576-face torus, f32
    python tools/big_mesh_bench_torch.py --compute_dtype bfloat16 --remat
    python tools/big_mesh_bench_torch.py --sweep 1024,1448,2048 # larger tori until memory ends

The stages are those of ``tools/big_mesh_bench.py`` (the JAX package's):
the mesh (``--shape torus --torus_nu 1024 --torus_nv 512`` gives 2·nu·nv =
1,048,576 faces), noise 0.2, ``TrainingSet(max_patch_size=10**9)``, pad,
``build_partition`` at the group's size (one rank unless launched under
torchrun), then the sharded train step at full width: ``--steps`` timed
steps after ``--warmup``, each ending in its loss on the host. One JSON
line a stage, then a summary: faces, padded nodes a level, host seconds a
stage, step ms (median, min, max), conv-edges/s (``bench.py``'s count: the
non-zero K-list entries of a level × its 3/3/2 convs), and the card's peak
allocated and reserved memory. ``--sweep nu,...`` builds a torus of each
``nu`` (``nv = nu / 2``) and tries a step in float32 and in bfloat16, out of
memory or not, and prints one summary line a size. Needs a card.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def log(stage, seconds, **kw):
    print(json.dumps({"stage": stage, "seconds": seconds, **kw}), flush=True)


def count_edges(patch) -> int:
    """Conv-edges of one step (``bench.py:38-47``): non-zero adjacency
    entries of each level × its convs (3 at level 0, 3 at level 1, 2 at
    level 2)."""
    return sum(int(np.count_nonzero(adj)) * convs for adj, convs in zip(patch.adjs, (3, 3, 2)))


def build(args, nu, nv):
    """The noisy mesh's whole-mesh patch, with its host stages logged."""
    from facet_graph_convolution_torch.data.dataset import TrainingSet
    from facet_graph_convolution_torch.data.synthetic import add_vertex_noise, icosphere, torus

    host = {}
    t0 = time.perf_counter()
    v, f = torus(nu=nu, nv=nv) if args.shape == "torus" else icosphere(args.subdiv)
    host[args.shape] = time.perf_counter() - t0
    log(args.shape, host[args.shape], faces=int(f.shape[0]))
    t0 = time.perf_counter()
    noisy = add_vertex_noise(v, f, 0.2, np.random.default_rng(0))
    host["noise"] = time.perf_counter() - t0
    log("noise", host["noise"])
    t0 = time.perf_counter()
    ds = TrainingSet(max_patch_size=10**9, coarsening_steps=2, coarsening_levels=3, k_faces=23,
                     seed=0)
    ds.add_mesh(noisy, f, gt_vertices=v)
    host["dataset_build"] = time.perf_counter() - t0
    log("dataset_build", host["dataset_build"], nodes=int(ds.patches[0].num_nodes))
    return ds.patches[0], int(f.shape[0]), host


def prepare(cfg, patch, group, host):
    """Pad, partition and upload this rank's blocks, logged."""
    import torch

    from facet_graph_convolution_torch.data.dataset import bucket_size, pad_patch_to
    from facet_graph_convolution_torch.parallel.halo import build_partition, shard_rows

    t0 = time.perf_counter()
    padded = pad_patch_to(patch, bucket_size(patch.num_nodes, 16 * group.size))
    host["pad"] = time.perf_counter() - t0
    log("pad", host["pad"], padded_nodes=int(padded.num_nodes))
    t0 = time.perf_counter()
    part = build_partition(padded.adjs, group.size)
    host["build_partition"] = time.perf_counter() - t0
    fine = part.fine
    log("build_partition", host["build_partition"], shards=group.size, fine_block=int(fine.block),
        offsets=len(fine.offsets), halo_per_offset=int(fine.halo_size))
    x = shard_rows(padded.inputs, group, torch.float32)
    gt = shard_rows(padded.gt_normals, group, torch.float32)
    return padded, part, x, gt


def run_steps(cfg, part, x, gt, group, steps, warmup, remat, host):
    """The sharded step: tables uploaded, ``warmup`` steps, then ``steps``
    timed ones; returns its numbers (OutOfMemoryError propagates)."""
    import torch

    from facet_graph_convolution_torch.models.augment import random_rotation
    from facet_graph_convolution_torch.parallel.halo import (
        make_sharded_train_step,
        sample_mask_from,
    )
    from facet_graph_convolution_torch.training.trainer import create_train_state

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = create_train_state(cfg, device=group.device)
    step = make_sharded_train_step(cfg, part, group, remat=remat)
    torch.cuda.synchronize()
    host["upload_tables"] = time.perf_counter() - t0
    n = part.fine.num_nodes
    mask = sample_mask_from(np.random.default_rng(0).integers(0, n, cfg.train.loss_samples), n,
                            group)
    rot = (random_rotation(torch.Generator().manual_seed(0))
           if cfg.train.augment_rotations else None)
    times, losses = [], []
    for _ in range(warmup + steps):
        t0 = time.perf_counter()
        state, loss = step(state, x, gt, mask, rot=rot)
        losses.append(float(loss))
        times.append(time.perf_counter() - t0)
    log("first_step", times[0], loss=losses[0])
    timed = sorted(times[warmup:])
    return {"median_step_ms": 1e3 * timed[len(timed) // 2], "min_step_ms": 1e3 * timed[0],
            "max_step_ms": 1e3 * timed[-1], "first_loss": losses[0], "last_loss": losses[-1],
            "max_memory_allocated": torch.cuda.max_memory_allocated(),
            "max_memory_reserved": torch.cuda.max_memory_reserved()}


def card_line() -> str:
    import subprocess

    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "unknown card"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shape", choices=("torus", "icosphere"), default="torus")
    ap.add_argument("--subdiv", type=int, default=8)
    ap.add_argument("--torus_nu", type=int, default=1024)
    ap.add_argument("--torus_nv", type=int, default=512)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--compute_dtype", choices=("float32", "bfloat16"), default="float32")
    ap.add_argument("--remat", action="store_true",
                    help="checkpoint each conv and the fc head (recompute in the backward)")
    ap.add_argument("--sweep", default=None,
                    help="comma-separated torus nu values (nv = nu/2): one f32 and one bf16 "
                         "try a size")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("big_mesh_bench_torch: no CUDA device", file=sys.stderr)
        return 2
    from facet_graph_convolution_torch.config import default_config
    from facet_graph_convolution_torch.parallel import distributed
    from facet_graph_convolution_torch.parallel.mesh import make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    distributed.initialize(device="cuda")
    group = make_mesh("cuda")
    card = card_line()
    print(card, flush=True)
    sizes = ([(int(nu), int(nu) // 2) for nu in args.sweep.split(",")] if args.sweep
             else [(args.torus_nu, args.torus_nv)])
    dtypes = ("float32", "bfloat16") if args.sweep else (args.compute_dtype,)
    try:
        for nu, nv in sizes:
            patch, faces, host = build(args, nu, nv)
            cfg = default_config()
            padded, part, x, gt = prepare(cfg, patch, group, host)
            summary = {"metric": "big_mesh_sharded_step", "card": card, "faces": faces,
                       "shards": group.size, "remat": args.remat,
                       "padded_nodes": [int(lvl.num_nodes) for lvl in part.levels],
                       "edges_per_step": count_edges(padded)}
            del patch, padded
            for dtype in dtypes:
                c = cfg.replace(model={"compute_dtype": dtype})
                try:
                    r = run_steps(c, part, x, gt, group, args.steps, args.warmup, args.remat,
                                  host)
                    r["edges_per_s"] = summary["edges_per_step"] / (r["median_step_ms"] / 1e3)
                    r["fits"] = True
                except torch.cuda.OutOfMemoryError as err:
                    r = {"fits": False, "error": str(err).splitlines()[0],
                         "max_memory_allocated": torch.cuda.max_memory_allocated()}
                torch.cuda.empty_cache()
                print(json.dumps({**summary, "compute_dtype": dtype, "host_seconds": host, **r}),
                      flush=True)
            del part, x, gt
            torch.cuda.empty_cache()
    finally:
        distributed.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
