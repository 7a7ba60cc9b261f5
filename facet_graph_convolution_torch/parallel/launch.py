"""One command a process runs sharded training, its benchmark, data-parallel
training or sharded vertex training (the port's counterpart of
``facet_graph_convolution_tpu/parallel/launch.py``, with ``dp`` and
``vertex`` added).

    python -m facet_graph_convolution_torch.parallel.launch train --iterations 40

runs one process on one card. Several processes (one a card, or CPU ranks
over gloo with ``--device cpu``) take JAX's flags:

    python -m facet_graph_convolution_torch.parallel.launch \\
        --coordinator 127.0.0.1:9981 --num_processes 2 --process_id 0 \\
        --device cpu train --iterations 40

or, without them, ``torchrun``'s environment (``torchrun --nproc_per_node 4
-m facet_graph_convolution_torch.parallel.launch bench``). Every process
runs the same arguments; the host-side draws are seeded, so the processes
stay in lockstep. ``train`` (``train_normals_sharded``), ``dp``
(``train_normals_dp`` on patches of a synthetic mesh, a patch a rank a
step) and ``vertex`` (``train_with_vertices_sharded``, ``--vertex_solver
operator|naive``) print one JSON line of the first and last loss, ``bench``
one of the step time and edges/s.
"""

from __future__ import annotations

import argparse
import json
import time


def _build_set(subdiv: int, seed: int, max_patch_size: int = 10**9,
               with_vertices: bool = False):
    """A seeded synthetic training set of one noisy icosphere and its GT,
    cut into patches of at most ``max_patch_size`` faces."""
    import numpy as np

    from facet_graph_convolution_torch.config import default_config
    from facet_graph_convolution_torch.data.dataset import TrainingSet
    from facet_graph_convolution_torch.data.synthetic import add_vertex_noise, icosphere

    cfg = default_config()
    v, f = icosphere(subdiv)
    noisy = add_vertex_noise(v, f, 0.15, np.random.default_rng(seed))
    ds = TrainingSet(
        max_patch_size=max_patch_size, coarsening_steps=cfg.model.coarsening_steps,
        coarsening_levels=cfg.model.coarsening_levels, k_faces=cfg.data.k_faces, seed=seed)
    (ds.add_mesh_with_vertices if with_vertices else ds.add_mesh)(noisy, f, gt_vertices=v)
    return cfg, ds


def _build_patch(subdiv: int, seed: int, with_vertices: bool = False):
    """A seeded synthetic whole-mesh patch (noisy icosphere + GT)."""
    cfg, ds = _build_set(subdiv, seed, with_vertices=with_vertices)
    return cfg, ds.patches[0]


def count_partition_edges(part) -> int:
    """Non-zero conv slots across the pyramid × convs a level (3/3/2, as
    ``bench.py`` counts them): multiplicities, self slots included."""
    convs_per_level = (3, 3, 2)
    return sum(int(lvl.mult.sum() + lvl.self_mult.sum()) * n_convs
               for lvl, n_convs in zip(part.levels, convs_per_level))


def run(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--coordinator", default=None, help="host:port of rank 0")
    parser.add_argument("--num_processes", type=int, default=None)
    parser.add_argument("--process_id", type=int, default=None)
    parser.add_argument("--device", default="cuda", help="cuda (one card a process) or cpu")
    sub = parser.add_subparsers(dest="cmd", required=True)
    p_train = sub.add_parser("train", help="sharded training on a synthetic mesh")
    p_train.add_argument("--iterations", type=int, default=40)
    p_train.add_argument("--subdiv", type=int, default=3)
    p_train.add_argument("--seed", type=int, default=0)
    p_train.add_argument("--checkpoint_dir", default=None)
    p_dp = sub.add_parser("dp", help="data-parallel training on a synthetic mesh's patches")
    p_dp.add_argument("--iterations", type=int, default=40)
    p_dp.add_argument("--subdiv", type=int, default=4)
    p_dp.add_argument("--max_patch_size", type=int, default=1000)
    p_dp.add_argument("--steps_per_call", type=int, default=1)
    p_dp.add_argument("--compute_dtype", default="float32")
    p_vertex = sub.add_parser("vertex", help="sharded vertex training on a synthetic mesh")
    p_vertex.add_argument("--iterations", type=int, default=10)
    p_vertex.add_argument("--subdiv", type=int, default=3)
    p_vertex.add_argument("--seed", type=int, default=0)
    p_vertex.add_argument("--vertex_solver", default="operator")
    p_bench = sub.add_parser("bench", help="sharded train-step throughput")
    p_bench.add_argument("--steps", type=int, default=10)
    p_bench.add_argument("--repeats", type=int, default=3)
    p_bench.add_argument("--subdiv", type=int, default=5)
    args = parser.parse_args(argv)

    import numpy as np
    import torch

    from facet_graph_convolution_torch.parallel import distributed
    from facet_graph_convolution_torch.parallel.data_parallel import train_normals_dp
    from facet_graph_convolution_torch.parallel.halo import (
        _prepare_sharded_mesh_arrays,
        make_sharded_train_step,
        sample_mask_from,
        train_normals_sharded,
    )
    from facet_graph_convolution_torch.parallel.mesh import make_mesh
    from facet_graph_convolution_torch.parallel.vertex_train import train_with_vertices_sharded
    from facet_graph_convolution_torch.training.trainer import create_train_state

    rank, size = distributed.initialize(args.coordinator, args.num_processes, args.process_id,
                                        device=args.device)
    try:
        group = make_mesh(args.device)
        print(f"[launch] rank {rank}/{size} on {group.device} ({group.backend or 'no group'})",
              flush=True)
        if args.cmd in ("train", "dp", "vertex"):
            if args.cmd == "train":
                cfg, patch = _build_patch(args.subdiv, args.seed)
                cfg = cfg.replace(train={"loss_samples": min(2000, patch.num_nodes)})
                if args.checkpoint_dir:
                    cfg = cfg.replace(train={"network_path": args.checkpoint_dir})
                _, losses = train_normals_sharded(cfg, patch, args.iterations, group=group,
                                                  seed=args.seed, log_every=10,
                                                  checkpoint=bool(args.checkpoint_dir))
            elif args.cmd == "dp":
                cfg, ds = _build_set(args.subdiv, 0, args.max_patch_size)
                cfg = cfg.replace(model={"compute_dtype": args.compute_dtype},
                                  train={"loss_samples": 2000})
                _, losses = train_normals_dp(cfg, ds, group=group, num_iterations=args.iterations,
                                             log_every=10, steps_per_call=args.steps_per_call)
            else:
                cfg, patch = _build_patch(args.subdiv, args.seed, with_vertices=True)
                cfg = cfg.replace(eval={"vertex_solver": args.vertex_solver})
                _, losses = train_with_vertices_sharded(cfg, patch, args.iterations, group=group,
                                                        seed=args.seed)
            metric = {"train": "sharded_final_loss", "dp": "dp_final_loss",
                      "vertex": "sharded_vertex_final_loss"}[args.cmd]
            print(json.dumps({"metric": metric, "first_loss": float(losses[0]),
                              "value": float(losses[-1]), "process": rank}), flush=True)
            return 0

        cfg, patch = _build_patch(args.subdiv, 0)
        cfg = cfg.replace(model={"compute_dtype": "bfloat16"},
                          train={"loss_samples": min(4000, patch.num_nodes)})
        part, x, gt, n = _prepare_sharded_mesh_arrays(cfg, patch, group)
        edges = count_partition_edges(part)
        state = create_train_state(cfg, device=group.device)
        step = make_sharded_train_step(cfg, part, group)
        mask = sample_mask_from(
            np.random.default_rng(0).integers(0, n, size=cfg.train.loss_samples), n, group)
        rot = torch.eye(3)
        state, loss = step(state, x, gt, mask, rot=rot)      # build and warm up
        float(loss)
        times = []
        for _ in range(args.repeats):
            t0 = time.perf_counter()
            for _ in range(args.steps):
                state, loss = step(state, x, gt, mask, rot=rot)
            float(loss)
            times.append((time.perf_counter() - t0) / args.steps)
        median = sorted(times)[len(times) // 2]
        print(json.dumps({"metric": "sharded_train_step_edges_per_s", "value": edges / median,
                          "unit": "edges/s", "step_s": median, "edges_per_step": edges,
                          "processes": size, "process": rank, "device": str(group.device),
                          "final_loss": float(loss)}), flush=True)
        return 0
    finally:
        distributed.shutdown()


if __name__ == "__main__":
    raise SystemExit(run())
