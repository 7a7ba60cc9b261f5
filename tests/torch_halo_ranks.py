"""Rank processes for the port's halo tests (tests/test_torch_halo.py,
tests/test_torch_sharded_infer.py). It imports no JAX: each rank is

    python -m tests.torch_halo_ranks <job> <rank> <world> <workdir>

reading ``<workdir>/payload.pkl``, joining a gloo group through a file in
``<workdir>`` (no port, so parallel test workers never collide), running
the job, and writing its result to ``<workdir>/out_<rank>.pt``. Every
collective fails after :data:`TIMEOUT` instead of hanging.
"""

import datetime
import os
import pickle
import subprocess
import sys

import numpy as np
import torch
import torch.distributed as dist

from facet_graph_convolution_torch.params import params_from_jax, params_to_numpy
from facet_graph_convolution_torch.parallel import halo
from facet_graph_convolution_torch.parallel.mesh import make_mesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = datetime.timedelta(seconds=90)


def run_ranks(job: str, world: int, payload: dict, workdir: str, timeout: float = 240):
    """Run ``job`` on ``world`` gloo ranks; returns their results, rank
    order. Raises with a rank's stderr when one fails or time runs out."""
    os.makedirs(workdir, exist_ok=True)
    with open(os.path.join(workdir, "payload.pkl"), "wb") as fh:
        pickle.dump(payload, fh)
    env = dict(os.environ, OMP_NUM_THREADS="2", PYTHONPATH=REPO)
    procs = [subprocess.Popen([sys.executable, "-m", "tests.torch_halo_ranks", job, str(r),
                               str(world), workdir], cwd=REPO, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(world)]
    errors = []
    for r, p in enumerate(procs):
        try:
            out, err = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise AssertionError(f"{job}: rank {r} ran past {timeout} s")
        if p.returncode != 0:
            errors.append(f"rank {r} exit {p.returncode}:\n{err[-3000:]}")
    if errors:
        raise AssertionError(f"{job} failed:\n" + "\n".join(errors))
    return [torch.load(os.path.join(workdir, f"out_{r}.pt"), weights_only=False)
            for r in range(world)]


def _numpy(t):
    return t.detach().cpu().numpy()


def job_exchange(p, group):
    """Each level's halo extension of ``p["xs"]`` and its backward under the
    integer cotangents ``p["gs"][rank]`` (exact in float32)."""
    part = halo.build_partition(p["adjs"], group.size, **p.get("partition", {}))
    tables = halo.partition_operands(part, group.rank, "cpu")
    out = []
    for lvl, t in enumerate(tables):
        x = halo.shard_rows(p["xs"][lvl], group).requires_grad_()
        ext = halo.halo_extend(x, t.exchange, group)
        g = torch.as_tensor(p["gs"][group.rank][lvl][:ext.shape[0]])
        ext.backward(g)
        out.append((_numpy(ext), _numpy(x.grad)))
    return out


def job_forward(p, group):
    """``sharded_unet_apply`` of each variant's parameters."""
    part = halo.build_partition(p["adjs"], group.size, **p.get("partition", {}))
    return {name: _numpy(halo.sharded_unet_apply(
                params_from_jax(params, "cpu"), p["x"], part, group, variant=name))
            for name, params in p["params"].items()}


def _train(p, group, cfg, remat=False):
    part = halo.build_partition(p["adjs"], group.size, **p.get("partition", {}))
    from facet_graph_convolution_torch.training.trainer import create_train_state

    state = create_train_state(cfg, device="cpu", params=params_from_jax(p["params"], "cpu"))
    step = halo.make_sharded_train_step(cfg, part, group, remat=remat)
    x = halo.shard_rows(p["x"], group)
    gt = halo.shard_rows(p["gt"], group)
    losses, grads = [], []
    for rot, mask in zip(p["rots"], p["masks"]):
        state, loss = step(state, x, gt, halo.shard_rows(mask, group),
                           rot=None if rot is None else torch.tensor(rot))
        losses.append(float(loss))
        grads.append({layer: {k: _numpy(t.grad) for k, t in leaves.items()}
                      for layer, leaves in state.params.items()})
    return {"losses": losses, "params": params_to_numpy(state.params), "grads": grads,
            "eval": float(step.eval(state.params, x, gt, halo.shard_rows(p["masks"][0], group)))}


def job_train(p, group):
    """Sharded train steps from ``p["params"]`` on the injected draws, for
    each config of ``p["cfgs"]`` (``remat`` when its name says so)."""
    return {name: _train(p, group, cfg, remat=name.endswith("remat"))
            for name, cfg in p["cfgs"].items()}


def job_driver(p, group):
    """``train_normals_sharded(device="cpu")`` runs in order, each a list of
    keyword overrides."""
    from facet_graph_convolution_torch.parallel.halo import train_normals_sharded

    import dataclasses

    out = []
    for run in p["runs"]:
        cfg = p["cfg"].replace(**run.pop("cfg", {}))
        patch = p["patch"]
        if run.pop("nan_inputs", False):
            patch = dataclasses.replace(patch, inputs=patch.inputs * np.float32("nan"))
        if run.pop("validate", False):
            run["valid_patches"] = [p["patch"]]
        state, losses = train_normals_sharded(cfg, patch, group=group, device="cpu", **run)
        out.append({"losses": losses, "step": state.step,
                    "params": params_to_numpy(state.params)})
    return out


def job_solver(p, group):
    from facet_graph_convolution_torch.parallel.vertex_halo import (
        sharded_update_positions_edges,
    )

    return [sharded_update_positions_edges(*p["args"], group=group, **kw)
            for kw in p["kwargs"]]


def job_infer(p, group):
    from facet_graph_convolution_torch.inference.sharded import infer_normals_sharded

    return infer_normals_sharded(p["mesh"], p["cfg"], params_from_jax(p["params"], "cpu"),
                                 group=group, solver_iterations=p["iterations"])


JOBS = {name[4:]: fn for name, fn in globals().items() if name.startswith("job_")}


def main(job, rank, world, workdir):
    torch.set_num_threads(2)
    with open(os.path.join(workdir, "payload.pkl"), "rb") as fh:
        payload = pickle.load(fh)
    dist.init_process_group("gloo", init_method=f"file://{workdir}/pg", rank=rank,
                            world_size=world, timeout=TIMEOUT)
    try:
        out = JOBS[job](payload, make_mesh("cpu"))
    finally:
        dist.destroy_process_group()
    torch.save(out, os.path.join(workdir, f"out_{rank}.pt"))


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
