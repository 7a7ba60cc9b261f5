"""Whole-mesh training: the program's ``train_normals_sharded`` step on one
rank, over a mesh that is not cut into patches.

Set-up: the traffic's one noisy mesh as a single patch of the program's
``TrainingSet`` (``max_patch_size`` past its face count), padded to the
tree's alignment, partitioned by ``build_partition`` over the one rank,
and the sharded step (``make_sharded_train_step``: eager, the windowed
conv K5 on the levels the program's ``build_level_windows`` picks, K1/K2
on the others). A call is one step with its rotation and its sampled loss
faces, and ends in its loss on the host, as the program's loop runs it.
The first steps are the first three calls.
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from fgc_bench.core.draws import rotation
from fgc_bench.core.weights import make_weights
from fgc_bench.drivers.common import (
    PendingCall,
    first_steps,
    port_config,
    prepare_reference_patch,
    tree_faces,
)
from fgc_bench.reference import network as ref_net
from fgc_bench.reference.train import Trajectory
from fgc_bench.traffic.meshes import make_meshes, seed_sequence

FIRST_CALLS = 3


class Session:
    heads = 1

    def __init__(self, cell, seed: int, device: str):
        from facet_graph_convolution_torch.data.dataset import TrainingSet, bucket_size, pad_patch_to
        from facet_graph_convolution_torch.parallel.halo import (
            build_partition,
            make_sharded_train_step,
            shard_rows,
        )
        from facet_graph_convolution_torch.parallel.mesh import make_mesh
        from facet_graph_convolution_torch.training.trainer import create_train_state

        self.cell, self.config, self.mix = cell, cell.config, cell.traffic
        self.device = device
        self.cfg = port_config(self.config, seed)
        (self.mesh,) = make_meshes(self.mix, seed)
        ds = TrainingSet(max_patch_size=int(self.mix["max_patch_size"]),
                         coarsening_steps=self.config["coarsening_steps"],
                         coarsening_levels=self.config["coarsening_levels"],
                         k_faces=self.config["k_faces"],
                         seed=int(seed_sequence(seed, "dataset").integers(2**63)))
        ds.add_mesh(self.mesh.noisy, self.mesh.faces, gt_vertices=self.mesh.clean)
        (patch,) = ds.patches
        self.group = make_mesh(device)
        align = (2 ** self.config["coarsening_steps"]) ** (self.config["coarsening_levels"] - 1)
        padded = pad_patch_to(patch, bucket_size(patch.num_nodes, align * self.group.size))
        self.num_nodes = padded.num_nodes
        self.real_faces = patch.num_real
        self.tree = tree_faces(patch, self.num_nodes)
        part = build_partition(padded.adjs, self.group.size)
        self.x = shard_rows(padded.inputs, self.group, torch.float32)
        self.gt = shard_rows(padded.gt_normals, self.group, torch.float32)
        self.params0 = make_weights(self.config, self.heads, seed, device)
        self.host_params0 = {k: {n: t.cpu() for n, t in d.items()}
                             for k, d in self.params0.items()}
        self.state = create_train_state(self.cfg, device=device, params=self.params0)
        self.step = make_sharded_train_step(self.cfg, part, self.group)
        self.windowed_levels = [lvl for lvl, t in enumerate(self.step.tables)
                                if t.windows is not None]
        self.draw_rng = seed_sequence(seed, "draws")
        self.steps_done: List[int] = []
        self.first_draws: List[Dict] = []
        self._levels = None

    def call(self, count: int = 1) -> PendingCall:
        """One step, with its rotation and sampled loss faces: a call of
        the whole-mesh loop is one step."""
        if count != 1:
            raise ValueError(f"a whole-mesh call is one step, not {count}")
        from facet_graph_convolution_torch.parallel.halo import sample_mask_from

        rot = rotation(self.draw_rng)
        idx = self.draw_rng.integers(0, self.num_nodes, self.cfg.train.loss_samples)
        mask = sample_mask_from(idx, self.num_nodes, self.group)
        self.state, loss = self.step(self.state, self.x, self.gt, mask,
                                     rot=torch.as_tensor(rot))
        value = np.array([float(loss)])
        done = time.perf_counter()
        self.steps_done.append(0)
        return PendingCall(lambda: value, 1, self.real_faces, {"rot": rot, "idx": idx}, done)

    def first_steps(self) -> Trajectory:
        """The first three calls, one step each."""
        return first_steps(self, (1,) * FIRST_CALLS)

    def warm(self) -> None:
        """Nothing more: the first calls ran the step's every kernel."""

    def release(self) -> None:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.step = self.state = self.params0 = self.x = self.gt = None

    # -- the reference ------------------------------------------------------

    def reference_patch(self):
        return prepare_reference_patch(self.mesh, self.tree, self.config)

    def reference_losses(self, device: str, fault: str = ""):
        """The loss closures of the first steps; ``fault="half_batch"``
        masks half of each step's sampled faces."""
        patch = self.reference_patch().to(device)
        closures = []
        for draws in self.first_draws:
            idx = draws["idx"][:len(draws["idx"]) // 2] if fault == "half_batch" else draws["idx"]
            mask = np.zeros(self.num_nodes, np.float32)
            mask[idx] = 1.0
            closures.append(_masked_loss(patch, torch.as_tensor(draws["rot"]).to(device),
                                         torch.as_tensor(mask).to(device)))
        return closures

    # -- what the per-layer metrics read ------------------------------------

    def kernel_convs(self, kernel: str) -> List[str]:
        on_k5 = [name for name, lvl in ref_net.CONVS if lvl in self.windowed_levels]
        if kernel == "k5":
            return on_k5
        if kernel in ("k1", "k2"):
            return [name for name, _ in ref_net.CONVS if name not in on_k5]
        return []

    def step_levels(self, steps: List[int]):
        if self._levels is None:
            self._levels = self.reference_patch().levels
        return [self._levels for _ in steps]


def _masked_loss(patch, rot, mask):
    def loss(params):
        x = (patch.x.reshape(-1, 2, 3) @ rot.T).reshape(-1, 6)
        gt = patch.gt @ rot.T
        y = ref_net.normalize(ref_net.unet(params, x, patch.nbrs, fan=patch.fan)[0])
        cos = torch.clamp((y * gt).sum(dim=-1), -0.9999999, 0.9999999)
        ang = torch.acos(cos) * (180.0 / np.pi)
        w = mask * (gt.abs().sum(dim=-1) > 1e-3).to(y.dtype)
        return (ang * w).sum() / w.sum()
    return loss
