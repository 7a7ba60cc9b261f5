"""The normals training loop over patches: the program's
``train_normals(steps_per_call=N)`` chunk loop.

Set-up: the traffic's noisy meshes cut into patches by the program's
``TrainingSet`` (``max_patch_size``), each padded to its bucket and all to
the largest (or to the traffic's ``pad_nodes``, where that is larger), stacked on the card (``stack_patch_tensors``), the Adam state
over the benchmark's weights (``create_train_state``) and the multi-step
call (``make_scanned_train_step``: on the card one step captured as a CUDA
graph, replayed a step). A call trains ``steps_per_call`` steps, each on the
patch the benchmark drew, with its rotation and sampled faces; its losses
are read on the host one call late, as the program's loop reads them.

The first steps (:meth:`Session.first_steps`) go through that same call: a
call of one step, then one of two, on three different patches. They are
what the reference follows.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from fgc_bench.core.draws import PatchOrder, rotation
from fgc_bench.core.weights import make_weights
from fgc_bench.drivers.common import (
    PendingCall,
    ReferencePatch,
    first_steps,
    port_config,
    prepare_reference_patch,
    tree_faces,
)
from fgc_bench.reference import network as ref_net
from fgc_bench.reference.train import Trajectory
from fgc_bench.traffic.meshes import make_meshes, seed_sequence

FIRST_STEPS = (1, 2)        # the calls of the first steps: one step, then two


class Session:
    heads = 1

    def __init__(self, cell, seed: int, device: str):
        from facet_graph_convolution_torch.data.dataset import TrainingSet, bucket_size, pad_patch_to
        from facet_graph_convolution_torch.training.trainer import (
            create_train_state,
            make_scanned_train_step,
            stack_patch_tensors,
        )

        self.cell, self.config, self.mix = cell, cell.config, cell.traffic
        self.device = device
        self.cfg = port_config(self.config, seed)
        self.meshes = make_meshes(self.mix, seed)
        ds = TrainingSet(max_patch_size=int(self.mix["max_patch_size"]),
                         coarsening_steps=self.config["coarsening_steps"],
                         coarsening_levels=self.config["coarsening_levels"],
                         k_faces=self.config["k_faces"],
                         seed=int(seed_sequence(seed, "dataset").integers(2**63)))
        owners = []
        for i, mesh in enumerate(self.meshes):
            before = len(ds.patches)
            ds.add_mesh(mesh.noisy, mesh.faces, gt_vertices=mesh.clean)
            owners += [i] * (len(ds.patches) - before)
        align = int(self.mix["bucket_align"])
        padded = [pad_patch_to(p, bucket_size(p.num_nodes, align)) for p in ds.patches]
        # one bucket for every seed where the traffic names it: the tree's
        # padding follows the noisy geometry, and so would the bucket
        self.num_nodes = max([int(self.mix.get("pad_nodes", 0))] + [p.num_nodes for p in padded])
        self.patches = [pad_patch_to(p, self.num_nodes) for p in padded]
        self.real_faces = [p.num_real for p in ds.patches]
        self.tree = [tree_faces(p, self.num_nodes) for p in ds.patches]
        self.owners = owners
        self.params0 = make_weights(self.config, self.heads, seed, device)
        self.host_params0 = {k: {n: t.cpu() for n, t in d.items()}
                             for k, d in self.params0.items()}
        self.state = create_train_state(self.cfg, device=device, params=self.params0)
        self.steps_per_call = int(self.mix["steps_per_call"])
        self.scanned = make_scanned_train_step(
            self.state, self.cfg, stack_patch_tensors(self.patches, device), self.steps_per_call)
        self.order = PatchOrder(seed, len(self.patches))
        self.draw_rng = seed_sequence(seed, "draws")
        self.steps_done: List[int] = []          # the patch of every step run
        self.first_draws: List[Dict] = []
        self._levels: Dict[int, list] = {}

    # -- the program's calls ------------------------------------------------

    def _draws(self, count: int) -> Dict[str, torch.Tensor]:
        idx = self.order.take(count)
        rots = np.stack([rotation(self.draw_rng) for _ in idx])
        samples = self.draw_rng.integers(0, self.num_nodes, (count, self.cfg.train.loss_samples))
        return {"idx": torch.as_tensor(np.asarray(idx), dtype=torch.int64).reshape(-1, 1),
                "sample_idx": torch.as_tensor(samples, dtype=torch.int64),
                "rot": torch.as_tensor(rots)}

    def call(self, count: int = 0) -> PendingCall:
        """Enqueue one call of ``count`` steps (default ``steps_per_call``)."""
        count = count or self.steps_per_call
        draws = self._draws(count)
        idx = [int(i) for i in draws["idx"][:, 0]]
        self.steps_done += idx
        _, losses = self.scanned(self.state, draws)
        return PendingCall(losses.numpy, count, sum(self.real_faces[i] for i in idx), draws)

    def first_steps(self) -> Trajectory:
        """The first three steps, through the window's call: one step, then
        two on another patch."""
        return first_steps(self, FIRST_STEPS)

    def warm(self) -> None:
        """Nothing more: the first call captured the step's graph, which
        every later call replays."""

    def release(self) -> None:
        """Drop the program's state, once the device is done with it."""
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.scanned = self.state = self.params0 = None

    # -- the reference ------------------------------------------------------

    def reference_patch(self, i: int) -> ReferencePatch:
        mesh = self.meshes[self.owners[i]]
        return prepare_reference_patch(mesh, self.tree[i], self.config)

    def reference_losses(self, device: str, fault: str = ""):
        """The loss closures of the first steps, for the plain reference;
        ``fault="half_batch"`` takes each step's loss over half its sampled
        faces (a planted fault, for ``fgc_bench/control.py``)."""
        closures, cache = [], {}
        for draws in self.first_draws:
            for j in range(len(draws["idx"])):
                i = int(draws["idx"][j, 0])
                if i not in cache:
                    cache[i] = self.reference_patch(i).to(device)
                idx = draws["sample_idx"][j]
                if fault == "half_batch":
                    idx = idx[:len(idx) // 2]
                closures.append(_normals_loss(cache[i], draws["rot"][j].to(device),
                                              idx.to(device)))
        return closures

    # -- what the per-layer metrics read ------------------------------------

    def kernel_convs(self, kernel: str) -> List[str]:
        """The convs whose work ``kernel`` does a step: K1 and K2 all
        eight."""
        return [name for name, _ in ref_net.CONVS] if kernel in ("k1", "k2") else []

    def step_levels(self, steps: List[int]):
        """The reference's level graphs of the patch of each of ``steps``
        (indices into the run's steps)."""
        out = []
        for s in steps:
            i = self.steps_done[s]
            if i not in self._levels:
                self._levels[i] = self.reference_patch(i).levels
            out.append(self._levels[i])
        return out


def _normals_loss(patch: ReferencePatch, rot: torch.Tensor, sample_idx: torch.Tensor):
    def loss(params):
        x = (patch.x.reshape(-1, 2, 3) @ rot.T).reshape(-1, 6)
        gt = patch.gt @ rot.T
        y = ref_net.normalize(ref_net.unet(params, x, patch.nbrs, fan=patch.fan)[0])
        return ref_net.angular_loss(y[sample_idx], gt[sample_idx])
    return loss
