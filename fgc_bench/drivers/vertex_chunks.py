"""The vertex training loop over patches: the program's
``train_with_vertices(steps_per_call=N)`` chunk loop.

Set-up: the traffic's noisy meshes cut into vertex patches by the
program's ``TrainingSet.add_mesh_with_vertices`` (each with its vertices,
its ground-truth points and its solver tables), the Adam state over the
benchmark's weights with the three heads, the vertex step
(``make_vertex_train_step``: the three-head U-Net, the operator
multi-scale solver, the chamfer loss) and a ``GraphCache`` of one captured
step a patch (``step.scanned``). A call pins one patch, drawn by the
benchmark, and trains ``steps_per_call`` steps on it, each with its own
rotation and sampled points; its losses are read one call late.

The first steps are a call of one step on one patch, then a call of two on
another; every other patch's graph is then captured by a call of one step
(set-up), so that the window captures nothing.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

import numpy as np
import torch

from fgc_bench.core.draws import PatchOrder, rotation
from fgc_bench.core.weights import make_weights
from fgc_bench.drivers.common import (
    PendingCall,
    first_steps,
    port_config,
    prepare_reference_patch,
    tree_faces,
)
from fgc_bench.reference import network as ref_net
from fgc_bench.reference import solver as ref_solver
from fgc_bench.reference.train import Trajectory
from fgc_bench.traffic.meshes import make_meshes, seed_sequence

FIRST_STEPS = (1, 2)
SOLVER_REPS = 5


@dataclass
class RefVertexPatch:
    base: object                  # drivers.common.ReferencePatch (x, nbrs, levels)
    vertices: torch.Tensor        # [V, 3] the program's vertex order, scaled
    gt_points: torch.Tensor       # [V_gt, 3]
    tri: torch.Tensor             # [N, 3] tree-ordered faces over the patch's vertices
    v_faces: torch.Tensor         # [V, K] tree positions of each vertex's faces

    def to(self, device):
        return RefVertexPatch(self.base.to(device), self.vertices.to(device),
                              self.gt_points.to(device), self.tri.to(device),
                              self.v_faces.to(device))


def _bbox_diag32(*sets) -> float:
    lo = np.min([np.asarray(s, np.float32).min(axis=0) for s in sets], axis=0)
    hi = np.max([np.asarray(s, np.float32).max(axis=0) for s in sets], axis=0)
    return float(np.sqrt(np.sum((hi - lo) ** 2)))


class Session:
    heads = 3

    def __init__(self, cell, seed: int, device: str):
        from facet_graph_convolution_torch.data.dataset import TrainingSet
        from facet_graph_convolution_torch.training.graph_step import (
            GraphCache,
            default_graph_budget,
        )
        from facet_graph_convolution_torch.training.trainer import (
            create_train_state,
            make_vertex_train_step,
            vertex_patch_tensors,
        )

        self.cell, self.config, self.mix = cell, cell.config, cell.traffic
        self.device = device
        self.cfg = port_config(self.config, seed)
        self.meshes = make_meshes(self.mix, seed)
        ds = TrainingSet(max_patch_size=int(self.mix["max_patch_size"]),
                         coarsening_steps=self.config["coarsening_steps"],
                         coarsening_levels=self.config["coarsening_levels"],
                         k_faces=self.config["k_faces"], k_vertices=self.config["k_vertices"],
                         seed=int(seed_sequence(seed, "dataset").integers(2**63)))
        self.owners = []
        for i, mesh in enumerate(self.meshes):
            before = len(ds.patches)
            ds.add_mesh_with_vertices(mesh.noisy, mesh.faces, gt_vertices=mesh.clean)
            self.owners += [i] * (len(ds.patches) - before)
        self.patches = ds.patches
        self.real_faces = [p.num_real for p in self.patches]
        self.params0 = make_weights(self.config, self.heads, seed, device)
        self.host_params0 = {k: {n: t.cpu() for n, t in d.items()}
                             for k, d in self.params0.items()}
        self.state = create_train_state(self.cfg, device=device, params=self.params0,
                                        multi_scale=True)
        self.step = make_vertex_train_step(self.cfg)
        self.tensors = [vertex_patch_tensors(self.cfg, p, device) for p in self.patches]
        self.graphs = GraphCache(default_graph_budget(torch.device(device)))
        self.steps_per_call = int(self.mix["steps_per_call"])
        self.order = PatchOrder(seed, len(self.patches))
        self.draw_rng = seed_sequence(seed, "draws")
        self.steps_done: List[int] = []
        self.first_draws: List[Dict] = []
        self._levels: Dict[int, list] = {}

    # -- the program's calls ------------------------------------------------

    def _draws(self, patch: int, count: int) -> Dict[str, torch.Tensor]:
        t = self.tensors[patch]
        s = self.cfg.train.chamfer_samples
        return {"rot": torch.as_tensor(np.stack([rotation(self.draw_rng) for _ in range(count)])),
                "idx0": torch.as_tensor(self.draw_rng.integers(0, t.vertices.shape[0], (count, s))),
                "idx1": torch.as_tensor(self.draw_rng.integers(0, t.gt_vertices.shape[0],
                                                               (count, s)))}

    def call(self, count: int = 0, patch: int = -1) -> PendingCall:
        count = count or self.steps_per_call
        patch = self.order.take(1)[0] if patch < 0 else patch
        draws = self._draws(patch, count)
        self.steps_done += [patch] * count
        graph = self.graphs.get(patch, lambda: self.step.scanned(
            self.state, self.tensors[patch], self.steps_per_call))
        _, losses = graph(self.state, draws)
        return PendingCall(losses.numpy, count, count * self.real_faces[patch],
                           {"patch": patch, **draws})

    def first_steps(self) -> Trajectory:
        """The first three steps, through the window's call: one step, then
        two on another patch."""
        return first_steps(self, FIRST_STEPS)

    def warm(self) -> None:
        """Capture every other patch's step by a call of one step."""
        seen = {d["patch"] for d in self.first_draws}
        for patch in range(len(self.patches)):
            if patch not in seen:
                self.call(1, patch).wait()

    def release(self) -> None:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.graphs = self.state = self.tensors = self.params0 = None

    # -- the reference ------------------------------------------------------

    def reference_patch(self, i: int) -> RefVertexPatch:
        p, mesh = self.patches[i], self.meshes[self.owners[i]]
        tree = tree_faces(p, p.num_nodes)
        base = prepare_reference_patch(mesh, tree, self.config)
        v_old = np.asarray(p.v_old_idx, np.int64)
        real = tree >= 0
        used = np.unique(mesh.faces[tree[real]].reshape(-1))
        if v_old.size != np.unique(v_old).size or not np.array_equal(np.sort(v_old), used):
            raise ValueError("vertex patch: the vertex order does not hold the faces' vertices")
        local = np.full(mesh.noisy.shape[0], -1, np.int64)
        local[v_old] = np.arange(v_old.size)
        tri = np.full((tree.size, 3), -1, np.int64)
        tri[real] = local[mesh.faces[tree[real]]]
        corner_v = tri[real].reshape(-1)
        corner_t = np.repeat(np.flatnonzero(real), 3)
        order = np.argsort(corner_v, kind="stable")
        counts = np.bincount(corner_v, minlength=v_old.size)
        if counts.max() > self.config["k_vertices"]:
            raise ValueError(f"a vertex has {counts.max()} faces, past k_vertices")
        v_faces = np.full((v_old.size, int(counts.max())), -1, np.int64)
        rank = np.arange(order.size) - np.repeat(np.cumsum(counts) - counts, counts)
        v_faces[corner_v[order], rank] = corner_t[order]
        diag = _bbox_diag32(mesh.noisy, mesh.clean)
        verts = (np.asarray(mesh.noisy, np.float32) / diag)[v_old]
        gt_all = np.asarray(mesh.clean, np.float32) / diag
        lo, hi = verts.min(axis=0), verts.max(axis=0)
        gt = gt_all[np.all((gt_all >= lo) & (gt_all <= hi), axis=1)]
        return RefVertexPatch(base, torch.as_tensor(verts), torch.as_tensor(gt),
                              torch.as_tensor(tri), torch.as_tensor(v_faces))

    def reference_losses(self, device: str, fault: str = "", tolerance: float = None):
        """The loss closures of the first steps, each also giving its
        chamfer terms near-tied within ``tolerance`` (default: the cell's
        ``tie_tolerance``); ``fault="half_batch"`` takes each step's
        chamfer loss over half its sampled points."""
        if tolerance is None:
            tolerance = float(self.cell.workload.get("tie_tolerance", 0.0))
        closures, cache = [], {}
        iters = self.config["ms_solver_iterations"]
        steps = self.config["coarsening_steps"]
        for draws in self.first_draws:
            i = draws["patch"]
            if i not in cache:
                cache[i] = self.reference_patch(i).to(device)
            for j in range(len(draws["rot"])):
                idx0, idx1 = draws["idx0"][j], draws["idx1"][j]
                if fault == "half_batch":
                    idx0, idx1 = idx0[:len(idx0) // 2], idx1[:len(idx1) // 2]
                closures.append(_vertex_loss(cache[i], draws["rot"][j].to(device),
                                             idx0.to(device), idx1.to(device), iters, steps,
                                             tolerance))
        return closures

    # -- what the per-layer metrics read ------------------------------------

    def kernel_convs(self, kernel: str) -> List[str]:
        return [name for name, _ in ref_net.CONVS] if kernel in ("k1", "k2") else []

    def step_levels(self, steps: List[int]):
        out = []
        for s in steps:
            i = self.steps_done[s]
            if i not in self._levels:
                self._levels[i] = prepare_reference_patch(
                    self.meshes[self.owners[i]], tree_faces(self.patches[i],
                                                            self.patches[i].num_nodes),
                    self.config).levels
            out.append(self._levels[i])
        return out

    def solver_ms(self) -> float:
        """One forward and backward of the program's operator solver at the
        largest patch, on that patch's inputs and the heads of the current
        weights: captured in a CUDA graph as the train step runs it, timed
        by CUDA events over replays after a warm-up."""
        from facet_graph_convolution_torch.models.augment import rotate_inputs, rotate_vec3
        from facet_graph_convolution_torch.models.unet import unet_apply
        from facet_graph_convolution_torch.ops.normalization import normalize_tensor
        from facet_graph_convolution_torch.ops.vertex_update import (
            update_positions_multiscale_operator,
        )

        i = max(range(len(self.patches)), key=lambda k: self.patches[k].num_nodes)
        t = self.tensors[i]
        rot = torch.as_tensor(rotation(seed_sequence(0, "solver_metric")), device=self.device)
        with torch.no_grad():
            heads = unet_apply(self.state.params, rotate_inputs(rot, t.x), t.adjs, t.rows,
                               coarsening_steps=self.cfg.model.coarsening_steps,
                               alpha=self.cfg.model.lrelu_alpha, adj_ts=t.adj_ts,
                               multi_scale=True)
            normals = [normalize_tensor(h) for h in heads]
        normals = [n.detach().requires_grad_() for n in normals]
        x0 = rotate_vec3(rot, t.vertices)
        gy = torch.ones_like(x0)

        def once():
            x, _ = update_positions_multiscale_operator(
                x0, normals, t.faces, t.v_faces, t.tables,
                coarsening_steps=self.cfg.model.coarsening_steps,
                iter_nums=self.cfg.eval.ms_solver_iterations)
            torch.autograd.grad(x, normals, gy)

        # as the train step runs it: captured in a CUDA graph, timed by replays
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            once()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            once()
        graph.replay()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(SOLVER_REPS):
            graph.replay()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / SOLVER_REPS


def _vertex_loss(p: RefVertexPatch, rot, idx0, idx1, iters, steps, tolerance):
    def loss(params):
        x = (p.base.x.reshape(-1, 2, 3) @ rot.T).reshape(-1, 6)
        heads = ref_net.unet(params, x, p.base.nbrs, fan=p.base.fan, heads=3)
        normals = [ref_net.normalize(h) for h in heads]
        solved = ref_solver.solve(p.vertices @ rot.T, normals, p.tri, p.v_faces, iters, steps)
        return ref_net.chamfer_loss(solved, p.gt_points @ rot.T, idx0, idx1,
                                    tolerance=tolerance)
    return loss
