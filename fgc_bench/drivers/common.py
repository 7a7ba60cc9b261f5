"""What the drivers share: the program's configuration built from a
configuration file, a pending call of the window, the program's side of
the first steps (its optimizer's first gradients, its parameters' change)
and the reference's inputs of a patch."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from fgc_bench.reference.geometry import face_inputs, face_normals
from fgc_bench.reference.graph import LevelGraph, check_k_list, patch_levels
from fgc_bench.reference.train import Trajectory

ADAM_BETA1 = 0.9


def port_config(config: Dict, seed: int):
    """The program's ``Config`` of a configuration file."""
    from facet_graph_convolution_torch.config import default_config

    cfg = default_config("./")
    return cfg.replace(
        model={"channels": tuple(config["channels"]), "num_filters": config["num_filters"],
               "fc_channels": config["fc_channels"], "out_channels": config["out_channels"],
               "coarsening_steps": config["coarsening_steps"],
               "coarsening_levels": config["coarsening_levels"],
               "lrelu_alpha": config["lrelu_alpha"], "std_dev": config["std_dev"],
               "std_dev_bias": config["std_dev_bias"],
               "include_vertices": config["include_vertices"],
               "rotation_invariance": config["rotation_invariance"],
               "translation_invariance": config["translation_invariance"],
               "compute_dtype": config["compute_dtype"]},
        data={"k_faces": config["k_faces"], "k_vertices": config["k_vertices"]},
        train={"loss_samples": config["loss_samples"],
               "chamfer_samples": config["chamfer_samples"],
               "learning_rate": config["learning_rate"], "lr_schedule": "constant",
               "augment_rotations": config["augment_rotations"], "seed": int(seed) % 2**32},
        eval={"vertex_solver": config["vertex_solver"],
              "ms_solver_iterations": tuple(config["ms_solver_iterations"])})


class PendingCall:
    """One enqueued call: ``wait()`` blocks until its losses are on the
    host and returns them. ``done`` is the host clock at which a call that
    returned only once complete completed (None for one still running)."""

    def __init__(self, read: Callable[[], np.ndarray], steps: int, faces: int,
                 draws: Optional[Dict] = None, done: Optional[float] = None):
        self.read, self.steps, self.faces, self.draws = read, steps, faces, draws
        self.done = done

    def wait(self) -> np.ndarray:
        return np.asarray(self.read(), dtype=np.float64).reshape(-1)


def _param_items(state):
    return [(layer, name, t) for layer in sorted(state.params)
            for name, t in sorted(state.params[layer].items())]


def optimizer_grads(state) -> Dict[tuple, torch.Tensor]:
    """The first step's gradients as the program's Adam got them, from its
    first moment after one update (``(1 − β1)·g``)."""
    out = {}
    for layer, name, t in _param_items(state):
        held = state.optimizer.state.get(t, {})
        m = held["exp_avg"] if "exp_avg" in held else torch.zeros_like(t)
        out[(layer, name)] = (m.detach().float() / (1.0 - ADAM_BETA1)).cpu()
    return out


def param_change(state, params0) -> Dict[tuple, torch.Tensor]:
    return {(layer, name): t.detach().float().cpu() - params0[layer][name].float()
            for layer, name, t in _param_items(state)}


def first_steps(session, counts) -> Trajectory:
    """The program's side of the first steps: calls of ``counts`` steps
    through the session's own call, the gradients its optimizer got at the
    first step and its parameters' change after the last."""
    losses, grads = [], None
    for count in counts:
        pending = session.call(count)
        losses += [float(x) for x in pending.wait()]
        session.first_draws.append(pending.draws)
        if grads is None:
            grads = optimizer_grads(session.state)
    return Trajectory(losses, grads, param_change(session.state, session.host_params0))


def tree_faces(patch, num_nodes: int) -> np.ndarray:
    """The mesh face of each of the program's tree positions of ``patch``
    (-1 where it put a fake node), padded to ``num_nodes``."""
    out = np.full(num_nodes, -1, np.int64)
    if patch.perm_inv is None:
        local = np.arange(patch.num_nodes)
    else:
        local = np.argsort(np.asarray(patch.perm_inv))
    real = local < patch.num_real
    glob = np.full(local.size, -1, np.int64)
    glob[real] = np.asarray(patch.patch_indices, np.int64)[local[real]]
    out[:glob.size] = glob
    return out


@dataclass
class ReferencePatch:
    """A patch as the reference sees it: inputs ``x`` [N, 6], true normals
    ``gt`` [N, 3] (zero at fake nodes), the slot table of each level and the
    tree's fan-in."""

    x: torch.Tensor
    gt: torch.Tensor
    nbrs: List[torch.Tensor]
    levels: List[LevelGraph]
    fan: int

    def to(self, device: str) -> "ReferencePatch":
        return ReferencePatch(self.x.to(device), self.gt.to(device),
                              [t.to(device) for t in self.nbrs], self.levels, self.fan)


def prepare_reference_patch(mesh, tree: np.ndarray, config: Dict) -> ReferencePatch:
    """The reference's inputs of the patch whose tree positions hold the
    faces ``tree`` of ``mesh``, worked out from the mesh."""
    check_k_list(mesh.faces, config["k_faces"])
    levels = patch_levels(tree, mesh.faces, config["coarsening_levels"],
                          config["coarsening_steps"], config["k_faces"])
    real = tree >= 0
    x = np.zeros((tree.size, 6), np.float32)
    x[real] = face_inputs(mesh.noisy, mesh.faces)[tree[real]]
    gt = np.zeros((tree.size, 3), np.float32)
    gt[real] = face_normals(mesh.clean, mesh.faces)[tree[real]]
    return ReferencePatch(torch.as_tensor(x), torch.as_tensor(gt),
                          [torch.as_tensor(g.nbr) for g in levels], levels,
                          2 ** config["coarsening_steps"])
