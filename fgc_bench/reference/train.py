"""The plain reference's first training steps, and the numbers that
compare them with the program's.

:func:`run_steps` starts from the weights the benchmark made, takes each
step's loss from a closure over that step's inputs (built by a driver from
the meshes and the draws), its gradients by autograd and Adam's update, and
returns what :func:`compare` reads: the losses, the first step's gradients
and the change of the parameters over the steps.

A closure may also return the near-tied terms of its loss (see
``network.chamfer_loss``): at the first step :func:`run_steps` then takes
each one's gradient as well, so that :func:`compare` can measure the first
gradient against every resolution of those ties, the nearest counting.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from fgc_bench.reference.network import adam_step

Params = Dict[str, Dict[str, torch.Tensor]]
MAX_TIES = 12           # near-tied terms resolved both ways, the closest first


@dataclass
class Trajectory:
    """What one side's first steps left: the loss of each step, the
    gradients the optimizer got at the first, and each leaf's change over
    all of them (float32 host tensors, keyed ``(layer, name)``)."""

    losses: List[float]
    first_grads: Dict[tuple, torch.Tensor]
    change: Dict[tuple, torch.Tensor]
    # the first step's near-tied loss terms: their margins [k], and per leaf
    # (‖G‖², G·Δ_q [k], Δ_q·Δ_r [k, k]) in float64, Δ_q the change of the
    # gradient G were tie q resolved the other way
    tie_margins: Optional[np.ndarray] = None
    tie_gram: Optional[Dict[tuple, Tuple[float, np.ndarray, np.ndarray]]] = None


@contextlib.contextmanager
def matmul_precision(tf32: bool):
    """Products in float32 (TF32 off), or in TF32 for the control."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def run_steps(params0: Params, losses: List[Callable[[Params], torch.Tensor]], lr: float,
              device: str, tf32: bool = False) -> Trajectory:
    """Adam steps from ``params0`` (host tensors), one a closure of
    ``losses``, on ``device``."""
    params = {layer: {name: t.detach().to(device, torch.float32).clone().requires_grad_()
                      for name, t in leaves.items()} for layer, leaves in params0.items()}
    state: Dict = {}
    out, first, margins, gram = [], None, None, None
    with matmul_precision(tf32):
        for loss_fn in losses:
            loss, ties = loss_fn(params), None
            if isinstance(loss, tuple):
                loss, ties, tie_margins = loss
            leaves = [(k, n, t) for k, d in params.items() for n, t in d.items()]
            tensors = [t for _, _, t in leaves]
            first_with_ties = first is None and ties is not None and ties.numel() > 0
            grads = torch.autograd.grad(loss, tensors, allow_unused=True,
                                        retain_graph=first_with_ties)
            grads = {(k, n): (torch.zeros_like(t) if g is None else g)
                     for (k, n, t), g in zip(leaves, grads)}
            out.append(float(loss.detach()))
            if first is None and ties is not None:
                margins = tie_margins.detach().double().cpu().numpy()
            if first_with_ties:
                gram = _tie_gram(grads, ties, leaves)
            if first is None:
                first = {key: g.detach().cpu() for key, g in grads.items()}
            with torch.no_grad():
                adam_step(params, {k: {n: grads[(k, n)] for n in d} for k, d in params.items()},
                          state, lr)
    change = {(k, n): (t.detach().cpu() - params0[k][n].detach().cpu().float())
              for k, d in params.items() for n, t in d.items()}
    return Trajectory(out, first, change, margins, gram)


def _tie_gram(grads, ties, leaves):
    """Per leaf ``(‖G‖², [G·Δ_q], [Δ_q·Δ_r])`` for the gradients Δ_q of the
    near-tied terms ``ties`` (one backward pass each)."""
    tensors = [t for _, _, t in leaves]
    deltas = []
    for q in range(ties.numel()):
        d = torch.autograd.grad(ties[q], tensors, allow_unused=True,
                                retain_graph=q + 1 < ties.numel())
        deltas.append([torch.zeros_like(t) if g is None else g for t, g in zip(tensors, d)])
    out = {}
    for i, (k, n, _) in enumerate(leaves):
        g = grads[(k, n)].double().reshape(-1)
        dq = torch.stack([d[i].double().reshape(-1) for d in deltas])      # [k, numel]
        out[(k, n)] = (float(g @ g), (dq @ g).cpu().numpy(), (dq @ dq.T).cpu().numpy())
    return out


def leaf_norms(leaves: Dict[tuple, torch.Tensor]) -> Dict[tuple, float]:
    return {key: float(torch.linalg.vector_norm(t.double())) for key, t in leaves.items()}


def _leaf_gaps(got: Dict[tuple, float], ref: Dict[tuple, float], keys) -> List[float]:
    """Each leaf's gap between two sides' norms, against the larger of the
    reference's norm of that leaf and of the median leaf."""
    median = float(np.median([ref[k] for k in keys]))
    return [abs(got[k] - ref[k]) / max(ref[k], median) for k in keys]


def tie_resolutions(ref: Trajectory, tolerance: float) -> List[Dict[tuple, float]]:
    """The reference's first-gradient leaf norms under every resolution of
    its near-tied terms whose margin is at most ``tolerance`` (the first,
    its own resolution)."""
    base = leaf_norms(ref.first_grads)
    if ref.tie_gram is None:
        return [base]
    picked = np.flatnonzero(ref.tie_margins <= tolerance)
    if picked.size > MAX_TIES:
        picked = picked[np.argsort(ref.tie_margins[picked], kind="stable")[:MAX_TIES]]
    subsets = ((np.arange(2 ** picked.size)[:, None] >> np.arange(picked.size)) & 1)
    subsets = subsets.astype(np.float64)                                  # [2^k, k]
    norms = {}
    for key, (gg, ga, dd) in ref.tie_gram.items():
        a, b = ga[picked], dd[np.ix_(picked, picked)]
        sq = gg + 2.0 * subsets @ a + np.einsum("sq,qr,sr->s", subsets, b, subsets)
        norms[key] = np.sqrt(np.maximum(sq, 0.0))
    return [{key: float(v[i]) for key, v in norms.items()} for i in range(len(subsets))]


def compare(got: Trajectory, ref: Trajectory, tie_tolerance: float = 0.0) -> Dict[str, float]:
    """The numbers a cell may compare with its limits (its workload file
    names which):

    - ``loss_gap``: the largest relative gap of a step's loss;
    - ``loss1_gap``: the relative gap of the first step's loss, which no
      earlier update has moved;
    - ``grad_gap`` / ``grad_median_gap``: the worst / the median leaf's gap
      between the norms of the first gradient;
    - ``change_gap`` / ``change_median_gap``: the same of the parameters'
      change over the steps, leaving out leaves whose reference gradient is
      under a thousandth of the median leaf's (Adam moves them by
      round-off).

    A leaf's gap is taken against the larger of the reference's norm of
    that leaf and of the median leaf. Where the reference's first loss had
    near-tied terms (margin ≤ ``tie_tolerance``), the first gradient's two
    numbers are each the least over the resolutions of those ties. A side
    whose numbers are not finite reads ``inf``."""
    names = ("loss_gap", "loss1_gap", "grad_gap", "grad_median_gap", "change_gap",
             "change_median_gap")
    if len(got.losses) != len(ref.losses):
        return dict.fromkeys(names, float("inf"))
    losses = [abs(a - b) / abs(b) for a, b in zip(got.losses, ref.losses)]
    g_got, g_ref = leaf_norms(got.first_grads), leaf_norms(ref.first_grads)
    keys = sorted(g_ref)
    median_g = float(np.median([g_ref[k] for k in keys]))
    grads = [[abs(g_got[k] - r[k]) / max(g_ref[k], median_g) for k in keys]
             for r in tie_resolutions(ref, tie_tolerance)]
    moving = [k for k in keys if g_ref[k] >= 1e-3 * median_g]
    changes = _leaf_gaps(leaf_norms(got.change), leaf_norms(ref.change), moving)
    out = dict(zip(names, (max(losses), losses[0], min(max(g) for g in grads),
                           min(float(np.median(g)) for g in grads),
                           max(changes), float(np.median(changes)))))
    return {k: (v if np.isfinite(v) else float("inf")) for k, v in out.items()}
