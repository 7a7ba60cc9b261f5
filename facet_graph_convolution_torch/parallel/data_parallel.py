"""Patch-batch data parallelism (the port's counterpart of
``facet_graph_convolution_tpu/parallel/data_parallel.py``).

The reference trains one patch a step on one device (train.py:404-405,
558). Here each rank of a group trains one bucket-padded patch a step and
the gradients are AVERAGED over the ranks (one all-reduce of their
concatenation, then a division by the group's size: what JAX's ``pmean``
means; JAX's step in fact applies their sum, since inside ``shard_map``
the gradient of a replicated parameter is already summed over the
devices, and Adam's update hides the scale), running the
same single-card step as the trainer (``training.trainer.normals_loss``:
K1/K2 in the convs, K3 in a rotation-invariant conv1, f32 or bf16 by
``cfg.model.compute_dtype``), so a rank's throughput is the single-card
step's.

Data flow: the whole bucket-unified patch set is staged on each rank's
device once as a :class:`..training.trainer.PatchStack` (the "bank", JAX's
``_stack_patch_arrays``), and each step takes its rank's patch from it by
index (``PatchStack.select``): no upload a step. Every draw (the patch
indices, each rank's rotation and loss faces) is made alike on every rank
from seeded generators; each rank uses its own row.

JAX chains steps inside one ``lax.scan`` dispatch (``selection="step"``:
:func:`make_dp_scanned_step`; ``"chunk"``: :func:`make_dp_chunk_runner`,
one fixed patch a rank for a chunk). The port keeps both selections' draw
semantics and runs their steps eagerly at every group size: capturing a
step whose gradients cross ranks in a CUDA graph would need NCCL's
graph-safe mode, which this module does not set up.
"""

from __future__ import annotations

import math
import os
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from facet_graph_convolution_torch.config import Config
from facet_graph_convolution_torch.data.dataset import FacetPatch, pad_patch_to
from facet_graph_convolution_torch.models.augment import random_rotation
from facet_graph_convolution_torch.parallel.mesh import GraphGroup, make_mesh
from facet_graph_convolution_torch.training.checkpoint import CheckpointManager
from facet_graph_convolution_torch.training.trainer import (
    PatchStack,
    TrainState,
    _leaves,
    adam_update,
    create_train_state,
    normals_loss,
    stack_patch_tensors,
)


def stack_patches(patches: Sequence[FacetPatch], target: int):
    """Pad each patch to ``target`` fine nodes and stack into host arrays:
    ``(x [B, N, C], adjs tuple of [B, N_l, K], gt [B, N, 3])``, the raw
    K-list form (JAX ``stack_patches``; the bank the step reads is
    :func:`build_patch_bank`)."""
    padded = [pad_patch_to(p, target) for p in patches]
    x = np.stack([p.inputs for p in padded])
    adjs = tuple(np.stack([p.adjs[lvl] for p in padded]) for lvl in range(len(padded[0].adjs)))
    gt = np.stack([p.gt_normals for p in padded])
    return x, adjs, gt


def bank_nodes(patches: Sequence[FacetPatch], cfg: Config) -> int:
    """The bank's node count: the largest patch rounded up to a multiple of
    lcm(1024, (2^steps)^(levels−1)) (JAX ``build_patch_bank``'s lane-aligned
    bucket), so both packages pad to the same N."""
    group = (2 ** cfg.model.coarsening_steps) ** (cfg.model.coarsening_levels - 1)
    align = 1024 * group // math.gcd(1024, group)
    target = max(p.num_nodes for p in patches)
    return ((target + align - 1) // align) * align


def build_patch_bank(patches: Sequence[FacetPatch], cfg: Config, device: str = "cuda") -> PatchStack:
    """The patch set on ``device`` as one :class:`..training.trainer.
    PatchStack`: every patch padded to :func:`bank_nodes`, its kernel
    tables built once, stacked with the slot axes zero-padded (JAX
    ``build_patch_bank``)."""
    target = bank_nodes(patches, cfg)
    return stack_patch_tensors([pad_patch_to(p, target) for p in patches], device)


def dp_draws(cfg: Config, generator: torch.Generator, num_ranks: int,
             num_nodes: int) -> Dict[str, torch.Tensor]:
    """One DP step's draws for every rank, in rank order: per rank its
    rotation [3, 3] (when ``cfg.train.augment_rotations``), then its
    ``loss_samples`` faces of ``num_nodes`` (the order of the single-card
    step, ``make_normals_train_step``). ``{"rot": [D, 3, 3], "sample_idx":
    [D, S]}``; every rank draws the same and uses its row."""
    rots, samples = [], []
    for _ in range(num_ranks):
        if cfg.train.augment_rotations:
            rots.append(random_rotation(generator))
        samples.append(torch.randint(0, num_nodes, (cfg.train.loss_samples,),
                                     generator=generator))
    out = {"sample_idx": torch.stack(samples)}
    if rots:
        out["rot"] = torch.stack(rots)
    return out


def average_grads(params, group: GraphGroup) -> None:
    """Replace every parameter's gradient by its mean over the ranks, in one
    all-reduce of their concatenation (JAX's ``pmean``); nothing at one
    rank."""
    if group.size == 1:
        return
    leaves = _leaves(params)
    flat = torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p)).reshape(-1)
                      for p in leaves])
    dist.all_reduce(flat, group=group.group)
    flat /= group.size
    offset = 0
    for p in leaves:
        p.grad = flat[offset:offset + p.numel()].view_as(p).clone()
        offset += p.numel()


def mean_over_ranks(t: torch.Tensor, group: GraphGroup) -> torch.Tensor:
    """The mean of a 0-d tensor over the ranks (JAX's ``pmean``)."""
    if group.size == 1:
        return t
    t = t.detach().clone()
    dist.all_reduce(t, group=group.group)
    return t / group.size


def _rank_patch(bank: PatchStack, idx, group: GraphGroup) -> tuple:
    """This rank's patch of the bank, ``bank[idx[rank]]``."""
    return bank.select(torch.as_tensor([int(idx[group.rank])], dtype=torch.int64,
                                       device=bank.xs.device))


def _rank_loss(params, cfg: Config, patch: tuple, draws: Dict[str, torch.Tensor], rank: int):
    dev = patch[0].device
    rot = draws["rot"][rank].to(dev) if "rot" in draws else None
    return normals_loss(params, cfg, *patch, draws["sample_idx"][rank].to(dev), rot)


def _update(state: TrainState, loss: torch.Tensor, group: GraphGroup) -> TrainState:
    state.optimizer.zero_grad(set_to_none=True)
    loss.backward()
    average_grads(state.params, group)
    return adam_update(state)


def make_dp_train_step(cfg: Config, group: Optional[GraphGroup] = None):
    """The DP step over a staged bank (JAX ``make_dp_train_step``):

    ``step(state, bank, idx [D], draws) → (state, mean loss)``

    ``bank`` is :func:`build_patch_bank`'s; ``idx`` holds one patch index a
    rank and ``draws`` :func:`dp_draws`'s rows, alike on every rank. Each
    rank runs the single-card step's loss on ``bank[idx[rank]]`` with its
    rotation and loss faces, backpropagates it, and Adam applies the
    gradients averaged over the ranks; the loss returned is the ranks' mean
    (0-d, detached, before the update). ``step.eval(params, bank, idx,
    draws)`` is the mean loss without a gradient."""
    group = group or make_mesh()

    def step(state: TrainState, bank: PatchStack, idx, draws):
        loss = _rank_loss(state.params, cfg, _rank_patch(bank, idx, group), draws, group.rank)
        return _update(state, loss, group), mean_over_ranks(loss.detach(), group)

    def eval_loss(params, bank: PatchStack, idx, draws):
        with torch.no_grad():
            loss = _rank_loss(params, cfg, _rank_patch(bank, idx, group), draws, group.rank)
            return mean_over_ranks(loss, group)

    step.eval = eval_loss
    return step


def make_dp_scanned_step(step_fn):
    """W DP steps a call, a patch a rank a STEP (JAX
    ``make_dp_scanned_step``'s ``selection="step"`` semantics, the
    reference's random patch an iteration): ``run(state, bank, idxs [W, D],
    draws) → (state, losses [W])``, ``draws`` :func:`dp_draws`'s rows
    stacked [W, D, ...]. The steps run eagerly, one after another."""
    def run(state: TrainState, bank: PatchStack, idxs, draws):
        losses = []
        for w in range(len(idxs)):
            state, loss = step_fn(state, bank, idxs[w], {k: v[w] for k, v in draws.items()})
            losses.append(loss)
        return state, torch.stack(losses)

    return run


def make_dp_chunk_runner(cfg: Config, group: Optional[GraphGroup] = None):
    """Chunked DP (JAX ``make_dp_chunk_runner``): each rank trains ONE fixed
    patch for a whole chunk; patches reshuffle between chunks. Returns
    ``(select, run)``: ``select(bank, idx [D])`` takes this rank's patch
    from the bank once, ``run(state, sel, draws) → (state, losses [W])``
    runs the chunk's W steps on it (``draws`` stacked [W, D, ...]), each
    with its gradients averaged over the ranks. Eager steps."""
    group = group or make_mesh()

    def select(bank: PatchStack, idx) -> tuple:
        return _rank_patch(bank, idx, group)

    def run(state: TrainState, sel: tuple, draws):
        losses = []
        for w in range(draws["sample_idx"].shape[0]):
            loss = _rank_loss(state.params, cfg, sel, {k: v[w] for k, v in draws.items()},
                              group.rank)
            state = _update(state, loss, group)
            losses.append(mean_over_ranks(loss.detach(), group))
        return state, torch.stack(losses)

    return select, run


def train_normals_dp(
    cfg: Config,
    train_set,
    group: Optional[GraphGroup] = None,
    valid_set=None,
    num_iterations: Optional[int] = None,
    log_every: int = 50,
    steps_per_call: int = 1,
    checkpoint: bool = False,
    selection: str = "chunk",
    device: str = "cuda",
) -> Tuple[TrainState, np.ndarray]:
    """Data-parallel training driver (JAX ``train_normals_dp``; the
    multi-patch form of the reference's one patch a step, train.py:549-624):
    every step samples one patch a rank, with the single-card
    ``train_normals``' contract: checkpoints (``checkpoint=True``: rank 0
    writes every ``save_every`` and at the end, every rank resumes from the
    latest), a validation sweep over ``valid_set`` every ``valid_every``
    (in waves of D patches, wrapping around), the loss CSV appended by rank
    0 and the NaN abort (no final save then). ``cfg.model.compute_dtype``
    and the rotation-invariant variant (``cfg.model.rotation_invariance``)
    run as the single-card step runs them.

    Draws: the patch indices from ``np.random.default_rng(cfg.train.seed)``
    as JAX's driver draws them (``rng.integers(num_patches, size=D)`` a
    step, ``size=(steps_per_call, D)`` a chunk); the rotations and loss
    faces from one ``torch.Generator`` seeded with ``cfg.train.seed``
    (:func:`dp_draws`; JAX draws them from its key: other numbers).

    ``steps_per_call > 1`` runs JAX's chunk loop: ``selection="chunk"``
    (default) pins each rank to one patch a chunk
    (:func:`make_dp_chunk_runner`), ``"step"`` samples a patch a rank a step
    (:func:`make_dp_scanned_step`); a shorter last chunk runs single steps;
    a history row, the validation and the checkpoint at chunk boundaries.
    The steps run eagerly at every D. ``group`` defaults to
    :func:`..mesh.make_mesh` on ``device``. Returns ``(state, losses)``."""
    if selection not in ("chunk", "step"):
        raise ValueError(f"selection {selection!r}: use 'chunk' or 'step'")
    group = group or make_mesh(device)
    batch = group.size
    dev = str(group.device)
    iters = num_iterations or cfg.train.num_iterations
    state = create_train_state(cfg, num_steps=iters, device=dev)
    step_fn = make_dp_train_step(cfg, group)
    ckpt = CheckpointManager(cfg.train.network_path, cfg.train.net_name) if checkpoint else None
    start_step = 0
    if ckpt is not None:
        state, start_step = ckpt.restore(state)

    bank = build_patch_bank(train_set.patches, cfg, dev)
    num_patches, n = len(train_set.patches), bank.xs.shape[1]
    valid_bank = None
    if valid_set is not None and valid_set.patches:
        valid_bank = build_patch_bank(valid_set.patches, cfg, dev)
        n_valid, n_valid_nodes = len(valid_set.patches), valid_bank.xs.shape[1]

    rng = np.random.default_rng(cfg.train.seed)
    generator = torch.Generator().manual_seed(cfg.train.seed)
    loss_hist: List[Tuple[float, float]] = []
    losses: List[float] = []
    last_valid = float("nan")
    aborted = False
    t_start = time.time()

    def save(it):
        if ckpt is not None and group.rank == 0:
            ckpt.save(start_step + it, state)

    def validate() -> float:
        total, waves = 0.0, 0
        for w0 in range(0, n_valid, batch):
            idx = [(w0 + i) % n_valid for i in range(batch)]
            total += float(step_fn.eval(state.params, valid_bank, idx,
                                        dp_draws(cfg, generator, batch, n_valid_nodes)))
            waves += 1
        return total / max(waves, 1)

    def chunk_draws(count):
        rows = [dp_draws(cfg, generator, batch, n) for _ in range(count)]
        return {k: torch.stack([r[k] for r in rows]) for k in rows[0]}

    def log(it, avg):
        if group.rank == 0:
            print(f"iter {it}: dp loss {avg:.4f} ({time.time() - t_start:.1f}s)", flush=True)

    if steps_per_call > 1:
        if selection == "chunk":
            chunk_select, chunk_run = make_dp_chunk_runner(cfg, group)
        else:
            run = make_dp_scanned_step(step_fn)
        it = 0
        while it < iters:
            chunk = min(steps_per_call, iters - it)
            idxs = rng.integers(num_patches, size=(steps_per_call, batch))
            if chunk == steps_per_call and selection == "chunk":
                state, chunk_losses = chunk_run(state, chunk_select(bank, idxs[0]),
                                                chunk_draws(chunk))
            elif chunk == steps_per_call:
                state, chunk_losses = run(state, bank, idxs, chunk_draws(chunk))
            else:
                rem = []
                for j in range(chunk):
                    state, loss = step_fn(state, bank, idxs[j], dp_draws(cfg, generator, batch, n))
                    rem.append(loss)
                chunk_losses = torch.stack(rem)
            it += chunk
            chunk_losses = chunk_losses.cpu().numpy()
            losses.extend(chunk_losses.tolist())
            avg = float(chunk_losses.mean())
            if valid_bank is not None and it % cfg.train.valid_every < chunk:
                last_valid = validate()
            loss_hist.append((avg, last_valid))
            log(it, avg)
            if not np.isfinite(avg):
                print("NaN training loss — aborting", flush=True)
                aborted = True
                break
            if it % cfg.train.save_every < chunk:
                save(it)
    else:
        for it in range(iters):
            idx = rng.integers(num_patches, size=batch)
            state, loss = step_fn(state, bank, idx, dp_draws(cfg, generator, batch, n))
            losses.append(float(loss))
            if valid_bank is not None and it % cfg.train.valid_every == 0:
                last_valid = validate()
            if it % log_every == 0:
                avg = float(np.mean(losses[-log_every:]))
                loss_hist.append((avg, last_valid))
                log(it, avg)
                if not np.isfinite(avg):
                    print("NaN training loss — aborting", flush=True)
                    aborted = True
                    break
            if it > 0 and it % cfg.train.save_every == 0:
                save(it)

    if not aborted:
        # a NaN abort leaves the state poisoned: never persist it
        save(iters)
    if loss_hist and group.rank == 0:
        os.makedirs(cfg.train.network_path, exist_ok=True)
        with open(os.path.join(cfg.train.network_path, cfg.train.net_name + ".csv"), "ab") as fh:
            np.savetxt(fh, np.asarray(loss_hist, np.float64), delimiter=",")
    return state, np.asarray(losses)
