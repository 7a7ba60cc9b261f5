"""Normals-supervised training (the port's counterpart of
``facet_graph_convolution_tpu/training/trainer.py``: ``create_train_state``,
``make_normals_train_step``, ``make_normals_eval_step`` and
``train_normals`` with one step per call; reference ``trainNet``,
train.py:380-632).

One train step: rotation augmentation, the U-Net forward over the kernel
tables (K1 in every conv; under ``rotation_invariance`` K3 in conv1 and K1
in the other 7), ``normalize_tensor``, ``face_normals_loss`` on
``loss_samples`` sampled faces, the backward (K2 in every K1 conv), Adam. The
random rotation and the loss samples come from a ``torch.Generator`` on the
host; their numbers differ from the JAX package's for the same seed, so the
tests inject the JAX package's values. The patch sequence comes from
``np.random.default_rng(seed)`` and is the JAX package's.

Not ported yet (each raises): ``steps_per_call > 1`` (a CUDA graph around
the step, ROADMAP queue 1, item 4), bf16 compute, the multi-scale heads,
the vertex pipeline.
"""

from __future__ import annotations

import math
import os
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from facet_graph_convolution_torch.config import Config
from facet_graph_convolution_torch.data.dataset import (
    FacetPatch,
    MeshDataset,
    bucket_size,
    pad_patch_to,
)
from facet_graph_convolution_torch.inference.driver import resolve_device
from facet_graph_convolution_torch.models.augment import (
    random_rotation,
    rotate_inputs,
    rotate_vec3,
)
from facet_graph_convolution_torch.models.losses import face_normals_loss
from facet_graph_convolution_torch.models.unet import (
    init_unet,
    train_graph_tensors,
    unet_apply,
)
from facet_graph_convolution_torch.ops.conv import FacetConvVariant
from facet_graph_convolution_torch.ops.normalization import normalize_tensor
from facet_graph_convolution_torch.training.checkpoint import CheckpointManager

ADAM_BETAS = (0.9, 0.999)   # optax.adam defaults
ADAM_EPS = 1e-8             # added outside the square root, as optax does


@dataclass
class TrainState:
    """Parameters (a dict of layers of leaf tensors that require grad), the
    Adam optimizer over them, its learning-rate schedule and the number of
    updates applied (optax's ``count``; the JAX package's ``state.step``)."""

    params: Dict[str, Dict[str, torch.Tensor]]
    optimizer: torch.optim.Adam
    schedule: Callable[[int], float]
    step: int = 0


def _leaves(params: Mapping) -> List[torch.Tensor]:
    """The parameter tensors in a fixed order (layer, then name, sorted)."""
    return [params[layer][name] for layer in sorted(params) for name in sorted(params[layer])]


def _config_variant(cfg: Config) -> FacetConvVariant:
    """The conv variant of the config's invariance flags (reference
    bTransInvariant/bRotInvariant, model.py:841-842)."""
    if cfg.model.rotation_invariance:
        return FacetConvVariant.ROTATION_INVARIANT
    if cfg.model.translation_invariance:
        return FacetConvVariant.TRANSLATION_INVARIANT
    return FacetConvVariant.DEFAULT


def lr_schedule(cfg: Config, num_steps: Optional[int] = None) -> Callable[[int], float]:
    """Learning rate per update count, as ``create_train_state`` builds it
    with optax: constant, or linear warmup from 0 then cosine decay to
    ``lr_min_ratio`` × the peak over ``num_steps`` (default
    ``num_iterations``). Optax evaluates the schedule at the count BEFORE it
    increments it, so under ``cosine`` the first update has lr 0."""
    lr = cfg.train.learning_rate
    if cfg.train.lr_schedule == "constant":
        return lambda count: lr
    if cfg.train.lr_schedule != "cosine":
        raise ValueError(f"unknown lr_schedule: {cfg.train.lr_schedule!r}")
    total = num_steps or cfg.train.num_iterations
    warmup = min(cfg.train.lr_warmup_steps, max(total // 10, 1))
    decay = max(total, warmup + 1) - warmup
    alpha = 0.0 if lr == 0.0 else cfg.train.lr_min_ratio

    def schedule(count: int) -> float:
        if count < warmup:
            return lr * count / warmup
        t = min(count - warmup, decay)
        return lr * ((1.0 - alpha) * 0.5 * (1.0 + math.cos(math.pi * t / decay)) + alpha)

    return schedule


def create_train_state(
    cfg: Config,
    in_channels: int = 6,
    num_steps: Optional[int] = None,
    device: str = "cuda",
    params: Optional[Mapping] = None,
    multi_scale: bool = False,
) -> TrainState:
    """Parameters from ``init_unet(cfg.train.seed)`` (or ``params``, e.g.
    converted from the JAX package), Adam with optax's defaults, and the
    schedule of :func:`lr_schedule`. ``num_steps`` sizes the cosine
    horizon."""
    if multi_scale:
        raise NotImplementedError("training: the multi-scale heads are not ported yet")
    if cfg.model.compute_dtype != "float32":
        raise NotImplementedError(
            f"training: compute_dtype {cfg.model.compute_dtype!r} is not ported yet (float32)")
    variant = _config_variant(cfg)
    if params is None:
        params = init_unet(
            seed=cfg.train.seed, in_channels=in_channels, channels=tuple(cfg.model.channels),
            num_filters=cfg.model.num_filters, fc_channels=cfg.model.fc_channels,
            out_channels=cfg.model.out_channels, std_dev=cfg.model.std_dev,
            std_dev_bias=cfg.model.std_dev_bias, variant=variant, device=str(device))
    params = {layer: {name: t.detach().to(device).clone().requires_grad_()
                      for name, t in leaves.items()} for layer, leaves in params.items()}
    schedule = lr_schedule(cfg, num_steps)
    optimizer = torch.optim.Adam(_leaves(params), lr=schedule(0), betas=ADAM_BETAS,
                                 eps=ADAM_EPS)
    return TrainState(params, optimizer, schedule, 0)


def adam_state_from_optax(state: TrainState, mu: Mapping, nu: Mapping, count: int) -> TrainState:
    """Load an optax Adam state into ``state``: ``mu`` and ``nu`` are
    parameter pytrees with numpy leaves (``ScaleByAdamState.mu``/``.nu``),
    ``count`` its update count. Afterwards both packages apply the same next
    update from the same parameters."""
    for p, m, v in zip(_leaves(state.params), _leaves(mu), _leaves(nu)):
        state.optimizer.state[p] = {
            "step": torch.tensor(float(count)),
            "exp_avg": torch.tensor(np.asarray(m, np.float32), device=p.device),
            "exp_avg_sq": torch.tensor(np.asarray(v, np.float32), device=p.device)}
    state.step = int(count)
    return state


def adam_update(state: TrainState) -> TrainState:
    """Apply one Adam update with the gradients held in the parameters'
    ``.grad``, at the learning rate ``schedule(step)`` (optax's order), and
    count it."""
    for group in state.optimizer.param_groups:
        group["lr"] = state.schedule(state.step)
    state.optimizer.step()
    state.step += 1
    return state


def patch_tensors(patch: FacetPatch, device: str):
    """A patch's train-step inputs on ``device``: ``(x, adjs, adj_ts,
    mult_rows, gt)``, with the kernel tables of
    :func:`..models.unet.train_graph_tensors`."""
    adjs, adj_ts, rows = train_graph_tensors(patch.adjs, device)
    return (torch.as_tensor(patch.inputs, device=device), adjs, adj_ts, rows,
            torch.as_tensor(patch.gt_normals, device=device))


def normals_loss(params, cfg: Config, x, adjs, adj_ts, rows, gt, sample_idx,
                 rot: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The step's loss: rotate inputs and GT by ``rot`` (when given), U-Net
    forward, ``normalize_tensor``, and ``face_normals_loss`` on the faces
    ``sample_idx``."""
    if rot is not None:
        x = rotate_inputs(rot, x)
        gt = rotate_vec3(rot, gt)
    y = unet_apply(params, x, adjs, rows, coarsening_steps=cfg.model.coarsening_steps,
                   alpha=cfg.model.lrelu_alpha, variant=_config_variant(cfg), adj_ts=adj_ts)
    y = normalize_tensor(y)
    return face_normals_loss(y[sample_idx], gt[sample_idx])


def _default_generator(cfg: Config, generator: Optional[torch.Generator]) -> torch.Generator:
    return generator if generator is not None else torch.Generator().manual_seed(cfg.train.seed)


def make_normals_train_step(cfg: Config, generator: Optional[torch.Generator] = None,
                            augment: Optional[bool] = None):
    """The step ``(state, x, adjs, adj_ts, mult_rows, gt, rot=None,
    sample_idx=None) → (state, loss)``. It updates ``state`` in place and
    returns it with the loss (a 0-d tensor, before the update). ``rot``
    [3, 3] and ``sample_idx`` [loss_samples] are drawn from ``generator``
    (a host generator, default seeded with ``cfg.train.seed``) when not given:
    first the rotation (when augmenting), then the samples, as the JAX step
    splits its key (trainer.py:125-130)."""
    augment = cfg.train.augment_rotations if augment is None else augment
    generator = _default_generator(cfg, generator)
    loss_samples = cfg.train.loss_samples

    def step(state: TrainState, x, adjs, adj_ts, rows, gt, rot=None, sample_idx=None):
        if augment and rot is None:
            rot = random_rotation(generator)
        if sample_idx is None:
            sample_idx = torch.randint(0, x.shape[0], (loss_samples,), generator=generator)
        loss = normals_loss(state.params, cfg, x, adjs, adj_ts, rows, gt,
                            sample_idx.to(x.device),
                            rot.to(x.device) if augment else None)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        return adam_update(state), loss.detach()

    return step


def make_normals_eval_step(cfg: Config, generator: Optional[torch.Generator] = None):
    """``(params, x, adjs, adj_ts, mult_rows, gt) → loss`` on
    ``loss_samples`` faces drawn from ``generator``, without augmentation or
    gradient."""
    generator = _default_generator(cfg, generator)

    def eval_step(params, x, adjs, adj_ts, rows, gt):
        sample_idx = torch.randint(0, x.shape[0], (cfg.train.loss_samples,), generator=generator)
        with torch.no_grad():
            return normals_loss(params, cfg, x, adjs, adj_ts, rows, gt, sample_idx.to(x.device))

    return eval_step


def train_normals(
    cfg: Config,
    train_set: MeshDataset,
    valid_set: Optional[MeshDataset] = None,
    num_iterations: Optional[int] = None,
    bucket_align: int = 1024,
    log_every: Optional[int] = None,
    steps_per_call: int = 1,
    device: str = "cuda",
) -> Tuple[TrainState, np.ndarray]:
    """Normals-supervised training loop (reference ``trainNet``,
    train.py:380-632): a random patch per step, the smoothed train loss every
    ``log_every`` steps, a validation sweep every ``valid_every``, a
    checkpoint every ``save_every`` that aborts on a non-finite loss, a final
    checkpoint unless the state is poisoned, and the loss history appended
    to ``<network_path>/<net_name>.csv``. Resumes from the latest checkpoint.
    Each patch's kernel tables are built once, before the loop. Runs on CUDA
    unless ``device="cpu"``. Returns ``(state, history [rows, 2])``, each
    row the smoothed train loss and the last validation loss."""
    if steps_per_call != 1:
        raise NotImplementedError(
            "train_normals: steps_per_call > 1 (a CUDA graph around the step, ROADMAP "
            "queue 1, item 4) is not ported yet")
    dev = str(resolve_device(device))
    iters = num_iterations or cfg.train.num_iterations
    log_every = log_every or cfg.train.eval_every
    state = create_train_state(cfg, num_steps=iters, device=dev)
    generator = torch.Generator().manual_seed(cfg.train.seed)
    step_fn = make_normals_train_step(cfg, generator)
    eval_fn = make_normals_eval_step(cfg, generator)

    ckpt = CheckpointManager(cfg.train.network_path, cfg.train.net_name)
    state, start_step = ckpt.restore(state)

    def tables(patches):
        return [patch_tensors(pad_patch_to(p, bucket_size(p.num_nodes, bucket_align)), dev)
                for p in patches]

    arrays = tables(train_set.patches)
    valid_arrays = tables(valid_set.patches) if valid_set else []

    rng = np.random.default_rng(cfg.train.seed)
    loss_hist: List[Tuple[float, float]] = []
    smooth_loss, smooth_n, last_valid = 0.0, 0, float("nan")
    poisoned = False
    t_start = time.time()
    for it in range(iters):
        if it > 0 and it % cfg.train.save_every == 0:
            if poisoned:
                break
            ckpt.save(start_step + it, state)
        x, adjs, adj_ts, rows, gt = arrays[int(rng.integers(len(arrays)))]
        state, loss = step_fn(state, x, adjs, adj_ts, rows, gt)
        loss = float(loss)
        if not math.isfinite(loss):
            if not poisoned:
                print(f"iter {it}: non-finite training loss — aborting at the next checkpoint")
            poisoned = True
        smooth_loss += loss
        smooth_n += 1
        if it % log_every == 0:
            avg = smooth_loss / max(smooth_n, 1)
            print(f"iter {it}: train loss {avg:.4f} ({(time.time() - t_start):.1f}s)")
            loss_hist.append((avg, last_valid))
            smooth_loss, smooth_n = 0.0, 0
        if valid_arrays and it % cfg.train.valid_every == 0:
            vloss = sum(float(eval_fn(state.params, *a)) for a in valid_arrays)
            last_valid = vloss / len(valid_arrays)
            print(f"iter {it}: validation loss {last_valid:.4f}")

    if poisoned:
        # a non-finite loss leaves the parameters poisoned: never persist them
        print("NaN training loss — aborted, the final state is not saved")
    else:
        ckpt.save(start_step + iters, state)
    ckpt.close()
    hist = np.asarray(loss_hist, dtype=np.float64)
    os.makedirs(cfg.train.network_path, exist_ok=True)
    with open(os.path.join(cfg.train.network_path, cfg.train.net_name + ".csv"), "ab") as fh:
        np.savetxt(fh, hist, delimiter=",")
    return state, hist
