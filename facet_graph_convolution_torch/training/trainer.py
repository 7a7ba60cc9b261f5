"""Training (the port's counterpart of
``facet_graph_convolution_tpu/training/trainer.py``: ``create_train_state``,
``make_normals_train_step``, ``make_normals_eval_step`` and
``train_normals`` with one step per call, reference ``trainNet``
train.py:380-632; ``make_vertex_train_step`` and ``train_with_vertices``,
reference ``trainAccuracyNet`` train.py:636-914).

One train step: rotation augmentation, the U-Net forward over the kernel
tables (K1 in every conv; under ``rotation_invariance`` K3 in conv1 and K1
in the other 7), ``normalize_tensor``, ``face_normals_loss`` on
``loss_samples`` sampled faces, the backward (K2 in every K1 conv), Adam. The
random rotation and the loss samples come from a ``torch.Generator`` on the
host; their numbers differ from the JAX package's for the same seed, so the
tests inject the JAX package's values. The patch sequence comes from
``np.random.default_rng(seed)`` and is the JAX package's.

One vertex train step: one rotation of the inputs, the vertices and the GT
vertices, the three-head U-Net (K1/K2 as above), ``normalize_tensor`` on
each head, the multi-scale vertex solver (the operator form over per-patch
tables, or the naive form), ``full_chamfer_loss`` on sampled points (plus
``normals_weight`` × the angular loss of the fine head), the backward from
the chamfer loss through the solver's iterations into the U-Net, Adam.

``steps_per_call > 1`` runs chunks of steps through
:class:`..graph_step.GraphStep` (the JAX package's ``lax.scan`` calls): on
the card each step is one replay of a captured CUDA graph, on the CPU the
same step runs eagerly. The normals loop stacks the patches
(:func:`stack_patch_tensors`) and picks each step's patch on the device;
the vertex loop pins one patch a chunk, with a graph a patch, held by a
:class:`..graph_step.GraphCache` within a memory budget.

Under the naive solver the vertex step's backward runs the scale kernel's
adjoint kernel on the card (``ops/ms_solver_kernel.py::NaiveScale``), over
per-patch maps built once before the loop.

``cfg.model.compute_dtype = "bfloat16"`` (the JAX package's production
training configuration, ``bench.py``) runs the normals train step's convs
with bfloat16 interiors: K1/K2 and K3 in their bfloat16 forms, the convs'
products from bf16 operands into f32 (:func:`..ops.conv.facet_conv`). The
parameters, Adam, the loss and everything outside the convs stay float32,
and the checkpoints are float32. As in the JAX package, the eval step, the
validation, the vertex step and serving ignore ``compute_dtype`` and run
float32. A ``compute_dtype`` other than "float32" or "bfloat16" raises
(the JAX package runs float32 under any other string).
"""

from __future__ import annotations

import json
import math
import os
import time
from collections import OrderedDict
from dataclasses import dataclass
from typing import Callable, Dict, List, Mapping, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from facet_graph_convolution_torch.config import Config
from facet_graph_convolution_torch.data.dataset import (
    FacetPatch,
    MeshDataset,
    bucket_size,
    pad_patch_to,
)
from facet_graph_convolution_torch.data.stream import PrefetchLoader, ShardedDataset
from facet_graph_convolution_torch.inference.driver import resolve_device, solver_tables
from facet_graph_convolution_torch.models.augment import (
    random_rotation,
    rotate_inputs,
    rotate_vec3,
)
from facet_graph_convolution_torch.models.losses import face_normals_loss, full_chamfer_loss
from facet_graph_convolution_torch.models.unet import (
    init_unet,
    train_graph_arrays,
    train_graph_tensors,
    unet_apply,
)
from facet_graph_convolution_torch.ops.conv import FacetConvVariant
from facet_graph_convolution_torch.ops.normalization import normalize_tensor
from facet_graph_convolution_torch.ops.vertex_update import (
    NaiveMaps,
    build_naive_maps,
    update_positions_multiscale,
    update_positions_multiscale_operator,
)
from facet_graph_convolution_torch.training.checkpoint import CheckpointManager
from facet_graph_convolution_torch.training.graph_step import (
    GraphCache,
    GraphStep,
    default_graph_budget,
    set_learning_rate,
)
from facet_graph_convolution_torch.utils.profiling import mark_grad, span

ADAM_BETAS = (0.9, 0.999)   # optax.adam defaults
ADAM_EPS = 1e-8             # added outside the square root, as optax does


@dataclass
class TrainState:
    """Parameters (a dict of layers of leaf tensors that require grad), the
    Adam optimizer over them (capturable on the card: its learning rate and
    update counts are device tensors, so a CUDA graph can replay it), its
    learning-rate schedule and the number of updates applied (optax's
    ``count``; the JAX package's ``state.step``)."""

    params: Dict[str, Dict[str, torch.Tensor]]
    optimizer: torch.optim.Adam
    schedule: Callable[[int], float]
    step: int = 0


def _leaves(params: Mapping) -> List[torch.Tensor]:
    """The parameter tensors in a fixed order (layer, then name, sorted)."""
    return [params[layer][name] for layer in sorted(params) for name in sorted(params[layer])]


COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def compute_dtype(cfg: Config) -> torch.dtype:
    """The torch dtype of ``cfg.model.compute_dtype``; raises ValueError on
    any other string than "float32" or "bfloat16"."""
    if cfg.model.compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype {cfg.model.compute_dtype!r}: use one of "
                         f"{sorted(COMPUTE_DTYPES)}")
    return COMPUTE_DTYPES[cfg.model.compute_dtype]


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
    horizon; ``multi_scale`` adds the mid and coarse heads of vertex
    training. On the card Adam is ``capturable`` with a tensor learning
    rate, for one step a call as for many, so that both run the same
    arithmetic; the CPU keeps the plain Adam (PyTorch refuses a capturable
    one on CPU parameters). The parameters are float32 under either
    ``compute_dtype``; any other raises ValueError (:func:`compute_dtype`)."""
    compute_dtype(cfg)
    variant = _config_variant(cfg)
    if params is None:
        params = init_unet(
            seed=cfg.train.seed, in_channels=in_channels, channels=tuple(cfg.model.channels),
            num_filters=cfg.model.num_filters, fc_channels=cfg.model.fc_channels,
            out_channels=cfg.model.out_channels, multi_scale=multi_scale,
            std_dev=cfg.model.std_dev, std_dev_bias=cfg.model.std_dev_bias, variant=variant,
            device=str(device))
    params = {layer: {name: t.detach().to(device).clone().requires_grad_()
                      for name, t in leaves.items()} for layer, leaves in params.items()}
    schedule = lr_schedule(cfg, num_steps)
    if torch.device(device).type == "cuda":
        optimizer = torch.optim.Adam(
            _leaves(params), lr=torch.tensor(schedule(0), dtype=torch.float32, device=device),
            betas=ADAM_BETAS, eps=ADAM_EPS, capturable=True, foreach=True)
    else:
        optimizer = torch.optim.Adam(_leaves(params), lr=schedule(0), betas=ADAM_BETAS,
                                     eps=ADAM_EPS)
    return TrainState(params, optimizer, schedule, 0)


def adam_state_from_optax(state: TrainState, mu: Mapping, nu: Mapping, count: int) -> TrainState:
    """Load an optax Adam state into ``state``: ``mu`` and ``nu`` are
    parameter pytrees with numpy leaves (``ScaleByAdamState.mu``/``.nu``),
    ``count`` its update count. Afterwards both packages apply the same next
    update from the same parameters."""
    capturable = state.optimizer.param_groups[0]["capturable"]
    for p, m, v in zip(_leaves(state.params), _leaves(mu), _leaves(nu)):
        state.optimizer.state[p] = {
            "step": torch.tensor(float(count), device=p.device if capturable else None),
            "exp_avg": torch.tensor(np.asarray(m, np.float32), device=p.device),
            "exp_avg_sq": torch.tensor(np.asarray(v, np.float32), device=p.device)}
    state.step = int(count)
    return state


def adam_update(state: TrainState) -> TrainState:
    """Apply one Adam update with the gradients held in the parameters'
    ``.grad``, at the learning rate ``schedule(step)`` (optax's order), and
    count it."""
    set_learning_rate(state.optimizer, state.schedule(state.step))
    state.optimizer.step()
    state.step += 1
    return state


def patch_arrays(patch: FacetPatch):
    """A patch's train-step inputs as host arrays: ``(x, adjs, adj_ts,
    mult_rows, gt)``, with the kernel tables of
    :func:`..models.unet.train_graph_arrays`."""
    adjs, adj_ts, rows = train_graph_arrays(patch.adjs)
    return patch.inputs, adjs, adj_ts, rows, patch.gt_normals


def patch_tensors(patch: FacetPatch, device: str):
    """:func:`patch_arrays` as tensors on ``device``."""
    adjs, adj_ts, rows = train_graph_tensors(patch.adjs, device)
    return (torch.as_tensor(patch.inputs, device=device), adjs, adj_ts, rows,
            torch.as_tensor(patch.gt_normals, device=device))


def normals_loss(params, cfg: Config, x, adjs, adj_ts, rows, gt, sample_idx,
                 rot: Optional[torch.Tensor] = None,
                 dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The step's loss: rotate inputs and GT by ``rot`` (when given), U-Net
    forward with the convs in ``dtype`` (default: the config's
    ``compute_dtype``, as the train step runs them), ``normalize_tensor``,
    and ``face_normals_loss`` on the faces ``sample_idx``."""
    if rot is not None:
        x = rotate_inputs(rot, x)
        gt = rotate_vec3(rot, gt)
    y = unet_apply(params, x, adjs, rows, coarsening_steps=cfg.model.coarsening_steps,
                   alpha=cfg.model.lrelu_alpha, variant=_config_variant(cfg), adj_ts=adj_ts,
                   compute_dtype=compute_dtype(cfg) if dtype is None else dtype)
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
    splits its key (trainer.py:125-130). The convs run in the config's
    ``compute_dtype`` (trainer.py:118-135)."""
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
    gradient, in float32 under any ``compute_dtype`` (the JAX eval step
    passes none)."""
    generator = _default_generator(cfg, generator)

    def eval_step(params, x, adjs, adj_ts, rows, gt):
        sample_idx = torch.randint(0, x.shape[0], (cfg.train.loss_samples,), generator=generator)
        with torch.no_grad():
            return normals_loss(params, cfg, x, adjs, adj_ts, rows, gt, sample_idx.to(x.device),
                                dtype=torch.float32)

    return eval_step


class PatchStack(NamedTuple):
    """Train-step tensors of patches that share one node count, stacked on
    one device (the JAX package's ``_stack_patch_arrays``, trainer.py:
    321-369): ``xs`` [P, N, C] and ``gts`` [P, N, 3]; per level ``adjs``
    [P, K', N'], ``adj_ts`` [P, N', K_t] and ``rows`` [P, K'+1, N', 1],
    zero-padded to the largest K' and K_t."""

    xs: torch.Tensor
    adjs: List[torch.Tensor]
    adj_ts: List[torch.Tensor]
    rows: List[torch.Tensor]
    gts: torch.Tensor

    def select(self, idx: torch.Tensor):
        """Patch ``idx`` (a [1] int64 tensor on the stack's device) as the
        tuple of :func:`patch_tensors`, taken by ``index_select`` (JAX's
        ``take``, trainer.py:391-399), so a captured step picks it on the
        device."""
        def take(t):
            return t.index_select(0, idx)[0]

        return (take(self.xs), [take(a) for a in self.adjs], [take(a) for a in self.adj_ts],
                [take(r) for r in self.rows], take(self.gts))


def _stack_padded(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """Stack, each tensor zero-padded at the end of every axis to the
    largest size there."""
    shape = [max(sizes) for sizes in zip(*(t.shape for t in tensors))]
    padded = []
    for t in tensors:
        pad = []
        for dim in reversed(range(t.dim())):
            pad += [0, shape[dim] - t.shape[dim]]
        padded.append(torch.nn.functional.pad(t, pad))
    return torch.stack(padded)


def stack_patch_tensors(patches: Sequence[FacetPatch], device: str) -> PatchStack:
    """:class:`PatchStack` of ``patches``, which must share one node count
    (:func:`pad_patch_to` the largest bucket first, as the JAX loop does).
    Every level's node axis N' is then the same for all, so only the slot
    axes are padded: the extra slots of ``adjs`` are 0 (they gather the zero
    row), their ``rows`` 0 (multiplicity 0), and the transpose maps, whose
    one-indexed flat slots ``k·N' + n`` do not depend on K', still list
    every slot that reads a node (``graph/convert.py::transpose_adjacency``),
    padded with 0 to the largest K_t."""
    counts = sorted({p.num_nodes for p in patches})
    if len(counts) != 1:
        raise ValueError(f"stack_patch_tensors: the patches have node counts {counts}; pad "
                         "them to one (pad_patch_to) first")
    with span("fgc.prep.upload"):
        per = [patch_tensors(p, device) for p in patches]
        levels = range(len(per[0][1]))
        return PatchStack(
            torch.stack([t[0] for t in per]),
            [_stack_padded([t[1][lvl] for t in per]) for lvl in levels],
            [_stack_padded([t[2][lvl] for t in per]) for lvl in levels],
            [_stack_padded([t[3][lvl] for t in per]) for lvl in levels],
            torch.stack([t[4] for t in per]))


def normals_draws(cfg: Config, generator: torch.Generator, idxs: Sequence[int],
                  num_nodes: int) -> Dict[str, torch.Tensor]:
    """The draws of ``len(idxs)`` normals steps for :class:`GraphStep`, in
    the order as many steps of :func:`make_normals_train_step` draw them
    from ``generator``: per step the rotation (when
    ``cfg.train.augment_rotations``), then ``loss_samples`` faces of
    ``num_nodes``. ``idx`` holds the steps' patch indices into the stack."""
    augment = cfg.train.augment_rotations
    rots, samples = [], []
    for _ in idxs:
        if augment:
            rots.append(random_rotation(generator))
        samples.append(torch.randint(0, num_nodes, (cfg.train.loss_samples,), generator=generator))
    draws = {"idx": torch.as_tensor(np.asarray(idxs), dtype=torch.int64).reshape(-1, 1),
             "sample_idx": torch.stack(samples)}
    if augment:
        draws["rot"] = torch.stack(rots)
    return draws


def make_scanned_train_step(state: TrainState, cfg: Config, stack: PatchStack,
                            steps_per_call: int) -> GraphStep:
    """Up to ``steps_per_call`` normals steps a call over the stacked
    patches (JAX ``make_scanned_train_step``, trainer.py:372-404), each step
    taking its patch from ``stack`` at its drawn index on the device:
    ``(state, normals_draws(...)) → (state, losses)``."""
    def loss_fn(params, idx, sample_idx, rot=None):
        return normals_loss(params, cfg, *stack.select(idx), sample_idx, rot)

    return GraphStep(state, loss_fn, steps_per_call)


def _chunk_loop(iters: int, steps_per_call: int, run_chunk, finish_chunk,
                periods: Sequence[int]) -> bool:
    """Chunks of ``steps_per_call`` steps, the last one shorter, so that
    exactly ``iters`` updates are applied. ``run_chunk(chunk)`` enqueues a
    chunk and returns its losses (a :class:`..graph_step.CallLosses`, or the
    streaming trainer's reader of them); ``finish_chunk(it, chunk, losses)``
    reads them after ``it`` updates and returns False to abort. A chunk is
    finished after the next one is enqueued (the JAX loop's deferred
    ``consume``, trainer.py:466-512), except where it crosses a multiple of
    one of ``periods`` (the checkpoint's and the validation's): those need
    the state as of that chunk, and the port updates it in place. Returns
    False when aborted."""
    it, pending = 0, None
    while it < iters:
        chunk = min(steps_per_call, iters - it)
        losses = run_chunk(chunk)
        it += chunk
        if pending is not None and not finish_chunk(*pending):
            return False
        pending = (it, chunk, losses)
        if any(_every(it, chunk, period) for period in periods):
            done, pending = pending, None
            if not finish_chunk(*done):
                return False
    return pending is None or finish_chunk(*pending)


def _every(it: int, chunk: int, period: int) -> bool:
    """Whether a chunk of ``chunk`` steps ending at ``it`` crossed a
    multiple of ``period`` (JAX ``p_it % period < p_chunk``)."""
    return it % period < chunk


def _write_history(cfg: Config, loss_hist) -> np.ndarray:
    hist = np.asarray(loss_hist, dtype=np.float64)
    os.makedirs(cfg.train.network_path, exist_ok=True)
    with open(os.path.join(cfg.train.network_path, cfg.train.net_name + ".csv"), "ab") as fh:
        np.savetxt(fh, hist, delimiter=",")
    return hist


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
    row the smoothed train loss and the last validation loss.

    ``steps_per_call > 1`` runs the JAX package's scanned loop
    (trainer.py:451-512): the patches padded to the largest bucket and
    stacked, one ``rng.integers(num_patches, size=steps_per_call)`` a chunk
    (the JAX patch sequence), chunks of :func:`make_scanned_train_step` (a
    CUDA graph replayed a step on the card) and a shorter last chunk, a
    history row a chunk (its mean loss), checkpoints and validation at chunk
    boundaries, and a NaN chunk aborting without the final save."""
    dev = str(resolve_device(device))
    iters = num_iterations or cfg.train.num_iterations
    log_every = log_every or cfg.train.eval_every
    state = create_train_state(cfg, num_steps=iters, device=dev)
    generator = torch.Generator().manual_seed(cfg.train.seed)
    step_fn = make_normals_train_step(cfg, generator)
    eval_fn = make_normals_eval_step(cfg, generator)

    ckpt = CheckpointManager(cfg.train.network_path, cfg.train.net_name)
    state, start_step = ckpt.restore(state)

    def bucketed(patches):
        return [pad_patch_to(p, bucket_size(p.num_nodes, bucket_align)) for p in patches]

    patches = bucketed(train_set.patches)
    valid_arrays = [patch_tensors(p, dev) for p in bucketed(valid_set.patches)] if (
        valid_set) else []

    def validate() -> float:
        return sum(float(eval_fn(state.params, *a)) for a in valid_arrays) / len(valid_arrays)

    rng = np.random.default_rng(cfg.train.seed)
    loss_hist: List[Tuple[float, float]] = []
    smooth_loss, smooth_n, last_valid = 0.0, 0, float("nan")
    poisoned = False
    t_start = time.time()
    if steps_per_call > 1:
        target = max(p.num_nodes for p in patches)
        scanned = make_scanned_train_step(
            state, cfg, stack_patch_tensors([pad_patch_to(p, target) for p in patches], dev),
            steps_per_call)

        def run_chunk(chunk):
            idxs = rng.integers(len(patches), size=steps_per_call)[:chunk]
            return scanned(state, normals_draws(cfg, generator, idxs, target))[1]

        def finish_chunk(it, chunk, losses):
            nonlocal last_valid
            avg = float(losses.numpy().mean())
            loss_hist.append((avg, last_valid))
            print(f"iter {it}: train loss {avg:.4f} ({(time.time() - t_start):.1f}s)")
            if not math.isfinite(avg):
                return False
            if _every(it, chunk, cfg.train.save_every):
                ckpt.save(start_step + it, state)
            if valid_arrays and _every(it, chunk, cfg.train.valid_every):
                last_valid = validate()
                print(f"iter {it}: validation loss {last_valid:.4f}")
            return True

        poisoned = not _chunk_loop(
            iters, steps_per_call, run_chunk, finish_chunk,
            [cfg.train.save_every] + ([cfg.train.valid_every] if valid_arrays else []))
    else:
        arrays = [patch_tensors(p, dev) for p in patches]
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
                    print(f"iter {it}: non-finite training loss — aborting at the next "
                          "checkpoint")
                poisoned = True
            smooth_loss += loss
            smooth_n += 1
            if it % log_every == 0:
                avg = smooth_loss / max(smooth_n, 1)
                print(f"iter {it}: train loss {avg:.4f} ({(time.time() - t_start):.1f}s)")
                loss_hist.append((avg, last_valid))
                smooth_loss, smooth_n = 0.0, 0
            if valid_arrays and it % cfg.train.valid_every == 0:
                last_valid = validate()
                print(f"iter {it}: validation loss {last_valid:.4f}")

    if poisoned:
        # a non-finite loss leaves the parameters poisoned: never persist them
        print("NaN training loss — aborted, the final state is not saved")
    else:
        ckpt.save(start_step + iters, state)
    ckpt.close()
    return state, _write_history(cfg, loss_hist)


# ---------------------------------------------------------------------------
# Streaming normals training from shards (JAX trainer.py:566-822): patches
# load lazily from npz shards, a loader thread builds their host tables, and
# the consumer copies them to the device and trains
# ---------------------------------------------------------------------------

MAX_PREPARED = 64        # patches kept prepared, on the host and on the device (JAX's max_prepared)


def _slot_dims(tensors) -> Tuple[Tuple[int, int], ...]:
    """Per level ``(K', K_t)``: the slot widths of a patch's train-step
    tensors ``(x, adjs, adj_ts, rows, gt)``."""
    return tuple((a.shape[0], t.shape[1]) for a, t in zip(tensors[1], tensors[2]))


def _pad_axis(t: torch.Tensor, size: int, dim: int) -> torch.Tensor:
    if t.shape[dim] == size:
        return t
    return torch.nn.functional.pad(t, [0, 0] * (t.dim() - 1 - dim) + [0, size - t.shape[dim]])


def _pad_to_dims(tensors, dims):
    """A patch's tensors zero-padded to the slot widths ``dims`` (JAX
    ``_pad_to_dims`` :598-609): ``adjs`` and ``rows`` on their slot axis,
    ``adj_ts`` on theirs. The extra slots are inert, as in
    :func:`stack_patch_tensors`."""
    x, adjs, adj_ts, rows, gt = tensors
    return (x, [_pad_axis(a, k, 0) for a, (k, _) in zip(adjs, dims)],
            [_pad_axis(a, kt, 1) for a, (_, kt) in zip(adj_ts, dims)],
            [_pad_axis(r, k + 1, 0) for r, (k, _) in zip(rows, dims)], gt)


class WindowBuffers:
    """A streaming window's static buffers on one device: a
    :class:`PatchStack` of up to ``window`` patches of one node count at the
    slot widths ``dims``, which :func:`make_scanned_train_step` reads
    through :meth:`select`. :meth:`load` writes a window's patches into
    them in place, so the addresses a captured graph reads stay put, and
    allocates them anew where the patches' shapes differ from theirs."""

    def __init__(self, window: int):
        self.window = window
        self.stack: Optional[PatchStack] = None
        self.dims: Tuple[Tuple[int, int], ...] = ()

    def load(self, patches: Sequence[tuple]) -> bool:
        """Write ``patches`` (tensors of :func:`patch_tensors`, one shape)
        into the first ``len(patches)`` slots; returns True where the
        buffers were allocated anew for their shape."""
        fields = [[p[0] for p in patches]]
        for part in (1, 2, 3):
            fields += [[p[part][lvl] for p in patches] for lvl in range(len(patches[0][part]))]
        fields.append([p[4] for p in patches])
        flat = [] if self.stack is None else [
            self.stack.xs, *self.stack.adjs, *self.stack.adj_ts, *self.stack.rows, self.stack.gts]
        fresh = [b.shape[1:] for b in flat] != [f[0].shape for f in fields]
        if fresh:
            flat = [f[0].new_zeros((self.window, *f[0].shape)) for f in fields]
            levels = len(patches[0][1])
            self.stack = PatchStack(flat[0], flat[1:1 + levels], flat[1 + levels:1 + 2 * levels],
                                    flat[1 + 2 * levels:1 + 3 * levels], flat[-1])
            self.dims = _slot_dims(patches[0])
        for buf, parts in zip(flat, fields):
            torch.stack(parts, out=buf[:len(parts)])
        return fresh

    def select(self, idx: torch.Tensor):
        return self.stack.select(idx)


class _Window(NamedTuple):
    """What the run measured of one window from the loader. It holds no
    tensor: the run keeps one a window until its end, and a device copy
    held here would outlive its eviction from the memo."""

    count: int                      # its steps
    wait_s: float                   # the consumer's wait on the loader for it
    prep_s: List[float]             # host preparation of each patch prepared anew
    first_epoch: bool
    h2d_bytes: int
    stage_s: float                  # the consumer's host time staging its uploads
    copy: Optional[tuple]           # (start, end) CUDA events around its uploads
    allocated: Optional[int]        # device bytes allocated once it was staged (card only)


def _aligned(nbytes: int) -> int:
    return -(-nbytes // 256) * 256


class _PatchMemo:
    """The device copies of prepared patches by global index, at most
    MAX_PREPARED, least recently used first out. On the card the consumer
    copies a window's new patches into one pinned staging buffer (allocated
    once, grown as needed, reused once the previous window's copies are
    done: a pinned allocation a tensor costs more than the copies) and from
    there to the device on a copy stream of its own (not the side stream of
    a capture's warm-up); :meth:`ready` makes the current stream wait for a
    window's copies. The loader thread makes no CUDA call."""

    def __init__(self, device: str):
        self.device = torch.device(device)
        self.on_card = self.device.type == "cuda"
        self.stream = torch.cuda.Stream(self.device) if self.on_card else None
        self.entries: "OrderedDict[int, tuple]" = OrderedDict()
        self._staging: Optional[torch.Tensor] = None
        self._last_copy: Optional[torch.cuda.Event] = None

    def _upload(self, fresh) -> Tuple[Dict[int, tuple], Optional[tuple]]:
        """Device tensors of ``fresh`` ``[(idx, host arrays)]``, and the
        (start, end) events around their copies on the card."""
        def flat(arrays):
            x, adjs, adj_ts, rows, gt = arrays
            return [x, *adjs, *adj_ts, *rows, gt]

        def nested(ts, levels):
            return (ts[0], ts[1:1 + levels], ts[1 + levels:1 + 2 * levels],
                    ts[1 + 2 * levels:1 + 3 * levels], ts[-1])

        if not self.on_card:
            return {idx: nested([torch.as_tensor(a) for a in flat(arrays)], len(arrays[1]))
                    for idx, arrays in fresh}, None
        parts = [(idx, [np.ascontiguousarray(a) for a in flat(arrays)], len(arrays[1]))
                 for idx, arrays in fresh]
        total = sum(_aligned(a.nbytes) for _, arrays, _ in parts for a in arrays)
        if self._last_copy is not None:
            self._last_copy.synchronize()          # the staging buffer is free again
        if self._staging is None or self._staging.numel() < total:
            self._staging = torch.empty(total, dtype=torch.uint8, pin_memory=True)
        staging = self._staging.numpy()
        offsets, off = [], 0
        for _, arrays, _ in parts:
            for a in arrays:
                staging[off:off + a.nbytes] = a.reshape(-1).view(np.uint8)
                offsets.append(off)
                off += _aligned(a.nbytes)
        main = torch.cuda.current_stream(self.device)
        events = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        out, k = {}, 0
        # the copy stream waits for nothing on the training stream: the copies
        # write new blocks of its own pool and overlap the running window
        with torch.cuda.stream(self.stream):
            events[0].record()
            for idx, arrays, levels in parts:
                ts = []
                for a in arrays:
                    src = self._staging[offsets[k]:offsets[k] + a.nbytes]
                    t = torch.empty(a.shape, dtype=torch.from_numpy(a[:0]).dtype,
                                    device=self.device)
                    t.copy_(src.view(t.dtype).view(a.shape), non_blocking=True)
                    t.record_stream(main)            # read on the training stream
                    ts.append(t)
                    k += 1
                out[idx] = nested(ts, levels)
            events[1].record()
        self._last_copy = events[1]
        return out, events

    def stage(self, items) -> Tuple[List[tuple], int, float, Optional[tuple]]:
        """The window's patches ``items`` ``[(idx, host arrays, prep_s)]``
        as device tensors, enqueueing the copies of those not held; returns
        ``(tensors, bytes copied, host seconds, (start, end) events or
        None)``."""
        t0 = time.perf_counter()
        fresh = {idx: arrays for idx, arrays, _ in items if idx not in self.entries}
        nbytes = sum(np.asarray(a).nbytes for x, adjs, adj_ts, rows, gt in fresh.values()
                     for a in (x, gt, *adjs, *adj_ts, *rows))
        events = None
        if fresh:
            uploaded, events = self._upload(list(fresh.items()))
            self.entries.update(uploaded)
        tensors = []
        for idx, _, _ in items:
            self.entries.move_to_end(idx)
            tensors.append(self.entries[idx])
        while len(self.entries) > MAX_PREPARED:
            self.entries.popitem(last=False)
        return tensors, nbytes, time.perf_counter() - t0, events

    def ready(self, window: _Window) -> None:
        if window.copy is not None:
            torch.cuda.current_stream(self.device).wait_event(window.copy[1])

    def padded(self, idx: int, tensors: tuple, dims) -> tuple:
        """``tensors`` of patch ``idx`` padded to ``dims``; the memo keeps
        the padded copy (a width growth pads the copies made before it once,
        as they are used again: JAX's ``version``, :641-661)."""
        if _slot_dims(tensors) == dims:
            return tensors
        tensors = _pad_to_dims(tensors, dims)
        if idx in self.entries:
            self.entries[idx] = tensors
        return tensors


class _PreparedView:
    """The shards as the trainer's loader sees them: a patch whose tables
    the loader holds prepared is not loaded from its shard again (JAX's
    loader decompresses it on every draw, and a shard that left the cache
    is read again for it)."""

    def __init__(self, ds: ShardedDataset, prepared: Mapping):
        self.ds, self.prepared = ds, prepared
        self.index = ds.index

    def patch(self, idx: int):
        return None if idx in self.prepared else self.ds.patch(idx)


def _windows(loader, memo: _PatchMemo, epoch: int):
    """The loader's windows ``(_Window, patch indices, device tensors)``,
    each staged on the device as it is taken: the uploads of a window are
    enqueued while the previous one trains."""
    drawn = 0
    while True:
        t0 = time.perf_counter()
        try:
            items, count = next(loader)
        except StopIteration:
            return
        wait_s = time.perf_counter() - t0
        tensors, nbytes, stage_s, events = memo.stage(items)
        allocated = torch.cuda.memory_allocated(memo.device) if memo.on_card else None
        yield (_Window(count, wait_s, [s for _, _, s in items if s is not None], drawn < epoch,
                       nbytes, stage_s, events, allocated),
               [idx for idx, _, _ in items], tensors)
        drawn += count


def _stream_summary(windows: List[_Window], starts: List[float], t_end: float,
                    steps_per_call: int, growths: int, captures: int) -> dict:
    """What the streaming run measured, split into the first epoch's windows
    and the later ones: the consumer's wait on the loader a window, the
    host preparation a patch prepared anew, the uploads, and each window's
    host time a step (from its start to the next one's: in a steady run the
    host waits there for the previous window's losses, so it follows the
    device)."""
    def mean(v):
        return float(np.mean(v)) if len(v) else None

    def median(v):
        return float(np.median(v)) if len(v) else None

    ends = starts[1:] + [t_end]
    step_ms = [1e3 * (e - s) / w.count for w, s, e in zip(windows, starts, ends)]
    prep = [s for w in windows for s in w.prep_s]
    uploads = [w for w in windows if w.copy is not None]
    split = {}
    for name, first in (("first_epoch", True), ("after", False)):
        part = [w for w in windows if w.first_epoch == first]
        split[name] = {"windows": len(part),
                       "loader_wait_s": mean([w.wait_s for w in part]),
                       "step_ms": median([ms for w, ms in zip(windows, step_ms)
                                          if w.first_epoch == first]),
                       "h2d_windows": sum(w.copy is not None for w in part),
                       # device bytes allocated at the part's first and last
                       # window and the most at any (the card only)
                       "allocated": [part[0].allocated, part[-1].allocated,
                                     max(w.allocated for w in part)] if (
                                         part and part[0].allocated is not None) else None}
    return {"steps_per_call": steps_per_call, "windows": len(windows), **split,
            "patches_prepared": len(prep), "prepare_s_per_patch": mean(prep),
            "h2d_windows": len(uploads),
            "h2d_bytes_per_window": mean([w.h2d_bytes for w in uploads]),
            "h2d_bytes_max": max([w.h2d_bytes for w in uploads], default=0),
            "h2d_stage_ms_per_window": mean([1e3 * w.stage_s for w in uploads]),
            "h2d_ms_per_window": mean([w.copy[0].elapsed_time(w.copy[1]) for w in uploads]),
            "growths": growths, "captures": captures}


def train_normals_streaming(
    cfg: Config,
    shard_dir: str,
    valid_set: Optional[MeshDataset] = None,
    num_iterations: Optional[int] = None,
    bucket_align: int = 1024,
    prefetch_depth: int = 2,
    steps_per_call: int = 1,
    device: str = "cuda",
) -> Tuple[TrainState, np.ndarray]:
    """Normals training from a sharded dataset (``data/stream.py``): the
    JAX package's ``train_normals_streaming`` (trainer.py:612-822), for a
    corpus larger than host memory (the reference unpickles the whole set,
    train.py:1901-1906). Patches load lazily from the shards; a loader
    thread draws them in the JAX loader's order for ``cfg.train.seed`` and
    builds their host tables (NumPy only, memoised by global index, at most
    MAX_PREPARED); the consumer copies each window's new patches to the
    device (pinned memory, a copy stream, enqueued while the previous window
    trains; at most MAX_PREPARED kept there) and trains on them. Resumes
    from the latest checkpoint, with the loader starting again from the
    seed; validates every ``valid_every``; checkpoints every ``save_every``;
    a history row at each ``it % eval_every < stride`` (the smoothed loss
    since the last row and the last validation loss; stride =
    ``steps_per_call``); a non-finite smoothed loss stops the run with no
    final save; the rows are appended to ``<network_path>/<net_name>.csv``.
    Runs on CUDA unless ``device="cpu"``. Prints a ``streaming summary:``
    JSON line of what it measured (:func:`_stream_summary`). Returns
    ``(state, history [rows, 2])``.

    ``steps_per_call == 1``: each patch padded to its own bucket and one
    eager :func:`make_normals_train_step` a patch. ``steps_per_call > 1``
    (JAX's windowed path, :566-609): every patch padded to one dataset-wide
    bucket, its slot widths padded to running maxima, and windows of
    ``steps_per_call`` patches copied into :class:`WindowBuffers` that one
    :func:`make_scanned_train_step` reads (on the card a CUDA graph replayed
    a step). A width growth allocates the buffers anew and the graph is
    captured again at the next call; the last window applies exactly its
    count of updates."""
    dev = str(resolve_device(device))
    iters = num_iterations or cfg.train.num_iterations
    state = create_train_state(cfg, num_steps=iters, device=dev)
    generator = torch.Generator().manual_seed(cfg.train.seed)
    step_fn = make_normals_train_step(cfg, generator)
    eval_fn = make_normals_eval_step(cfg, generator)
    ckpt = CheckpointManager(cfg.train.network_path, cfg.train.net_name)
    state, start_step = ckpt.restore(state)

    ds = ShardedDataset(shard_dir)
    windowed = steps_per_call > 1
    target = bucket_size(ds.max_num_nodes, bucket_align) if windowed else None
    prepared: "OrderedDict[int, tuple]" = OrderedDict()

    def prepare(patch, idx):
        # on the loader thread: NumPy only
        if idx in prepared:
            prepared.move_to_end(idx)
            return idx, prepared[idx], None
        t0 = time.perf_counter()
        prepared[idx] = patch_arrays(
            pad_patch_to(patch, target or bucket_size(patch.num_nodes, bucket_align)))
        while len(prepared) > MAX_PREPARED:
            prepared.popitem(last=False)
        return idx, prepared[idx], time.perf_counter() - t0

    valid_arrays = [patch_tensors(pad_patch_to(p, bucket_size(p.num_nodes, bucket_align)), dev)
                    for p in valid_set.patches] if valid_set is not None else []

    def validate() -> float:
        return sum(float(eval_fn(state.params, *a)) for a in valid_arrays) / len(valid_arrays)

    memo = _PatchMemo(dev)
    buffers = WindowBuffers(steps_per_call)
    graph = make_scanned_train_step(state, cfg, buffers, steps_per_call) if windowed else None
    growths = 0

    seen: List[_Window] = []
    starts: List[float] = []

    def run(chunk: int):
        """Take the loader's next window (``chunk`` steps) and enqueue its
        steps; returns a reader of their losses."""
        nonlocal growths
        window, idxs, tensors = next(windows)
        assert window.count == chunk, (window.count, chunk)
        starts.append(time.perf_counter())
        seen.append(window)
        memo.ready(window)
        if not windowed:
            _, loss = step_fn(state, *tensors[0])
            return lambda: np.array([float(loss)])
        dims = buffers.dims or _slot_dims(tensors[0])
        for t in tensors:
            dims = tuple((max(a, c), max(b, d)) for (a, b), (c, d) in zip(dims, _slot_dims(t)))
        first = buffers.stack is None
        if buffers.load([memo.padded(i, t, dims) for i, t in zip(idxs, tensors)]):
            if not first:
                growths += 1
                graph.release()          # captured again over the new buffers at this call
        _, losses = graph(state, normals_draws(cfg, generator, range(chunk), target))
        return losses.numpy

    stride = steps_per_call
    loss_hist: List[Tuple[float, float]] = []
    smooth_loss, smooth_n, last_valid = 0.0, 0, float("nan")
    t_start = time.time()

    def finish(it: int, count: int, read) -> bool:
        """Take in a window's losses after ``it`` steps (JAX's loop body
        :781-803); False to abort."""
        nonlocal smooth_loss, smooth_n, last_valid
        smooth_loss += float(read().sum())
        smooth_n += count
        if valid_arrays and it % cfg.train.valid_every < stride:
            last_valid = validate()
            print(f"iter {it}: validation loss {last_valid:.4f}")
        if it % cfg.train.eval_every < stride:
            avg = smooth_loss / max(smooth_n, 1)
            loss_hist.append((avg, last_valid))
            print(f"iter {it}: train loss {avg:.4f} ({time.time() - t_start:.1f}s)")
            if not math.isfinite(avg):
                print("NaN training loss — aborting; the state is not saved")
                return False
            smooth_loss, smooth_n = 0.0, 0
        if it > 0 and it % cfg.train.save_every < stride:
            ckpt.save(start_step + it, state)
        return True

    loader = PrefetchLoader(_PreparedView(ds, prepared), prepare, seed=cfg.train.seed,
                            depth=prefetch_depth, num_items=iters, window=steps_per_call)
    windows = _windows(loader, memo, len(ds))
    try:
        aborted = not _chunk_loop(
            iters, steps_per_call, run, finish,
            [cfg.train.save_every] + ([cfg.train.valid_every] if valid_arrays else []))
    finally:
        loader.close()
    if memo.on_card:
        torch.cuda.synchronize(memo.device)
    summary = _stream_summary(seen, starts, time.perf_counter(), steps_per_call, growths,
                              graph.captures if graph is not None else 0)
    print("streaming summary: " + json.dumps(summary))
    if not aborted:
        ckpt.save(start_step + iters, state)
    ckpt.close()
    return state, _write_history(cfg, loss_hist)


# ---------------------------------------------------------------------------
# Vertex training (reference trainAccuracyNet): the three-head forward, the
# multi-scale vertex solver and the sampled chamfer loss against the GT
# points, optionally plus the angular loss of the fine head
# ---------------------------------------------------------------------------

class VertexTensors(NamedTuple):
    """A vertex patch's train-step inputs on one device."""

    x: torch.Tensor                  # [N, 6] inputs
    adjs: List[torch.Tensor]         # kernel tables of train_graph_tensors
    adj_ts: List[torch.Tensor]
    rows: List[torch.Tensor]
    vertices: torch.Tensor           # [V, 3] noisy, the solver's start
    gt_vertices: torch.Tensor        # [V_gt, 3]
    faces: torch.Tensor              # [N, 3], −1 rows for fake faces
    v_faces: torch.Tensor            # [V, k_vertices], −1 padded
    gt_normals: Optional[torch.Tensor]
    tables: Optional[tuple]          # the operator solver's, None for the naive one
    naive_maps: Optional[NaiveMaps] = None   # the naive solver's, None for the operator


def vertex_patch_tensors(cfg: Config, patch: FacetPatch, device: str) -> VertexTensors:
    """:class:`VertexTensors` of one vertex patch, built once before the
    loop: the U-Net's kernel tables and, under ``vertex_solver="operator"``,
    the solver's tables of ``build_solver_tables(..., faces=...)`` (the JAX
    package's ``_solver_tables``), or under ``"naive"`` the maps of the
    scale kernel's adjoint (``build_naive_maps``)."""
    if cfg.eval.vertex_solver not in ("operator", "naive"):
        raise ValueError(f"unknown vertex_solver {cfg.eval.vertex_solver!r} "
                         "(use 'operator' or 'naive')")

    def tensor(a):
        return None if a is None else torch.as_tensor(a, device=device)

    with span("fgc.prep.upload"):
        adjs, adj_ts, rows = train_graph_tensors(patch.adjs, device)
        return VertexTensors(
            tensor(patch.inputs), adjs, adj_ts, rows, tensor(patch.vertices),
            tensor(patch.gt_vertices), tensor(patch.faces), tensor(patch.v_faces),
            tensor(patch.gt_normals),
            solver_tables(cfg, patch, device) if cfg.eval.vertex_solver == "operator" else None,
            build_naive_maps(patch.faces, patch.v_faces, cfg.model.coarsening_levels,
                             cfg.model.coarsening_steps, device)
            if cfg.eval.vertex_solver == "naive" else None)


def vertex_loss(params, cfg: Config, t: VertexTensors, rot: torch.Tensor,
                idx0: torch.Tensor, idx1: torch.Tensor,
                normals_weight: float = 0.0) -> torch.Tensor:
    """The vertex step's loss (the JAX ``make_vertex_train_step``'s
    ``_loss``): rotate the inputs, the vertices and the GT vertices by
    ``rot``; the three heads, each normalized; the solver from the rotated
    vertices (the operator form when ``t.tables`` is given, else the naive
    form); ``full_chamfer_loss`` of the solved points at ``idx0`` against
    the GT points at ``idx1``; plus ``normals_weight`` × the angular loss of
    the fine head against the rotated GT normals, when both are there. The
    solver sits between the device marks ``solver_begin`` / ``solver_end``
    and, in the backward, ``solver_bwd_begin`` / ``solver_bwd_end``
    (``utils/profiling.py::mark_grad``)."""
    kw = dict(coarsening_steps=cfg.model.coarsening_steps,
              iter_nums=cfg.eval.ms_solver_iterations, checkpoint=cfg.eval.solver_remat)
    heads = unet_apply(params, rotate_inputs(rot, t.x), t.adjs, t.rows,
                       coarsening_steps=cfg.model.coarsening_steps, alpha=cfg.model.lrelu_alpha,
                       variant=_config_variant(cfg), adj_ts=t.adj_ts, multi_scale=True)
    normals = [normalize_tensor(h) for h in heads]
    vertices = rotate_vec3(rot, t.vertices)
    solver_normals = list(mark_grad(normals, "solver_begin", "solver_bwd_end"))
    if t.tables is not None:
        refined, _ = update_positions_multiscale_operator(
            vertices, solver_normals, t.faces, t.v_faces, t.tables, **kw)
    else:
        refined, _ = update_positions_multiscale(vertices, solver_normals, t.faces, t.v_faces,
                                                 maps=t.naive_maps, **kw)
    (refined,) = mark_grad([refined], "solver_end", "solver_bwd_begin")
    loss = full_chamfer_loss(refined, rotate_vec3(rot, t.gt_vertices), idx0, idx1)
    if normals_weight > 0 and t.gt_normals is not None:
        loss = loss + normals_weight * face_normals_loss(normals[0],
                                                         rotate_vec3(rot, t.gt_normals))
    return loss


def make_vertex_train_step(cfg: Config, normals_weight: float = 0.0,
                           generator: Optional[torch.Generator] = None):
    """The step ``(state, tensors, rot=None, idx0=None, idx1=None) → (state,
    loss)`` over :class:`VertexTensors`. It updates ``state`` in place and
    returns it with the loss (a 0-d tensor, before the update). What is not
    given is drawn from ``generator`` (a host generator, default seeded with
    ``cfg.train.seed``) in the JAX step's order (trainer.py:868-874): the
    rotation [3, 3], then ``chamfer_samples`` indices into the vertices and
    as many into the GT vertices. ``normals_weight > 0`` adds the angular
    term (the reference's double-loss trainer, train.py:919-1267).

    ``step.eval(params, tensors, rot=None, idx0=None, idx1=None)`` is the
    same loss under ``torch.no_grad()``, with no backward (the reference's
    validation loss, train.py:859-888).

    ``step.draw(tensors, count)`` draws ``count`` steps' values on the host,
    in the order as many steps draw them, and ``step.scanned(state, tensors,
    steps_per_call)`` is a :class:`GraphStep` of this step on one patch (the
    JAX step's ``scanned``, trainer.py:921-933): ``(state,
    step.draw(tensors, N)) → (state, losses)``."""
    generator = _default_generator(cfg, generator)
    samples = cfg.train.chamfer_samples

    def draws(t: VertexTensors, rot, idx0, idx1):
        if rot is None:
            rot = random_rotation(generator)
        if idx0 is None:
            idx0 = torch.randint(0, t.vertices.shape[0], (samples,), generator=generator)
        if idx1 is None:
            idx1 = torch.randint(0, t.gt_vertices.shape[0], (samples,), generator=generator)
        dev = t.x.device
        return rot.to(dev), idx0.to(dev), idx1.to(dev)

    def step(state: TrainState, tensors: VertexTensors, rot=None, idx0=None, idx1=None):
        loss = vertex_loss(state.params, cfg, tensors, *draws(tensors, rot, idx0, idx1),
                           normals_weight)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        return adam_update(state), loss.detach()

    def eval_loss(params, tensors: VertexTensors, rot=None, idx0=None, idx1=None):
        with torch.no_grad():
            return vertex_loss(params, cfg, tensors, *draws(tensors, rot, idx0, idx1),
                               normals_weight)

    def draw(tensors: VertexTensors, count: int) -> Dict[str, torch.Tensor]:
        rows = [[random_rotation(generator),
                 torch.randint(0, tensors.vertices.shape[0], (samples,), generator=generator),
                 torch.randint(0, tensors.gt_vertices.shape[0], (samples,), generator=generator)]
                for _ in range(count)]
        return {name: torch.stack(col) for name, col in zip(("rot", "idx0", "idx1"), zip(*rows))}

    def scanned(state: TrainState, tensors: VertexTensors, steps_per_call: int) -> GraphStep:
        def loss_fn(params, rot, idx0, idx1):
            return vertex_loss(params, cfg, tensors, rot, idx0, idx1, normals_weight)

        return GraphStep(state, loss_fn, steps_per_call)

    step.eval = eval_loss
    step.draw = draw
    step.scanned = scanned
    return step


def train_with_vertices(
    cfg: Config,
    train_set: MeshDataset,
    valid_set: Optional[MeshDataset] = None,
    num_iterations: Optional[int] = None,
    normals_weight: float = 0.0,
    steps_per_call: int = 1,
    log_every: int = 10,
    device: str = "cuda",
    graph_cache: Optional[GraphCache] = None,
) -> Tuple[TrainState, np.ndarray]:
    """End-to-end vertex training (reference ``trainAccuracyNet``,
    train.py:636-914): the gradients flow from the chamfer loss through the
    120-iteration vertex solver into the U-Net. A random patch per step (the
    JAX package's sequence), each patch's tensors and solver tables built
    once before the loop, an eval-only validation sweep every
    ``valid_every`` steps, a checkpoint every ``min(save_every, 500)``
    steps (the reference's 500) and a resume from the latest, an abort at
    the first non-finite loss without a final save of the poisoned state,
    and the loss history (a row a step: the loss and the last validation
    loss) appended to ``<network_path>/<net_name>.csv``. Runs on CUDA unless
    ``device="cpu"``, under either solver: on the card the naive one runs
    the scale kernel forward and its adjoint kernel backward. Returns
    ``(state, history [rows, 2])``.

    ``steps_per_call > 1`` runs the JAX package's chunk loop (trainer.py:
    1017-1043): one ``rng.integers(num_patches)`` a chunk pins its patch
    (vertex patches differ in V and faces, so they are not stacked), the
    chunk runs through that patch's ``step.scanned`` (on the card a CUDA
    graph a patch, captured at its first use, each graph in its own memory
    pool), a shorter last chunk, a history row a chunk (its mean loss), and
    validation, checkpoints and the NaN abort at chunk boundaries. The
    patches' graphs are held by ``graph_cache`` (default: a
    :class:`..graph_step.GraphCache` held to half the card's free memory at
    the start; on the CPU it holds every patch): past its budget it releases
    the least recently used graphs, and a released patch is captured again
    at its next chunk."""
    dev = resolve_device(device)
    if graph_cache is None:
        graph_cache = GraphCache(default_graph_budget(dev))
    dev = str(dev)
    iters = num_iterations or cfg.train.num_iterations
    state = create_train_state(cfg, num_steps=iters, device=dev, multi_scale=True)
    step_fn = make_vertex_train_step(cfg, normals_weight,
                                     torch.Generator().manual_seed(cfg.train.seed))

    ckpt = CheckpointManager(cfg.train.network_path, cfg.train.net_name)
    state, start_step = ckpt.restore(state)
    arrays = [vertex_patch_tensors(cfg, p, dev) for p in train_set.patches]
    valid_arrays = [vertex_patch_tensors(cfg, p, dev) for p in valid_set.patches] if (
        valid_set is not None) else []

    def validate() -> float:
        return sum(float(step_fn.eval(state.params, a)) for a in valid_arrays) / len(valid_arrays)

    rng = np.random.default_rng(cfg.train.seed)
    loss_hist: List[Tuple[float, float]] = []
    last_valid = float("nan")
    aborted = False
    t_start = time.time()
    save_every = min(cfg.train.save_every, 500)

    def run_chunk(chunk):
        idx = int(rng.integers(len(arrays)))
        graph = graph_cache.get(idx, lambda: step_fn.scanned(state, arrays[idx], steps_per_call))
        captured = graph.graph is None
        _, losses = graph(state, step_fn.draw(arrays[idx], chunk))
        if captured and graph.capture_s is not None:
            print(f"patch {idx}: step graph captured in {graph.capture_s:.3f} s, "
                  f"{graph.graph_bytes / 2**20:.1f} MiB ({graph_cache.captures} captures, "
                  f"{graph_cache.evictions} evictions so far)")
        return losses

    def finish_chunk(it, chunk, losses):
        nonlocal last_valid
        avg = float(losses.numpy().mean())
        if valid_arrays and _every(it, chunk, cfg.train.valid_every):
            last_valid = validate()
            print(f"iter {it}: validation loss {last_valid:.4f}")
        loss_hist.append((avg, last_valid))
        print(f"iter {it}: vertex loss {avg:.4f} ({time.time() - t_start:.1f}s)")
        if not math.isfinite(avg):
            print("NaN training loss — aborting; the state is not saved")
            return False
        if _every(it, chunk, save_every):
            ckpt.save(start_step + it, state)
        return True

    if steps_per_call > 1:
        aborted = not _chunk_loop(
            iters, steps_per_call, run_chunk, finish_chunk,
            [save_every] + ([cfg.train.valid_every] if valid_arrays else []))
        if graph_cache.budget_bytes is not None:
            graph_cache.observe()
            print(f"step graphs: {graph_cache.captures} captures, {graph_cache.evictions} "
                  f"evictions, {graph_cache.switches} switches, at most "
                  f"{graph_cache.peak_held / 2**20:.1f} MiB held of a "
                  f"{graph_cache.budget_bytes / 2**20:.1f} MiB budget")
    else:
        for it in range(iters):
            if it > 0 and it % save_every == 0:
                ckpt.save(start_step + it, state)
            state, loss = step_fn(state, arrays[int(rng.integers(len(arrays)))])
            loss = float(loss)
            if valid_arrays and it % cfg.train.valid_every == 0:
                last_valid = validate()
                print(f"iter {it}: validation loss {last_valid:.4f}")
            loss_hist.append((loss, last_valid))
            if it % log_every == 0:
                print(f"iter {it}: loss {loss:.4f} ({time.time() - t_start:.1f}s)")
            if not math.isfinite(loss):
                # the update just applied is poisoned: never persist it
                print("NaN training loss — aborting; the state is not saved")
                aborted = True
                break

    if not aborted:
        ckpt.save(start_step + iters, state)
    ckpt.close()
    return state, _write_history(cfg, loss_hist)
