"""Configuration for the PyTorch port.

The port's own copy of ``facet_graph_convolution_tpu/config.py``: the same
frozen dataclasses, defaults and CLI overrides (reference ``settings.py``),
except that ``--device`` names a torch device (:func:`parse_device`) instead
of selecting a JAX platform.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
from dataclasses import dataclass, field
from typing import Optional


@dataclass(frozen=True)
class DataConfig:
    """Data layout + patching parameters (reference ``settings.py:18-24``)."""

    base_path: str = "./"
    data_path: str = ""            # derived: base_path + "Data/"
    training_data_path: str = ""   # noisy training meshes
    valid_data_path: str = ""      # noisy validation meshes
    test_data_path: str = ""       # noisy test meshes (inference default input)
    gt_data_path: str = ""         # ground-truth meshes
    test_gt_data_path: str = ""    # ground-truth test meshes
    binary_dump_path: str = ""     # preprocessed dataset dump

    # A mesh larger than max_patch_size faces is split into BFS patches
    # (reference settings.py:20). Patches are grown to at least min_patch_size
    # for inference receptive field (settings.py:22).
    max_patch_size: int = 20000
    min_patch_size: int = 2000
    # Max facet-graph neighbours per face, slot 0 = self (settings.py:23).
    k_faces: int = 23
    # Max faces incident to a vertex in v_faces maps (dataClasses.py:351,428).
    k_vertices: int = 25
    # Max edges per vertex in the edge map (dataClasses.py:40).
    max_edges: int = 20
    # Each mesh is added this many times during preprocessing; randomness in
    # patch cut + coarsening gives augmentation (settings.py:24).
    training_data_redundancy: int = 1

    def __post_init__(self):
        base = self.base_path if self.base_path.endswith("/") else self.base_path + "/"
        object.__setattr__(self, "base_path", base)
        defaults = {
            "data_path": base + "Data/",
            "training_data_path": base + "Data/Synthetic/train/noisy/",
            "valid_data_path": base + "Data/Synthetic/train/valid/",
            "test_data_path": base + "Data/DemoData/",
            "gt_data_path": base + "Data/Synthetic/train/original/",
            "test_gt_data_path": base + "Data/Synthetic/test/original/",
            "binary_dump_path": base + "Preprocessed_Data/",
        }
        for name, value in defaults.items():
            if not getattr(self, name):
                object.__setattr__(self, name, value)


@dataclass(frozen=True)
class ModelConfig:
    """Network architecture parameters (reference ``settings.py:27-33`` and
    hard-coded constants in ``model.py:837-946``)."""

    # Coarsening iterations per pooling layer (settings.py:31).
    coarsening_steps: int = 2
    # Number of resolution levels in the U-Net pyramid (settings.py:32).
    coarsening_levels: int = 3
    # Number of assignment filters M per conv (model.py:855,868,880).
    num_filters: int = 9
    # Channel widths per level (model.py:856,869,881).
    channels: tuple = (32, 64, 128)
    # Hidden width of the output MLP (model.py:937).
    fc_channels: int = 1024
    out_channels: int = 3
    # Leaky-ReLU slope (model.py:846).
    lrelu_alpha: float = 0.1
    # Weight init stddevs (model.py:17-18).
    std_dev: float = 0.05
    std_dev_bias: float = 0.01
    # Include vertex pipeline (multi-scale heads + vertex solver in training;
    # settings.py:29).
    include_vertices: bool = False
    # Invariance flags — reference defaults are both False (model.py:841-842);
    # resolved to the conv variant by the trainers.
    translation_invariance: bool = False
    rotation_invariance: bool = False
    # Compute dtype for conv/matmul interiors. Params stay float32.
    compute_dtype: str = "float32"


@dataclass(frozen=True)
class TrainConfig:
    """Training-loop parameters (reference ``settings.py:30-33``,
    ``train.py:380-632``)."""

    num_iterations: int = 300000
    save_every: int = 5000          # SAVEITER (settings.py:30)
    eval_every: int = 50            # smoothed train loss period (train.py:544)
    valid_every: int = 100          # validation sweep period (train.py:590)
    loss_samples: int = 4000        # random faces sampled for loss (train.py:415)
    chamfer_samples: int = 500      # sampled points for chamfer loss (train.py:783)
    learning_rate: float = 1e-3     # Adam default (train.py:520 uses TF default)
    # LR schedule (TPU addition; the reference runs constant-LR Adam for
    # 300k iterations, train.py:520 + settings.py:33). "cosine" = linear
    # warmup over lr_warmup_steps then cosine decay to
    # lr_min_ratio × learning_rate across the training loop's iteration budget —
    # short synthetic runs converge much further than constant LR allows.
    lr_schedule: str = "constant"   # "constant" | "cosine"
    lr_warmup_steps: int = 200
    lr_min_ratio: float = 0.01
    # NOTE: the reference feeds keep_prob=0.8 in the withVerts trainer
    # (train.py:812) but get_model_reg_multi_scale never applies dropout —
    # the knob is dead there and intentionally unimplemented here.
    dropout_keep_prob: float = 0.8
    augment_rotations: bool = True  # per-iteration random rotation (train.py:436)
    seed: int = 0
    network_path: str = "Networks/Default/"
    net_name: str = "net"
    # Number of data-parallel patch replicas per step (TPU addition; the
    # reference is locked to batch 1, train.py:405). Consumed by
    # parallel.data_parallel.train_normals_dp; the single-device trainer
    # ignores it.
    batch_patches: int = 1


@dataclass(frozen=True)
class EvalConfig:
    """Inference/metrics parameters (``settings.py:36-39``)."""

    results_path: str = "Results/Default/"
    overwrite_results: bool = False     # B_OVERWRITE_RESULT (settings.py:36)
    heatmap_max_angle: float = 30.0     # settings.py:39
    solver_iterations: int = 60         # update_position2 iters (train.py:130)
    # Edge-map solver schedule/step at inference (round-5; reference
    # train.py:130 runs a FIXED 60 iterations at a GLOBAL λ=1/18):
    # - solver_adaptive_tol > 0 stops at the residual plateau under the
    #   solver_iterations budget, curing the low-noise over-integration
    #   (refined worse than noisy in Hausdorff — BASELINE.md round 4);
    # - solver_lambda "degree" uses the per-vertex 1/(3·deg) step the
    #   reference's 1/18 implicitly assumes at valence 6 — the global step
    #   DIVERGES on high-valence vertices (measured: residual ×1e6-1e13
    #   over 60 iterations on cylinder-on-plate). "reference" restores the
    #   exact reference behavior.
    solver_adaptive_tol: float = 0.01
    solver_lambda: str = "degree"
    # - solver_trust caps each vertex's total displacement at
    #   trust × its initial RMS constraint violation (a noise-amplitude
    #   estimate): the defense against biased (crease-rounded) predicted
    #   normals, where the residual never plateaus and the reference's
    #   fixed schedule makes near-clean inputs WORSE in Hausdorff
    #   (measured; BASELINE.md round 5). 0 disables.
    solver_trust: float = 0.75
    # multi-scale solver schedule, coarse→fine is reversed internally
    # (train.py:248 uses [80, 20, 20]).
    ms_solver_iterations: tuple = (80, 20, 20)
    # Multi-scale solver implementation: "operator" (deduped linear-operator
    # body, scatter-free both directions — exact to fp reassociation, see
    # ops.vertex_update.update_positions_multiscale_operator) or "naive"
    # (per-slot body mirroring the reference's formulation).
    vertex_solver: str = "operator"
    # Rematerialize the multi-scale solver loop body (either implementation)
    # under grad. OFF by default:
    # jax.checkpoint around the 120-iteration body triggers a deterministic
    # XLA miscompile (all-NaN grads from provably finite inputs) at
    # reference scale on BOTH backends — prevent_cse=False cures CPU but not
    # TPU; dropping remat cures both (tools/repro_vertex_nan.py, BASELINE.md
    # round 4). Without remat the saved per-iteration residuals are ~300 MB
    # at 25k nodes — fine single-chip; flip on only for huge single-chip
    # meshes, and watch for NaN-abort (the chamfer thresholds are
    # NaN-transparent so poisoning aborts loudly).
    solver_remat: bool = False


@dataclass(frozen=True)
class MeshShardConfig:
    """Multi-chip execution parameters (new; no reference equivalent —
    SURVEY.md §2.7: the reference has no parallelism)."""

    data_axis: str = "data"
    graph_axis: str = "graph"
    # Pad partition boundaries to multiples of this so every coarsening level
    # stays aligned with the binary-tree pooling (4**(levels-1) for 2-step
    # pooling × 3 levels = 16).
    partition_align: int = 16


@dataclass(frozen=True)
class Config:
    data: DataConfig = field(default_factory=DataConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    eval: EvalConfig = field(default_factory=EvalConfig)
    shard: MeshShardConfig = field(default_factory=MeshShardConfig)

    def replace(self, **sections) -> "Config":
        """Return a new Config with replaced section fields.

        ``cfg.replace(train={"num_iterations": 10})`` replaces fields inside
        the ``train`` section.
        """
        updates = {}
        for name, value in sections.items():
            section = getattr(self, name)
            if isinstance(value, dict):
                updates[name] = dataclasses.replace(section, **value)
            else:
                updates[name] = value
        return dataclasses.replace(self, **updates)


def default_config(base_path: Optional[str] = None) -> Config:
    if base_path is None:
        base_path = os.environ.get("FGC_BASE_PATH", "./")
    return Config(data=DataConfig(base_path=base_path))


# ---------------------------------------------------------------------------
# Ground-truth filename mapping (reference ``settings.py:44-52``): the Wang
# et al. dataset convention names noisy meshes "<name>_nX.obj" for GT
# "<name>.obj".
# ---------------------------------------------------------------------------

def gt_filename(noisy_filename: str, suffix_len: int = 7) -> str:
    """Map a noisy mesh filename to its ground-truth filename by stripping the
    noise suffix (reference ``getGTFilename``, settings.py:44-47)."""
    return noisy_filename[:-suffix_len] + ".obj"


def gt_filename_from_denoised(denoised_filename: str, suffix_len: int = 21) -> str:
    """Reference ``getGTFilenameFromDenoised`` (settings.py:49-52)."""
    return denoised_filename[:-suffix_len] + ".obj"


# ---------------------------------------------------------------------------
# CLI overrides (reference ``train.py:1946-1976`` / ``infer.py:130-160``).
# ---------------------------------------------------------------------------

def add_cli_overrides(parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
    parser.add_argument("--base_path", type=str, default=None)
    parser.add_argument("--results_path", type=str, default=None)
    parser.add_argument("--network_path", type=str, default=None)
    parser.add_argument("--num_iterations", type=int, default=None)
    parser.add_argument("--net_name", type=str, default=None)
    parser.add_argument("--coarsening_steps", type=int, default=None)
    parser.add_argument("--input_dir", type=str, default=None)
    parser.add_argument("--include_vertices", action="store_true", default=None)
    # reference-parity flags (train.py:1949-1951): --device selects the torch
    # device ("cuda"/"cpu"; the reference's "/gpu:0"-style strings map to
    # "cuda:0", see parse_device);
    # --running_mode is accepted and ignored like the reference (parsed at
    # train.py:1951, never branched on — mainFunction ignores it).
    parser.add_argument("--device", type=str, default=None)
    parser.add_argument("--running_mode", type=int, default=0)
    # round-5 inference-solver knobs (EvalConfig); --solver_lambda
    # "reference" + --solver_adaptive_tol 0 + --solver_trust 0 restore the
    # reference's exact fixed 60-iteration λ=1/18 behavior
    parser.add_argument("--solver_iterations", type=int, default=None)
    parser.add_argument("--solver_lambda", type=str, default=None,
                        choices=("degree", "reference"))
    parser.add_argument("--solver_adaptive_tol", type=float, default=None)
    parser.add_argument("--solver_trust", type=float, default=None)
    # the multi-scale vertex solver of the vertex pipeline (EvalConfig.
    # vertex_solver), for serving and for training with --include_vertices
    parser.add_argument("--vertex_solver", type=str, default=None,
                        choices=("operator", "naive"))
    return parser


def parse_device(arg: Optional[str]) -> str:
    """Torch device string for ``--device``: ``cuda`` when unset; accepts
    ``cpu``, ``cuda``, ``cuda:N`` and the reference's ``/gpu:N`` style."""
    if not arg:
        return "cuda"
    name, _, index = arg.strip("/").partition(":")
    if name == "gpu":
        name = "cuda"
    if name not in ("cpu", "cuda"):
        raise ValueError(f"unknown device {arg!r} (use cpu, cuda or cuda:N)")
    return f"{name}:{index}" if index and name == "cuda" else name


def resolve_device(device: str):
    """``device`` as a torch device; raises for CUDA when no card is present
    (the entry points never fall back to the CPU on their own)."""
    import torch

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but no CUDA device is available; "
            "pass device='cpu' (or --device cpu) to run on the CPU")
    return dev


def config_from_args(args: argparse.Namespace) -> Config:
    cfg = default_config(args.base_path)
    train_updates, eval_updates, model_updates = {}, {}, {}
    if getattr(args, "results_path", None):
        path = args.results_path
        eval_updates["results_path"] = path if path.endswith("/") else path + "/"
    if getattr(args, "network_path", None):
        path = args.network_path
        train_updates["network_path"] = path if path.endswith("/") else path + "/"
    if getattr(args, "num_iterations", None) is not None:
        train_updates["num_iterations"] = args.num_iterations
    if getattr(args, "net_name", None):
        train_updates["net_name"] = args.net_name
    if getattr(args, "coarsening_steps", None) is not None:
        model_updates["coarsening_steps"] = args.coarsening_steps
    if getattr(args, "include_vertices", None):
        model_updates["include_vertices"] = True
    if getattr(args, "solver_iterations", None) is not None:
        eval_updates["solver_iterations"] = args.solver_iterations
    if getattr(args, "solver_lambda", None):
        eval_updates["solver_lambda"] = args.solver_lambda
    if getattr(args, "solver_adaptive_tol", None) is not None:
        eval_updates["solver_adaptive_tol"] = args.solver_adaptive_tol
    if getattr(args, "solver_trust", None) is not None:
        eval_updates["solver_trust"] = args.solver_trust
    if getattr(args, "vertex_solver", None):
        eval_updates["vertex_solver"] = args.vertex_solver
    sections = {}
    if train_updates:
        sections["train"] = train_updates
    if eval_updates:
        sections["eval"] = eval_updates
    if model_updates:
        sections["model"] = model_updates
    return cfg.replace(**sections) if sections else cfg
