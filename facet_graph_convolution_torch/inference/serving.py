"""Serving: batched multi-mesh inference and the exported forward (the
port's counterpart of ``facet_graph_convolution_tpu/inference/serving.py``).

- :class:`InferenceServer` holds one set of parameters and a cache of
  batched forwards, one per (batch, tables' shapes). Every patch of every
  request is padded to one node bucket, and the B patches run as ONE forward
  over the block-diagonal graph of their tables
  (:func:`..models.unet.batched_graph_tensors`): one K1 launch a conv for
  the whole batch. On the card each cache entry is a CUDA graph of that
  forward over static input buffers, captured at the key's first request;
  every request (the first included) copies its tables and inputs in and
  replays it, so K1 launches 8 times a request. The server runs its forward
  once eagerly when it starts, on a one-patch batch of 16 nodes: the lazy
  state a capture must not meet (cuBLAS, K1's library) is made there, and
  no capture needs an eager run of its own. The cache drops the least
  recently used entries past ``max_compiled`` entries or past its byte
  budget (``training.graph_step.GraphCache``). On the CPU an entry holds no
  graph and the forward runs eagerly.
- :func:`export_forward` writes the batched forward as a ``torch.export``
  program; :func:`load_forward` (in :mod:`.exported`, which imports no model
  code) runs it.
"""

from __future__ import annotations

import time
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from facet_graph_convolution_torch.config import Config, default_config, resolve_device
from facet_graph_convolution_torch.data.dataset import InferenceMesh, bucket_size, pad_patch_to
from facet_graph_convolution_torch.geometry.mesh_math import normalize_rows
from facet_graph_convolution_torch.inference.driver import (
    _require_default_conv1,
    _require_heads,
    _restore_params,
    solve_patch,
    solve_vertices,
)
from facet_graph_convolution_torch.inference.exported import (  # noqa: F401  (the API)
    load_exported,
    load_forward,
    program_bytes,
    save_exported,
)
from facet_graph_convolution_torch.models.unet import batched_graph_tensors, unet_apply
from facet_graph_convolution_torch.ops.normalization import normalize_tensor
from facet_graph_convolution_torch.ops.pooling import tree_unpool
from facet_graph_convolution_torch.training.graph_step import (
    CapturedGraph,
    GraphCache,
    default_graph_budget,
)


def _build_mesh(vertices: np.ndarray, faces: np.ndarray, cfg: Config,
                seed: int = 0, with_vertices: bool = False) -> InferenceMesh:
    # a fixed coarsening seed keeps serving deterministic: Graclus matching
    # is randomized (lib/coarsening.py:57,96) and an unseeded build gives
    # another pyramid, and another answer, for each request
    mesh = InferenceMesh(
        max_patch_size=cfg.data.max_patch_size,
        coarsening_steps=cfg.model.coarsening_steps,
        coarsening_levels=cfg.model.coarsening_levels,
        k_faces=cfg.data.k_faces,
        min_patch_size=cfg.data.min_patch_size,
        seed=seed,
    )
    if with_vertices:
        mesh.add_mesh_with_vertices(vertices, faces)
    else:
        mesh.add_mesh(vertices, faces)
    return mesh


def batched_forward(params, x: torch.Tensor, adjs, rows, coarsening_steps: int = 2,
                    alpha: float = 0.1, multi_scale: bool = False):
    """The forward of B patches of one bucket, ``x`` [B, N, C], over their
    block-diagonal tables (``adjs``, ``rows``: :func:`..models.unet.
    batched_graph_tensors`): ``[B, N, 3]`` normals, or with ``multi_scale``
    the three heads ``[B, N/4^l, 3]``, each patch's normalized on its own
    (the reference's global prescale is per patch, as under the JAX
    server's ``vmap``)."""
    batch = x.shape[0]
    y = unet_apply(params, x.reshape(-1, x.shape[-1]), adjs, rows,
                   coarsening_steps=coarsening_steps, alpha=alpha, multi_scale=multi_scale)
    heads = tuple(torch.stack([normalize_tensor(h) for h in head.reshape(batch, -1, 3)])
                  for head in (y if multi_scale else (y,)))
    return heads if multi_scale else heads[0]


class BatchedForward(CapturedGraph):
    """One cache entry: ``fn(x, adjs, rows) → outputs`` at one (batch,
    tables' shapes). On the card the first call copies its inputs into
    static device buffers and captures ``fn`` (with no eager run: the caller
    has run ``fn``'s code before); every call, the first included, copies
    its inputs in and replays the graph, so two calls on the same inputs
    give the same bits. On the CPU it calls ``fn``."""

    def __init__(self, fn: Callable, device: torch.device):
        super().__init__(device)
        self.fn = fn
        self.inputs: Optional[List[torch.Tensor]] = None
        self.outputs = None
        self._levels = 0

    def _run(self) -> None:
        x, rest = self.inputs[0], self.inputs[1:]
        self.outputs = self.fn(x, rest[:self._levels], rest[self._levels:])

    def release(self) -> None:
        super().release()
        # the buffers and outputs of a capture keep its pool alive
        self.inputs = self.outputs = None

    def __call__(self, x: torch.Tensor, adjs, rows):
        if self.device.type != "cuda":
            return self.fn(x.to(self.device), [a.to(self.device) for a in adjs],
                           [r.to(self.device) for r in rows])
        host = [x, *adjs, *rows]
        if self.inputs is None:
            self._levels = len(adjs)
            self.inputs = [torch.empty(t.shape, dtype=t.dtype, device=self.device) for t in host]
        for buf, t in zip(self.inputs, host):
            buf.copy_(t.pin_memory(), non_blocking=True)
        if self.graph is None:
            self.capture(self._run, warm_up=False)
        self.graph.replay()
        # the next replay overwrites the graph's outputs
        if torch.is_tensor(self.outputs):
            return self.outputs.clone()
        return tuple(o.clone() for o in self.outputs)


class InferenceServer:
    """Persistent inference service over one set of trained parameters.

    ``denoise`` serves one mesh; ``denoise_batch`` pads every patch of every
    request to one shared node bucket and runs one batched forward. Runs on
    CUDA unless ``device="cpu"`` (never on the CPU of its own accord).
    ``timings`` holds the seconds of the last call's phases: each request's
    preprocessing (``preprocess_s``), the tables (``tables_s``), the forward
    with its copies (``forward_s``) and the solver (``solver_s``)."""

    def __init__(self, cfg: Optional[Config] = None, params=None,
                 bucket_align: int = 1024, solver_iterations: Optional[int] = None,
                 include_vertices: Optional[bool] = None, seed: int = 0,
                 max_compiled: int = 16, device: str = "cuda"):
        self.cfg = cfg or default_config()
        self.device = resolve_device(device)
        if include_vertices is None:
            include_vertices = self.cfg.model.include_vertices
        self.include_vertices = include_vertices
        if params is None:
            params = _restore_params(self.cfg, self.device)
        _require_default_conv1(params)
        if include_vertices:
            _require_heads(params)
        self.params = params
        self.bucket_align = bucket_align
        self.solver_iterations = solver_iterations or self.cfg.eval.solver_iterations
        self.seed = seed
        # LRU-bounded like the JAX server's executables (every distinct
        # (batch, shapes) key pins a graph and its memory pool), and within
        # a byte budget (half the card's free memory at start by default)
        self.max_compiled = max(int(max_compiled), 1)
        self._cache = GraphCache(budget_bytes=default_graph_budget(self.device),
                                 max_entries=self.max_compiled)
        self.timings = {}
        if self.device.type == "cuda":
            self._warm_up()

    def _warm_up(self) -> None:
        """The forward once, eagerly, on one patch of the smallest tree
        (16 nodes at the default pyramid), every node self-only."""
        levels = self.cfg.model.coarsening_levels
        group = 2 ** self.cfg.model.coarsening_steps
        klists = []
        for lvl in range(levels):
            n_l = group ** (levels - 1 - lvl)
            a = np.zeros((1, n_l, self.cfg.data.k_faces), np.int32)
            a[0, :, 0] = np.arange(n_l) + 1
            klists.append(a)
        adjs, rows = batched_graph_tensors(klists, self.cfg.model.coarsening_steps,
                                           str(self.device))
        x = torch.zeros((1, group ** (levels - 1), 6), device=self.device)
        with torch.no_grad():
            batched_forward(self.params, x, adjs, rows,
                            coarsening_steps=self.cfg.model.coarsening_steps,
                            alpha=self.cfg.model.lrelu_alpha, multi_scale=self.include_vertices)
        torch.cuda.synchronize(self.device)

    @property
    def _compiled(self):
        """The cached forwards by key, least recently used first."""
        return self._cache.entries

    # -- the batched forward ------------------------------------------------

    def _forward(self, x_b: np.ndarray, adjs_b: Sequence[np.ndarray]):
        """The batched forward of stacked inputs [B, N, 6] and K-lists
        [B, N_l, K_l], through the cache entry of its (batch, tables'
        shapes); returns its outputs on the device."""
        steps = self.cfg.model.coarsening_steps
        t0 = time.perf_counter()
        adjs, rows = batched_graph_tensors(adjs_b, steps, "cpu")
        self.timings["tables_s"] = time.perf_counter() - t0
        key = (x_b.shape[0],) + tuple(s for t in (*adjs, *rows) for s in t.shape)

        def fn(x, a, r):
            return batched_forward(self.params, x, a, r, coarsening_steps=steps,
                                   alpha=self.cfg.model.lrelu_alpha,
                                   multi_scale=self.include_vertices)

        entry = self._cache.get(key, lambda: BatchedForward(fn, self.device))
        with torch.no_grad():
            out = entry(torch.from_numpy(x_b), adjs, rows)
        self._cache.observe()
        return out

    def _stack_batch(self, built):
        """Pad every patch of every request to one shared node bucket and
        stack (x, per-level K-lists) on a batch axis."""
        flat = [(mi, p) for mi, mesh in enumerate(built) for p in mesh.patches]
        target = max(bucket_size(p.num_nodes, self.bucket_align) for _, p in flat)
        padded = [(mi, pad_patch_to(p, target)) for mi, p in flat]
        levels = len(padded[0][1].adjs)
        k_max = [max(p.adjs[lvl].shape[1] for _, p in padded) for lvl in range(levels)]
        x_b = np.stack([p.inputs for _, p in padded])
        adjs_b = [np.stack([np.pad(p.adjs[lvl], ((0, 0), (0, k_max[lvl] - p.adjs[lvl].shape[1])))
                            for _, p in padded]) for lvl in range(levels)]
        return padded, x_b, adjs_b

    def _build(self, meshes, with_vertices: bool):
        built, seconds = [], []
        for v, f in meshes:
            t0 = time.perf_counter()
            built.append(_build_mesh(v, f, self.cfg, seed=self.seed, with_vertices=with_vertices))
            seconds.append(time.perf_counter() - t0)
        self.timings = {"preprocess_s": seconds}
        return built

    # -- serving -------------------------------------------------------------

    def denoise(self, vertices: np.ndarray, faces: np.ndarray):
        """Denoise one mesh: (updated vertices [V,3], normals [F,3]), or the
        :meth:`denoise_batch_with_vertices` dict when the server was built
        with ``include_vertices=True``."""
        return self.denoise_batch([(vertices, faces)])[0]

    def denoise_batch(self, meshes: Sequence[Tuple[np.ndarray, np.ndarray]]):
        """Denoise several meshes with one batched forward, then the edge-map
        solver per mesh with the driver's options (``solve_vertices``).
        With ``include_vertices=True`` this is
        :meth:`denoise_batch_with_vertices`."""
        if self.include_vertices:
            return self.denoise_batch_with_vertices(meshes)
        built = self._build(meshes, with_vertices=False)
        padded, x_b, adjs_b = self._stack_batch(built)
        t0 = time.perf_counter()
        out = self._forward(x_b, adjs_b).cpu().numpy()
        t1 = time.perf_counter()
        self.timings["forward_s"] = t1 - t0

        # reassemble per mesh (overlap-sum + normalize, train.py:123-136)
        results = []
        for mi, mesh in enumerate(built):
            predicted = np.zeros((mesh.num_faces, 3), np.float64)
            for bi, (pmi, p) in enumerate(padded):
                if pmi != mi:
                    continue
                vals = out[bi]
                if p.perm_inv is not None:
                    vals = vals[p.perm_inv]
                predicted[p.patch_indices] += vals[: p.num_real]
            predicted = normalize_rows(predicted.astype(np.float32))
            refined, _ = solve_vertices(mesh, self.cfg, predicted, self.device,
                                        self.solver_iterations)
            results.append((refined, predicted))
        self.timings["solver_s"] = time.perf_counter() - t1
        return results

    def denoise_batch_with_vertices(self, meshes: Sequence[Tuple[np.ndarray, np.ndarray]]):
        """Batched multi-scale serving (reference ``inferNet``, train.py:
        148-376): one batched three-head forward for every patch of every
        request, then per patch the multi-scale vertex solver (the naive
        one, as the JAX server runs whatever ``cfg.eval.vertex_solver``
        says: through the scale kernel on the card) and per mesh the
        weighted overlap-average of the points. Returns one dict a mesh,
        the :func:`..inference.driver.infer_with_vertices` contract."""
        steps = self.cfg.model.coarsening_steps
        naive = self.cfg.replace(eval={"vertex_solver": "naive"})
        built = self._build(meshes, with_vertices=True)
        padded, x_b, adjs_b = self._stack_batch(built)
        t0 = time.perf_counter()
        heads_b = self._forward(x_b, adjs_b)
        t1 = time.perf_counter()
        self.timings["forward_s"] = t1 - t0

        results = []
        for mi, mesh in enumerate(built):
            num_v, num_f = mesh.num_vertices, mesh.num_faces
            points = [np.zeros((num_v, 3), np.float64) for _ in range(3)]
            weights = np.zeros((num_v, 1), np.float64)
            face_normals = [np.zeros((num_f, 3), np.float32) for _ in range(3)]
            for bi, (pmi, p) in enumerate(padded):
                if pmi != mi:
                    continue
                n0, n1, n2 = (h[bi] for h in heads_b)
                with torch.no_grad():
                    refined, dx = solve_patch(p, naive, (n0, n1, n2), self.device)
                    up1 = normalize_tensor(tree_unpool(n1, steps))
                    up2 = normalize_tensor(tree_unpool(n2, 2 * steps))
                refined = refined.cpu().numpy()
                refined_mid = refined - dx[2].cpu().numpy()
                refined_coarse = refined_mid - dx[1].cpu().numpy()
                for target, vals in zip(face_normals, (n0, up1, up2)):
                    target[p.f_old_idx] = vals.cpu().numpy()[p.perm_inv][: p.num_real]
                for target, vals in zip(points, (refined, refined_mid, refined_coarse)):
                    target[p.v_old_idx] += vals
                weights[p.v_old_idx] += 1.0
            w = np.maximum(weights, 1.0)
            results.append({
                "points": (points[0] / w).astype(np.float32),
                "points_mid": (points[1] / w).astype(np.float32),
                "points_coarse": (points[2] / w).astype(np.float32),
                "fine_normals": face_normals[0],
                "mid_normals": face_normals[1],
                "coarse_normals": face_normals[2],
            })
        self.timings["solver_s"] = time.perf_counter() - t1
        return results


# ---------------------------------------------------------------------------
# The exported forward (torch.export)
# ---------------------------------------------------------------------------

class _ExportedForward(torch.nn.Module):
    """:func:`batched_forward` with the parameters as its first argument,
    or, when ``params`` is given, as the module's buffers (baked)."""

    def __init__(self, coarsening_steps: int, alpha: float, multi_scale: bool, params=None):
        super().__init__()
        self.steps, self.alpha, self.multi_scale = coarsening_steps, alpha, multi_scale
        self.layout = None
        if params is not None:
            self.layout = {layer: list(leaves) for layer, leaves in params.items()}
            for layer, leaves in params.items():
                for name, t in leaves.items():
                    self.register_buffer(f"{layer}__{name}", t.detach().clone())

    def _run(self, params, x, tables):
        adjs, rows = list(tables[0::2]), list(tables[1::2])
        return batched_forward(params, x, adjs, rows, coarsening_steps=self.steps,
                               alpha=self.alpha, multi_scale=self.multi_scale)

    def forward(self, *args):
        if self.layout is None:
            return self._run(args[0], args[1], args[2:])
        params = {layer: {name: getattr(self, f"{layer}__{name}") for name in names}
                  for layer, names in self.layout.items()}
        return self._run(params, args[0], args[1:])


def export_forward(
    cfg: Config,
    params,
    num_nodes: int,
    adj_widths: Sequence[int],
    batch: int = 1,
    multi_scale: bool = False,
    bake_params: bool = False,
) -> bytes:
    """The batched forward at ``batch`` patches of ``num_nodes`` nodes, with
    K-lists ``adj_widths`` wide per level, as the bytes of a ``torch.export``
    program (run it with :func:`..inference.exported.load_forward`).

    The program takes the kernel's tables, built beside it by the loader
    with ``adj_widths[l] − 1`` neighbour slots a level (the most a K-list of
    that width can need), so one program serves every request of its
    shapes; K1 and the bias + lrelu kernel are opaque operators in it
    (:mod:`..ops.facet_conv_kernel`, :mod:`..ops.bias_lrelu_kernel`).
    By default the parameters are an argument (a dict with ``params``'s
    structure), so a new checkpoint swaps in without exporting again;
    ``bake_params=True`` stores them in the program instead.
    ``multi_scale=True`` exports the three-head forward. The program is
    traced on ``params``' device."""
    device = next(iter(next(iter(params.values())).values())).device
    steps = cfg.model.coarsening_steps
    group = 2 ** steps
    sizes = [num_nodes // group ** lvl for lvl in range(len(adj_widths))]
    widths = [max(int(k) - 1, 1) for k in adj_widths]
    # example tables: every node self-only, at the program's shapes
    klists = []
    for n_l, k in zip(sizes, adj_widths):
        a = np.zeros((batch, n_l, int(k)), np.int32)
        a[:, :, 0] = np.arange(n_l, dtype=np.int32) + 1
        klists.append(a)
    adjs, rows = batched_graph_tensors(klists, steps, str(device), widths)
    tables = [t for pair in zip(adjs, rows) for t in pair]
    x = torch.zeros((batch, num_nodes, 6), dtype=torch.float32, device=device)
    detached = {layer: {name: t.detach() for name, t in leaves.items()}
                for layer, leaves in params.items()}
    module = _ExportedForward(steps, cfg.model.lrelu_alpha, multi_scale,
                              detached if bake_params else None)
    args = (x, *tables) if bake_params else (detached, x, *tables)
    with torch.no_grad():
        program = torch.export.export(module, args)
    meta = {"batch": batch, "num_nodes": num_nodes, "adj_widths": [int(k) for k in adj_widths],
            "widths": widths, "group": group, "multi_scale": multi_scale,
            "baked": bake_params}
    return program_bytes(program, meta)
