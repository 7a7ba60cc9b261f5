"""Mesh → tree-ordered, padded facet-graph patches (host).

The port's own copy of ``facet_graph_convolution_tpu/data/dataset.py``
(reference ``PreprocessedData.addMesh_TimeEfficient`` and
``addMeshWithVertices``, ``TrainingSet`` and ``InferenceMesh``,
dataClasses.py:6-531): per-mesh or per-BFS-patch K-list adjacency,
normal-weighted Graclus coarsening retried while any level saturates K, and
binary-tree node order with zero-signal fake nodes; the vertex pipeline's
patches with their own vertices, tree-ordered faces and per-vertex face
lists; the ``.npz`` serialization of normals sets in the JAX package's
layout, so that one preprocessed set serves both packages; and the bucket
padding of the training loop.

Each added mesh is the tracer's span ``fgc.prep.dataset``, with the spans
``fgc.prep.mesh_tables`` (edge map, normals, K-adjacency, barycentres),
``fgc.prep.patching`` (the patch growers), ``fgc.prep.coarsen``
(:func:`_coarsen_with_retry`) and ``fgc.prep.vertex_tables`` (a vertex
patch's tables) inside it.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from facet_graph_convolution_torch.geometry.mesh_math import (
    compute_face_normals,
    edge_map,
    triangle_barycenters,
    vertex_faces,
)
from facet_graph_convolution_torch.geometry.pointset import (
    bounding_box,
    normalize_point_sets,
    point_set_slice,
)
from facet_graph_convolution_torch.graph.adjacency import face_adjacency_klist
from facet_graph_convolution_torch.graph.coarsen import coarsen_graph
from facet_graph_convolution_torch.graph.convert import (
    coo_to_klist,
    invert_permutation,
    klist_to_coo_normal_weighted,
)
from facet_graph_convolution_torch.graph.patching import (
    grow_graph_patch_masked,
    grow_mesh_patch,
)
from facet_graph_convolution_torch.utils.profiling import span


@dataclass
class FacetPatch:
    """One network input: a facet-graph patch in binary-tree order."""

    inputs: np.ndarray                       # [N, 6] normals ++ barycenters
    adjs: List[np.ndarray]                   # per-level K-lists [N/4^l, K]
    num_real: int                            # faces before fake padding
    gt_normals: Optional[np.ndarray] = None  # [N, 3]
    patch_indices: Optional[np.ndarray] = None   # global face ids [num_real]
    perm_inv: Optional[np.ndarray] = None    # tree order → original order
    # vertex pipeline (reference addMeshWithVertices)
    vertices: Optional[np.ndarray] = None    # [V, 3]
    gt_vertices: Optional[np.ndarray] = None
    faces: Optional[np.ndarray] = None       # [N, 3] tree order, −1 for fakes
    v_faces: Optional[np.ndarray] = None     # [V, k_vertices], −1 padded
    v_old_idx: Optional[np.ndarray] = None   # patch vertex → mesh vertex
    f_old_idx: Optional[np.ndarray] = None   # patch face → mesh face

    @property
    def num_nodes(self) -> int:
        return self.inputs.shape[0]


def _coarsen_with_retry(
    adj: np.ndarray,
    positions: np.ndarray,
    normals: np.ndarray,
    k: int,
    levels: int,
    steps: int,
    rng: np.random.Generator,
    max_retries: int = 20,
    reorder: Optional[str] = None,
) -> Tuple[List[np.ndarray], np.ndarray]:
    """Coarsen and convert back to K-lists, retrying the whole randomized
    coarsening whenever a level saturates K (reference
    dataClasses.py:114-131)."""
    with span("fgc.prep.coarsen"):
        coo = klist_to_coo_normal_weighted(adj, positions, normals)
        for _ in range(max_retries):
            sparse_adjs, new_to_old = coarsen_graph(
                coo, (levels - 1) * steps, rng=rng, reorder=reorder
            )
            klists = []
            saturated = False
            for lvl in range(levels):
                klist, sat = coo_to_klist(sparse_adjs[steps * lvl], k)
                klists.append(klist)
                saturated = saturated or sat
            if not saturated:
                return klists, np.asarray(new_to_old)
        raise RuntimeError("coarsening kept saturating K; increase k_faces")


def build_patch(
    features: np.ndarray,                    # [n, 6] normals ++ positions
    adj: np.ndarray,                         # [n, K] one-indexed
    gt_normals: Optional[np.ndarray],
    levels: int,
    steps: int,
    rng: np.random.Generator,
    patch_indices: Optional[np.ndarray] = None,
    reorder: Optional[str] = None,
    faces: Optional[np.ndarray] = None,
) -> FacetPatch:
    """Coarsen one patch into the tree-ordered padded record (reference
    dataClasses.py:109-158); ``faces`` [n, 3], when given, are permuted into
    the same order, with ``-1`` rows for the fake nodes."""
    k = adj.shape[1]
    n = features.shape[0]
    if levels > 1:
        adjs, new_to_old = _coarsen_with_retry(
            adj, features[:, -3:], features[:, :3], k, levels, steps, rng,
            reorder=reorder,
        )
        new_n = len(new_to_old)
        feat = np.zeros((new_n, features.shape[1]), features.dtype)
        feat[:n] = features
        feat = feat[new_to_old]
        gt = None
        if gt_normals is not None:
            gt = np.zeros((new_n, 3), gt_normals.dtype)
            gt[:n] = gt_normals
            gt = gt[new_to_old]
        faces_out = None
        if faces is not None:
            faces_out = np.full((new_n, 3), -1, dtype=np.int32)
            faces_out[:n] = faces
            faces_out = faces_out[new_to_old]
        return FacetPatch(
            inputs=feat.astype(np.float32),
            adjs=adjs,
            num_real=n,
            gt_normals=None if gt is None else gt.astype(np.float32),
            patch_indices=patch_indices,
            perm_inv=invert_permutation(new_to_old),
            faces=faces_out,
        )
    return FacetPatch(
        inputs=features.astype(np.float32),
        adjs=[adj],
        num_real=n,
        gt_normals=None if gt_normals is None else gt_normals.astype(np.float32),
        patch_indices=patch_indices,
        perm_inv=None,
        faces=None if faces is None else np.asarray(faces, np.int32),
    )


class MeshDataset:
    """Meshes split into coarsened facet patches (reference
    ``PreprocessedData``, dataClasses.py:6-478)."""

    def __init__(
        self,
        max_patch_size: int,
        coarsening_steps: int,
        coarsening_levels: int,
        k_faces: int = 23,
        min_patch_size: int = 2000,
        k_vertices: int = 25,
        max_edges: int = 20,
        seed: Optional[int] = None,
        reorder: Optional[str] = "rcm",
    ):
        self.patches: List[FacetPatch] = []
        self.max_patch_size = max_patch_size
        self.min_patch_size = min_patch_size
        self.coarsening_steps = coarsening_steps
        self.coarsening_levels = coarsening_levels
        self.k_faces = k_faces
        self.k_vertices = k_vertices
        self.max_edges = max_edges
        # reverse Cuthill-McKee coarse order (graph.coarsen.coarsen_graph);
        # None gives the reference's identity coarse order
        self.reorder = reorder
        self.rng = np.random.default_rng(seed)
        # whole-mesh data for inference reassembly
        self.edge_map: Optional[np.ndarray] = None
        self.v_e_map: Optional[np.ndarray] = None
        self.vertices: Optional[np.ndarray] = None
        self.faces: Optional[np.ndarray] = None
        self.normals: Optional[np.ndarray] = None
        self.num_vertices: int = 0
        self.num_faces: int = 0

    def add_mesh(
        self,
        vertices: np.ndarray,
        faces: np.ndarray,
        gt_vertices: Optional[np.ndarray] = None,
    ) -> None:
        """Add one mesh, split into masked BFS patches when it has more than
        ``max_patch_size`` faces (reference dataClasses.py:34-234)."""
        with span("fgc.prep.dataset"):
            with span("fgc.prep.mesh_tables"):
                self.edge_map, self.v_e_map = edge_map(faces, max_edges=self.max_edges)
                f_normals = compute_face_normals(vertices, faces)
                adj = face_adjacency_klist(faces, self.k_faces)
                f_pos = triangle_barycenters(vertices, faces)
                features = np.concatenate([f_normals, f_pos], axis=1)
                gt_normals = (
                    compute_face_normals(gt_vertices, faces) if gt_vertices is not None else None
                )

            fnum = faces.shape[0]
            if fnum <= self.max_patch_size:
                self.patches.append(
                    build_patch(
                        features, adj, gt_normals,
                        self.coarsening_levels, self.coarsening_steps, self.rng,
                        reorder=self.reorder,
                        patch_indices=np.arange(fnum),
                    )
                )
                return

            covered = np.zeros(fnum, dtype=np.int8)
            next_seed = -1
            while np.any(covered == 0):
                to_process = np.flatnonzero(covered == 0)
                if next_seed == -1 or covered[next_seed] == 1:
                    seed = int(self.rng.choice(to_process))
                else:
                    seed = next_seed
                with span("fgc.prep.patching"):
                    patch_adj, old_idx, next_seed = grow_graph_patch_masked(
                        adj, self.max_patch_size, seed, covered, self.min_patch_size
                    )
                covered[old_idx] = 1
                if old_idx.shape[0] < 100:      # skip tiny disjoint components
                    continue
                self.patches.append(
                    build_patch(
                        features[old_idx], patch_adj,
                        None if gt_normals is None else gt_normals[old_idx],
                        self.coarsening_levels, self.coarsening_steps, self.rng,
                        patch_indices=old_idx, reorder=self.reorder,
                    )
                )

    def add_mesh_with_vertices(
        self,
        vertices: np.ndarray,
        faces: np.ndarray,
        gt_vertices: Optional[np.ndarray] = None,
    ) -> None:
        """Add one mesh for the vertex pipeline (reference
        dataClasses.py:236-456): vertices scaled by the bounding-box diagonal
        (jointly with the GT when given), the GT as a point set sliced to each
        patch's bounding box, faces co-permuted into tree order with −1
        fakes, and per-vertex incident face lists. The patches' vertices stay
        in that scaled frame, so the points served from them do too."""
        with span("fgc.prep.dataset"):
            self.num_vertices = vertices.shape[0]
            self.num_faces = faces.shape[0]
            with span("fgc.prep.mesh_tables"):
                f_normals = compute_face_normals(vertices, faces)
                adj = face_adjacency_klist(faces, self.k_faces)
                f_pos = triangle_barycenters(vertices, faces, normalize=True)
                features = np.concatenate([f_normals, f_pos], axis=1)
                gt_normals = (
                    compute_face_normals(gt_vertices, faces) if gt_vertices is not None else None
                )
            vertices, gt_vertices = normalize_point_sets(
                vertices, vertices if gt_vertices is None else gt_vertices)
            if gt_normals is None:
                gt_vertices = None

            fnum = faces.shape[0]
            if fnum <= self.max_patch_size:
                patch = build_patch(
                    features, adj, gt_normals,
                    self.coarsening_levels, self.coarsening_steps, self.rng,
                    patch_indices=np.arange(fnum), faces=faces, reorder=self.reorder,
                )
                self._add_vertex_patch(patch, vertices, gt_vertices,
                                       np.arange(vertices.shape[0]), np.arange(fnum))
                return

            covered = np.zeros(fnum, dtype=np.int8)
            while np.any(covered == 0):
                seed = int(self.rng.choice(np.flatnonzero(covered == 0)))
                with span("fgc.prep.patching"):
                    pv, pf, padj, v_old, f_old = grow_mesh_patch(
                        vertices, faces, adj, self.max_patch_size, seed)
                covered[f_old] += 1
                if f_old.shape[0] < 100:
                    continue
                patch_gt = None
                if gt_vertices is not None:
                    patch_gt = point_set_slice(gt_vertices, bounding_box(pv))
                    if patch_gt.shape[0] < pv.shape[0]:
                        continue    # no GT support in this window (dataClasses.py:302-304)
                patch = build_patch(
                    features[f_old], padj,
                    None if gt_normals is None else gt_normals[f_old],
                    self.coarsening_levels, self.coarsening_steps, self.rng,
                    patch_indices=f_old, faces=pf, reorder=self.reorder,
                )
                self._add_vertex_patch(patch, pv, patch_gt, v_old, f_old)

    def _add_vertex_patch(self, patch, vertices, gt_vertices, v_old, f_old):
        with span("fgc.prep.vertex_tables"):
            patch.vertices = np.asarray(vertices, np.float32)
            patch.gt_vertices = (None if gt_vertices is None
                                 else np.asarray(gt_vertices, np.float32))
            patch.v_faces = vertex_faces(patch.faces, self.k_vertices, vertices.shape[0])
        patch.v_old_idx = v_old
        patch.f_old_idx = f_old
        self.patches.append(patch)


class TrainingSet(MeshDataset):
    """min patch size = max patch size: no undersized training patches
    (reference dataClasses.py:480-487)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.min_patch_size = self.max_patch_size


class InferenceMesh(MeshDataset):
    """A whole mesh kept beside its patches for reassembly (reference
    dataClasses.py:509-531)."""

    def add_mesh(self, vertices, faces, gt_vertices=None):
        super().add_mesh(vertices, faces, gt_vertices)
        self._keep_whole(vertices, faces)

    def add_mesh_with_vertices(self, vertices, faces, gt_vertices=None):
        super().add_mesh_with_vertices(vertices, faces, gt_vertices)
        self._keep_whole(vertices, faces)

    def _keep_whole(self, vertices, faces):
        self.vertices = np.asarray(vertices, np.float32)
        self.faces = np.asarray(faces)
        self.normals = compute_face_normals(vertices, faces)
        self.num_vertices = vertices.shape[0]
        self.num_faces = faces.shape[0]


# ---------------------------------------------------------------------------
# Serialization: the JAX package's .npz layout (data/dataset.py:334-414)
# ---------------------------------------------------------------------------

# a patch's optional fields, the vertex pipeline's among them, under the
# JAX package's keys
_OPTIONAL_FIELDS = ("gt_normals", "patch_indices", "perm_inv", "vertices", "gt_vertices",
                    "faces", "v_faces", "v_old_idx", "f_old_idx")
_MESH_FIELDS = ("edge_map", "v_e_map", "vertices", "faces", "normals")


def save_dataset(ds: MeshDataset, path: str) -> None:
    """Write ``ds`` as a compressed ``.npz`` that the JAX package's
    ``load_dataset`` reads."""
    meta = {
        "num_patches": len(ds.patches),
        "max_patch_size": ds.max_patch_size,
        "coarsening_steps": ds.coarsening_steps,
        "coarsening_levels": ds.coarsening_levels,
        "k_faces": ds.k_faces,
        "num_vertices": ds.num_vertices,
        "num_faces": ds.num_faces,
    }
    arrays = {
        "meta": np.array([meta[k] for k in sorted(meta)], dtype=np.int64),
        "meta_keys": np.array(sorted(meta)),
    }
    for name in _MESH_FIELDS:
        value = getattr(ds, name)
        if value is not None:
            arrays[f"mesh_{name}"] = value
    for i, p in enumerate(ds.patches):
        arrays[f"p{i}_inputs"] = p.inputs
        arrays[f"p{i}_num_real"] = np.array(p.num_real)
        for lvl, a in enumerate(p.adjs):
            arrays[f"p{i}_adj{lvl}"] = a
        for f_name in _OPTIONAL_FIELDS:
            value = getattr(p, f_name)
            if value is not None:
                arrays[f"p{i}_{f_name}"] = value
    np.savez_compressed(path, **arrays)


def load_dataset(path: str) -> MeshDataset:
    """Read a dataset written by :func:`save_dataset` or by the JAX
    package's ``save_dataset``, the vertex pipeline's sets included."""
    with np.load(path, allow_pickle=False) as data:
        meta = dict(zip([str(k) for k in data["meta_keys"]], data["meta"]))
        ds = MeshDataset(
            max_patch_size=int(meta["max_patch_size"]),
            coarsening_steps=int(meta["coarsening_steps"]),
            coarsening_levels=int(meta["coarsening_levels"]),
            k_faces=int(meta["k_faces"]),
        )
        ds.num_vertices = int(meta["num_vertices"])
        ds.num_faces = int(meta["num_faces"])
        for name in _MESH_FIELDS:
            if f"mesh_{name}" in data:
                setattr(ds, name, data[f"mesh_{name}"])
        for i in range(int(meta["num_patches"])):
            adjs = []
            while f"p{i}_adj{len(adjs)}" in data:
                adjs.append(data[f"p{i}_adj{len(adjs)}"])
            patch = FacetPatch(inputs=data[f"p{i}_inputs"], adjs=adjs,
                               num_real=int(data[f"p{i}_num_real"]))
            for f_name in _OPTIONAL_FIELDS:
                if f"p{i}_{f_name}" in data:
                    setattr(patch, f_name, data[f"p{i}_{f_name}"])
            ds.patches.append(patch)
    return ds


# ---------------------------------------------------------------------------
# Bucket padding (data/dataset.py:421-482): the training loop pads patches to
# a few sizes (multiples of 4^(levels-1), tree-aligned)
# ---------------------------------------------------------------------------

def pad_patch_to(patch: FacetPatch, target: int) -> FacetPatch:
    """Pad a patch's fine level to ``target`` nodes with self-only fake nodes
    (zero signal, zero GT → masked by the fake-node discipline everywhere).
    Coarser levels pad proportionally; a vertex patch's faces get ``-1``
    rows, the fake faces' mark."""
    n = patch.num_nodes
    if n == target:
        return patch
    if target < n:
        raise ValueError(f"cannot shrink patch {n} → {target}")
    group = n // patch.adjs[1].shape[0] if len(patch.adjs) > 1 else 1
    inputs = np.zeros((target, patch.inputs.shape[1]), patch.inputs.dtype)
    inputs[:n] = patch.inputs
    gt = None
    if patch.gt_normals is not None:
        gt = np.zeros((target, 3), patch.gt_normals.dtype)
        gt[:n] = patch.gt_normals
    adjs = []
    size = target
    for a in patch.adjs:
        pad = np.zeros((size, a.shape[1]), a.dtype)
        pad[: a.shape[0]] = a
        pad[a.shape[0]:, 0] = np.arange(a.shape[0], size) + 1
        adjs.append(pad)
        if group == 1:
            break
        size //= group
    faces = None
    if patch.faces is not None:
        faces = np.full((target, 3), -1, dtype=patch.faces.dtype)
        faces[:n] = patch.faces
    return dataclasses.replace(patch, inputs=inputs, gt_normals=gt, adjs=adjs, faces=faces)


def bucket_size(n: int, align: int = 1024) -> int:
    """Smallest multiple of ``align`` ≥ n (align must be a multiple of the
    tree group so all pyramid levels stay integral)."""
    return ((n + align - 1) // align) * align
