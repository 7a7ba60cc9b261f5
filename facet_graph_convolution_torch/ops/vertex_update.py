"""Vertex solvers (torch counterparts of
``facet_graph_convolution_tpu/ops/vertex_update.py``).

- :func:`update_positions_edges`: Taubin linear anisotropic filtering over
  the edge map (reference ``update_position2``, train.py:1467-1557);
- :func:`update_positions_depth`: the same filter with each vertex's update
  projected on a fixed direction (reference ``update_position_with_depth``,
  train.py:1561-1665);
- :func:`update_positions_multiscale`: the coarse→fine projection solver
  over the per-vertex face lists and the coarsening pyramid, face centres
  recomputed from the moving vertices every iteration, each scale one launch
  of the solver kernel on the card (``ops/ms_solver_kernel.py``; reference
  ``update_position_MS`` and ``updateFacesCenter``, train.py:1668-1798);
- :func:`update_positions_multiscale_operator`: the same solver as a linear
  operator over the static tables of :func:`build_solver_tables`, plain
  tensor ops whose backward (vertex training) gathers through the tables'
  transpose maps, with no scatter.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.utils.checkpoint

from facet_graph_convolution_torch.graph.convert import dedupe_klist, lane_tables
from facet_graph_convolution_torch.ops import ms_solver_kernel
from facet_graph_convolution_torch.ops.gather import gather_neighbors_lane
from facet_graph_convolution_torch.ops.normalization import dot_last
from facet_graph_convolution_torch.ops.pooling import tree_pool


def update_positions_edges(
    x: torch.Tensor,
    face_normals: torch.Tensor,
    edge_map: torch.Tensor,
    v_edges: torch.Tensor,
    iter_num: int = 60,
    lmbd: Union[float, str] = 1.0 / 18.0,
    adaptive_tol: float = 0.0,
    trust: float = 0.0,
) -> Tuple[torch.Tensor, int]:
    """Move vertices so faces agree with ``face_normals``; returns the new
    positions and the number of iterations run.

    For each vertex i:
    ``x_i += λ · Σ_{e ∋ i} Σ_{f ∋ e} n_f ⟨n_f, (x_{v1} − x_i) + (x_{v2} − x_i)⟩``
    over ``edge_map`` [E, 4] rows (v1, v2, f1, f2), f2 = −1 on borders, and
    ``v_edges`` [V, max_edges] edge ids per vertex, −1 padded. Pads ride a
    prepended zero edge line whose faces hit a prepended zero normal, so
    their products vanish (indices are shifted by one: −1 would wrap).

    - ``lmbd="degree"``: per-vertex step 1/(3·deg) in place of the global
      1/18 (which is 1/(3·6), the valence-6 case).
    - ``adaptive_tol > 0``: stop when the residual ``Σ⟨n_f, e₁+e₂⟩²``
      improves by less than ``adaptive_tol`` of its level, within
      ``iter_num`` iterations. Inference only: the loop reads the residual
      on the host once per iteration, and raises under autograd.
    - ``trust > 0``: cap each vertex's total displacement at ``trust`` × its
      initial RMS constraint violation.
    """
    if adaptive_tol > 0.0 and torch.is_grad_enabled() and (
            x.requires_grad or face_normals.requires_grad):
        raise RuntimeError(
            "update_positions_edges: adaptive_tol > 0 is inference-only "
            "(its stop test is not differentiable); use adaptive_tol=0 under grad")
    valid = v_edges >= 0
    if isinstance(lmbd, str):
        if lmbd != "degree":
            raise ValueError(f"unknown lmbd mode {lmbd!r}")
        deg = valid.sum(dim=-1).to(x.dtype)
        lmbd = torch.where(deg > 0, 1.0 / (3.0 * torch.clamp(deg, min=1.0)),
                           torch.zeros_like(deg))[:, None]
    shift = torch.tensor([[0, 0, 1, 1]], dtype=torch.long, device=x.device)
    emap = torch.cat([torch.zeros((1, 4), dtype=torch.long, device=x.device),
                      edge_map.long() + shift], dim=0)
    fn_pad = torch.cat([face_normals.new_zeros(1, 3), face_normals], dim=0)

    n_edges = emap[v_edges.long() + 1]                  # [V, maxE, 4]
    v_pair_idx = n_edges[..., 0:2]                      # [V, maxE, 2] vertex ids
    n_f = fn_pad[n_edges[..., 2:4]]                     # [V, maxE, 2, 3]

    def proj(x):
        e_vec = x[v_pair_idx] - x[:, None, None, :]     # [V, maxE, 2, 3]
        s = torch.sum(e_vec, dim=2)                     # [V, maxE, 3]
        return dot_last(n_f, s[:, :, None, :])          # [V, maxE, 2]

    x0 = x
    if trust > 0.0:
        p0 = proj(x)
        cnt = torch.clamp(2.0 * valid.sum(dim=-1).to(x.dtype), min=1.0)
        cap = trust * torch.sqrt(torch.sum(p0 * p0, dim=(1, 2)) / cnt)

    def step(x):
        p = proj(x)
        x_new = x + lmbd * torch.sum(n_f * p[..., None], dim=(1, 2))
        if trust > 0.0:
            d = x_new - x0
            dn = torch.linalg.norm(d, dim=1, keepdim=True)
            x_new = x0 + d * torch.clamp(cap[:, None] / torch.clamp(dn, min=1e-12), max=1.0)
        return x_new, p

    if adaptive_tol <= 0.0:
        for _ in range(iter_num):
            x = step(x)[0]
        return x, iter_num

    # residuals of the last two iterates, in x's dtype like the stop test of
    # the JAX package's while_loop
    r_pp = torch.tensor(1e30, dtype=x.dtype, device=x.device)
    r_p = r_pp * 0.09
    i = 0
    while i < iter_num and bool((r_pp - r_p) > adaptive_tol * r_p):
        x, p = step(x)
        r_pp, r_p = r_p, torch.sum(p * p)
        i += 1
    return x, i


def update_positions_depth(
    x: torch.Tensor,
    face_normals: torch.Tensor,
    edge_map: torch.Tensor,
    v_edges: torch.Tensor,
    depth_dir: torch.Tensor,
    iter_num: int = 20,
    lmbd: float = 1.0 / 18.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depth-constrained :func:`update_positions_edges`: each vertex's update
    projected on the fixed direction ``depth_dir`` [3] before it is applied
    (reference ``update_position_with_depth``; JAX
    ``ops/vertex_update.py:166-199``). Returns ``(x, x − x_start)``."""
    shift = torch.tensor([[0, 0, 1, 1]], dtype=torch.long, device=x.device)
    emap = torch.cat([torch.zeros((1, 4), dtype=torch.long, device=x.device),
                      edge_map.long() + shift], dim=0)
    fn_pad = torch.cat([face_normals.new_zeros(1, 3), face_normals], dim=0)
    n_edges = emap[v_edges.long() + 1]                  # [V, maxE, 4]
    v_pair_idx = n_edges[..., 0:2]
    n_f = fn_pad[n_edges[..., 2:4]]                     # [V, maxE, 2, 3]
    d = depth_dir.reshape(1, 1, 1, 3)

    x_out = x
    for _ in range(iter_num):
        s = torch.sum(x_out[v_pair_idx] - x_out[:, None, None, :], dim=2)
        contrib = n_f * dot_last(n_f, s[:, :, None, :])[..., None]   # [V, maxE, 2, 3]
        along = dot_last(contrib, d)[..., None] * d                  # on depth_dir
        x_out = x_out + lmbd * torch.sum(along, dim=(1, 2))
    return x_out, x_out - x


def _solver_step_sizes(v_faces: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Per-vertex step 1/|v_faces| (0 for a vertex without faces), [V]."""
    num_f = (v_faces >= 0).sum(dim=-1).to(dtype)
    return torch.where(num_f > 0, 1.0 / torch.clamp(num_f, min=1.0), torch.zeros_like(num_f))


def face_centers_pyramid(
    vertices: torch.Tensor,
    faces: torch.Tensor,
    coarsening_steps: int,
    levels: int = 3,
) -> List[torch.Tensor]:
    """Face centroids at the first ``levels`` pyramid levels from the current
    vertices (reference ``updateFacesCenter``, train.py:1768-1798). Fake
    faces (vertex ids −1) gather a prepended zero vertex, so their centroid
    is exactly 0; each coarser level is the zero-ignoring tree pool of the
    one before (K4 on the card)."""
    v_pad = torch.cat([vertices.new_zeros(1, 3), vertices], dim=0)
    centers = v_pad[faces.long() + 1].mean(dim=1)                 # [F, 3]
    out = [centers]
    for _ in range(levels - 1):
        out.append(tree_pool(out[-1], steps=coarsening_steps, mode="avg_ignore_zeros"))
    return out


class NaiveMaps(NamedTuple):
    """The transpose tables of the naive solver's backward kernel, CSR
    (``offsets [rows + 1]``, ``ids``), int32, built on the host by
    :func:`build_naive_maps`."""

    face_slots: Tuple[Tuple[torch.Tensor, torch.Tensor], ...]  # a scale each, fine first
    corners: Tuple[torch.Tensor, torch.Tensor]


def _csr(rows: np.ndarray, ids: np.ndarray, num_rows: int) -> Tuple[np.ndarray, np.ndarray]:
    """CSR of (row, id) pairs: each row's ids in the order given."""
    order = np.argsort(rows, kind="stable")
    offsets = np.zeros(num_rows + 1, np.int64)
    np.cumsum(np.bincount(rows, minlength=num_rows), out=offsets[1:])
    return offsets.astype(np.int32), ids[order].astype(np.int32)


def naive_map_arrays(faces, v_faces, levels: int, coarsening_steps: int):
    """NumPy tables of :class:`NaiveMaps`: per scale s the face→slot map
    (for each level-s node f, the flat slots ``v·K + k`` whose
    ``v_faces[v, k] >> (coarsening_steps·s) == f``), and the vertex→corner
    map (for each vertex, the fine faces whose corners name it, a face once
    a corner, in face order).

    The corner map is built from ``faces``, not from ``v_faces``: the
    centroids read every corner that is not −1, while a ``v_faces`` row is
    cut at K slots and skips a face whose first corner is −1. What holds,
    and is checked here, is that each row of ``v_faces`` is a sub-multiset
    of the vertex's corner list; the two are equal where no row was cut and
    every face is either real or all −1."""
    faces = np.asarray(faces, np.int64)
    v_faces = np.asarray(v_faces, np.int64)
    num_v, k = v_faces.shape
    f0 = faces.shape[0]
    real = v_faces >= 0
    slot_v, slot_k = np.nonzero(real)
    slot_f = v_faces[real]
    face_slots = []
    for s in range(levels):
        shift = coarsening_steps * s
        face_slots.append(_csr(slot_f >> shift, slot_v * k + slot_k, f0 >> shift))
    live = faces >= 0
    corner_v = faces[live]
    corner_f = np.broadcast_to(np.arange(f0)[:, None], faces.shape)[live]
    corners = _csr(corner_v, corner_f, num_v)
    pairs, counts = np.unique(corner_v * f0 + corner_f, return_counts=True)
    need, need_counts = np.unique(slot_v * f0 + slot_f, return_counts=True)
    at = np.searchsorted(pairs, need)
    inside = at < pairs.size
    if not (inside.all() and (pairs[at] == need).all() and (counts[at] >= need_counts).all()):
        raise ValueError("v_faces names a face whose corners do not name the vertex")
    return face_slots, corners


def build_naive_maps(faces, v_faces, levels: int, coarsening_steps: int = 2,
                     device: Union[str, torch.device] = "cpu") -> NaiveMaps:
    """:func:`naive_map_arrays` as tensors on ``device``, built once a patch
    (a host copy inside a captured step would break its capture)."""
    face_slots, corners = naive_map_arrays(faces, v_faces, levels, coarsening_steps)

    def tensors(pair):
        return tuple(torch.as_tensor(a, device=device) for a in pair)

    return NaiveMaps(tuple(tensors(p) for p in face_slots), tensors(corners))


def update_positions_multiscale(
    x: torch.Tensor,
    face_normals_list: Sequence[torch.Tensor],
    faces: torch.Tensor,
    v_faces: torch.Tensor,
    coarsening_steps: int = 2,
    iter_nums: Sequence[int] = (80, 20, 20),
    checkpoint: bool = False,
    maps: Optional[NaiveMaps] = None,
) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """Coarse→fine vertex projection solver (reference
    ``update_position_MS``, train.py:1668-1765).

    ``face_normals_list`` holds the per-level normals, fine first; the
    scales run coarsest first, ``iter_nums[s]`` iterations each. A vertex's
    fine faces ``v_faces`` [V, K] (−1 padded) map to level-s nodes by floor
    division by (2^steps)^s, so a −1 pad stays −1 and contributes nothing.
    Each iteration recomputes the face centres of the current level only
    and moves each vertex by ``1/|v_faces|`` × Σ_k n_k (⟨n_k, c_k⟩ − ⟨n_k,
    x⟩). Each scale is one call of
    :func:`~facet_graph_convolution_torch.ops.ms_solver_kernel.naive_scale`:
    one kernel launch on the card, the plain loop on the CPU. Returns the
    final x and the per-scale displacements, coarse first.

    Under autograd each scale's backward is the scale kernel's adjoint
    kernel on the card, which reads ``maps`` (:func:`build_naive_maps`),
    and the plain adjoint on the CPU. ``checkpoint``
    (``cfg.eval.solver_remat``, JAX ``checkpoint=solver_remat``) keeps only
    each scale's start point and reruns its forward in the backward; the
    gradients are the same bits.
    """
    levels = len(face_normals_list)
    faces = faces.to(torch.int32).contiguous()
    v_faces = v_faces.to(torch.int32).contiguous()
    x = x.contiguous()
    dx_list: List[torch.Tensor] = []
    for s in range(levels):
        cur_scale = levels - 1 - s
        fn = face_normals_list[cur_scale].reshape(-1, 3).contiguous()
        x_init = x
        x = ms_solver_kernel.naive_scale(
            x, faces, v_faces, fn, cur_scale, coarsening_steps, int(iter_nums[s]),
            face_slots=None if maps is None else maps.face_slots[cur_scale],
            corners=None if maps is None else maps.corners, checkpoint=checkpoint)
        dx_list.append(x - x_init)
    return x, dx_list


def face_center_klists(faces, num_faces_per_level, num_vertices, coarsening_steps):
    """Per-scale level-s-face → vertex K-lists of the face-centre operator
    ``c_s = A_s·x``, equal to :func:`face_centers_pyramid`'s gather and
    pool chain: ``(adj [F_s, K_s] one-indexed vertex ids, 0 = pad, wt [F_s,
    K_s] float32)`` per scale.

    A fine face's weight inside its level-s ancestor is the product over the
    pool rounds of 1/2 where its sibling subtree holds a real face, else 1
    (the zero-ignoring rule restated on the structure: a real face whose
    centroid is exactly zero would differ), 0 for a fake face; it spreads
    w/3 onto each of its vertices, and duplicate (face, vertex) pairs sum.
    """
    import scipy.sparse as sp

    faces = np.asarray(faces)
    f0 = faces.shape[0]
    nz = faces[:, 0] >= 0                    # fake faces are all −1
    w = nz.astype(np.float64)
    out = []
    sub = 1                                  # fine faces per current node
    for s, f_s in enumerate(num_faces_per_level):
        if s > 0:
            for _ in range(coarsening_steps):
                nzp = nz.reshape(-1, 2)
                both = nzp[:, 0] & nzp[:, 1]
                w = w * np.repeat(np.where(both, 0.5, 1.0), 2 * sub)
                nz = nzp[:, 0] | nzp[:, 1]
                sub *= 2
        cf = np.repeat(np.arange(f0, dtype=np.int64) // sub, 3)
        vid = faces.ravel().astype(np.int64)
        wgt = np.repeat(w / 3.0, 3)
        keep = (vid >= 0) & (wgt > 0)
        mat = sp.coo_matrix((wgt[keep], (cf[keep], vid[keep])),
                            shape=(int(f_s), int(num_vertices))).tocsr()
        mat.sum_duplicates()
        counts = np.diff(mat.indptr)
        k_s = max(int(counts.max()) if counts.size else 0, 1)
        adj = np.zeros((int(f_s), k_s), np.int32)
        wt = np.zeros((int(f_s), k_s), np.float32)
        rows = np.repeat(np.arange(int(f_s)), counts)
        cols = (np.concatenate([np.arange(c) for c in counts]) if counts.size
                else np.zeros((0,), np.int64))
        adj[rows, cols] = mat.indices + 1    # one-indexed
        wt[rows, cols] = mat.data
        out.append((adj, wt))
    return out


def _face_center_tables(faces, num_faces_per_level, num_vertices, coarsening_steps):
    """Per scale, the lane tables of :func:`face_center_klists` over the
    vertex axis and their weights: ``(fadjT [K_s, F_s], fadjT_t [S, V],
    fwT [K_s, F_s])``, NumPy."""
    per_scale = []
    for adj, wt in face_center_klists(faces, num_faces_per_level, num_vertices,
                                      coarsening_steps):
        fadjT, fadjT_t = lane_tables(adj, num_sources=int(num_vertices))
        per_scale.append((fadjT, fadjT_t, np.ascontiguousarray(wt.T)))
    return per_scale


def build_solver_tables(
    v_faces,
    num_faces_per_level: Sequence[int],
    num_vertices: int,
    coarsening_steps: int = 2,
    faces=None,
    device: Union[str, torch.device] = "cpu",
):
    """Static tables of :func:`update_positions_multiscale_operator`, built
    on the host and returned as tensors on ``device``.

    Per scale s: each vertex's fine-face slots mapped to level-s nodes by
    floor division (−1 pads → 0 after the one-index shift) and deduped, as
    lane tables and multiplicities ``(adjT [K_u, V], adjT_t [S, F_s], multT
    [K_u, V])``; with ``faces``, also the face-centre operator's tables of
    :func:`_face_center_tables`, ``(fadjT, fadjT_t, fwT)``, which replace the
    per-iteration centre pyramid. The transpose maps (``adjT_t``,
    ``fadjT_t``) serve the operator solver's scatter-free backward.
    """
    v_faces = np.asarray(v_faces)
    group = 2 ** coarsening_steps
    fc = (_face_center_tables(faces, num_faces_per_level, num_vertices, coarsening_steps)
          if faces is not None else None)
    per_scale = []
    for s, f_s in enumerate(num_faces_per_level):
        vf1 = np.where(v_faces < 0, 0, (v_faces // group ** s) + 1)
        vf_u, mult = dedupe_klist(vf1.astype(np.int32))
        adjT, adjT_t = lane_tables(vf_u, num_sources=int(f_s))
        arrays = (adjT, adjT_t, np.ascontiguousarray(mult.T)) + (fc[s] if fc is not None else ())
        per_scale.append(tuple(torch.as_tensor(a, device=device) for a in arrays))
    return tuple(per_scale)


def update_positions_multiscale_operator(
    x: torch.Tensor,
    face_normals_list: Sequence[torch.Tensor],
    faces: Optional[torch.Tensor],
    v_faces: torch.Tensor,
    tables,
    coarsening_steps: int = 2,
    iter_nums: Sequence[int] = (80, 20, 20),
    checkpoint: bool = False,
) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """:func:`update_positions_multiscale` as a linear operator over the
    deduped tables of :func:`build_solver_tables` (equal up to float
    reassociation). For fixed normals each iteration is linear in x:

        update_v = Σ_u mult_vu·t[f_u]·n_vu − P_v x_v,
        P_v = Σ_u mult_vu n_vu n_vuᵀ   (hoisted out of the loop)

    with t = ⟨n_f, c_f⟩ per level-s face. With face tables, c = A_s·x is one
    lane gather and a weighted sum with the normals folded into the weights;
    without them (``faces`` is then read) the centre pyramid is rebuilt every
    iteration, as in the naive solver. Works node-minor ([3, V]); returns x
    [V, 3] and the per-scale displacements, coarse first.

    Under autograd every gather takes its table's transpose map, so the
    backward sums cotangents through the maps (no ``index_add``, no scatter;
    the JAX package's operator solver is scatter-free both ways too).
    ``checkpoint`` (``cfg.eval.solver_remat``) recomputes each iteration in
    the backward instead of keeping its activations
    (``torch.utils.checkpoint``); the gradients are the same."""
    levels = len(face_normals_list)
    lmbd = _solver_step_sizes(v_faces, x.dtype)[None, :]
    x_t = x.T.contiguous()                                         # [3, V]
    dx_list: List[torch.Tensor] = []
    for s in range(levels):
        cur_scale = levels - 1 - s
        tab = tables[cur_scale]
        adjT, adjT_t, multT = tab[:3]
        fn = face_normals_list[cur_scale].reshape(-1, 3)
        fn_t = fn.T.contiguous()                                   # [3, F_s]
        n_vu = gather_neighbors_lane(fn_t, adjT, adjT_t)           # [3, K_u, V]
        p_t = torch.einsum("akv,bkv,kv->abv", n_vu, n_vu, multT)  # [3, 3, V]
        # with face tables: (fadjT, fadjT_t, fwT), the normals folded into fwT
        nw = tab[5][None] * fn_t[:, None, :] if len(tab) >= 6 else None   # [3, K_s, F_s]

        # the scale's tables bound as defaults: a checkpointed iteration is
        # recomputed in the backward, after this loop has moved on
        def body(x_t, n_vu, p_t, nw, fn, cur_scale=cur_scale, tab=tab):
            adjT, adjT_t, multT = tab[:3]
            if nw is not None:
                g = gather_neighbors_lane(x_t, tab[3], tab[4])     # [3, K_s, F_s]
                t = torch.sum(nw * g, dim=(0, 1))
            else:
                fpos = face_centers_pyramid(
                    x_t.T, faces, coarsening_steps, cur_scale + 1)[cur_scale]
                t = torch.sum(fn * fpos, dim=-1)                   # [F_s]
            t_vu = gather_neighbors_lane(t[None], adjT, adjT_t)[0]     # [K_u, V]
            term1 = torch.sum((multT * t_vu)[None] * n_vu, dim=1)     # [3, V]
            px = torch.einsum("abv,bv->av", p_t, x_t)
            return x_t + lmbd * (term1 - px)

        remat = checkpoint and torch.is_grad_enabled()
        x_init_t = x_t
        for _ in range(int(iter_nums[s])):
            if remat:
                # the body draws nothing: no RNG state to stash, which a
                # CUDA graph capture would refuse
                x_t = torch.utils.checkpoint.checkpoint(body, x_t, n_vu, p_t, nw, fn,
                                                        use_reentrant=False,
                                                        preserve_rng_state=False)
            else:
                x_t = body(x_t, n_vu, p_t, nw, fn)
        dx_list.append((x_t - x_init_t).T)
    return x_t.T, dx_list
