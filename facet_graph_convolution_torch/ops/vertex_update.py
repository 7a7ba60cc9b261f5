"""Edge-map vertex solver: Taubin linear anisotropic filtering (torch
counterpart of ``facet_graph_convolution_tpu/ops/vertex_update.py::
update_positions_edges``; reference ``update_position2``,
train.py:1467-1557)."""

from __future__ import annotations

from typing import Tuple, Union

import torch

from facet_graph_convolution_torch.ops.normalization import dot_last


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
