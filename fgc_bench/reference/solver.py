"""The paper's multi-scale vertex solver (its ``update_position_MS``), in
plain PyTorch: scales coarse to fine, each a number of iterations that
move every vertex towards the planes of its faces at that scale.

At scale s a fine face f stands for its level-s node ``f >> (steps·s)``;
the node's centre is its faces' centroids pooled ``s`` times by rounds of
pairwise means in which an all-zero sibling (a fake node) is replaced by
its partner. An iteration sets ``x_v += (1/|F_v|) Σ_{f∈F_v} n_f (⟨n_f, c_f⟩
− ⟨n_f, x_v⟩)`` over the vertex's fine faces F_v, with the node's normal
``n_f`` and centre ``c_f`` of the current scale, the centres recomputed from
the moving vertices every iteration."""

from __future__ import annotations

from typing import Sequence

import torch


def face_centres(x: torch.Tensor, tri: torch.Tensor) -> torch.Tensor:
    """Centroids [N, 3] of the faces ``tri`` [N, 3] (vertex ids, -1 rows for
    fake nodes, whose centre is 0)."""
    pad = torch.cat([x.new_zeros(1, 3), x])
    return pad[tri + 1].mean(dim=1)


def pool_ignore_zeros(c: torch.Tensor, rounds: int) -> torch.Tensor:
    for _ in range(rounds):
        a, b = c[0::2], c[1::2]
        a_zero = (a == 0).all(dim=-1, keepdim=True)
        b_zero = (b == 0).all(dim=-1, keepdim=True)
        c = torch.where(a_zero, b, torch.where(b_zero, a, 0.5 * (a + b)))
    return c


def solve(x: torch.Tensor, normals: Sequence[torch.Tensor], tri: torch.Tensor,
          v_faces: torch.Tensor, iterations: Sequence[int], steps: int) -> torch.Tensor:
    """``x`` [V, 3] after the solver; ``normals`` a [N_s, 3] each scale, fine
    first; ``v_faces`` [V, K] the fine faces of each vertex (-1 unused);
    ``iterations`` coarse first."""
    valid = v_faces >= 0
    count = valid.sum(dim=1).to(x.dtype)
    step = torch.where(count > 0, 1.0 / count.clamp(min=1.0), torch.zeros_like(count))[:, None]
    levels = len(normals)
    for s, iters in enumerate(iterations):
        scale = levels - 1 - s
        n = normals[scale]
        node = torch.where(valid, v_faces >> (steps * scale), 0)
        n_v = n[node] * valid[..., None].to(x.dtype)                      # [V, K, 3]
        for _ in range(int(iters)):
            c = pool_ignore_zeros(face_centres(x, tri), steps * scale)
            t = (n * c).sum(dim=-1)[node]                                 # [V, K]
            proj = (n_v * x[:, None, :]).sum(dim=-1)                      # [V, K]
            x = x + step * (n_v * (t - proj)[..., None]).sum(dim=1)
    return x
