"""The paper's facet-graph U-Net (Armando, Franco, Boyer, TVCG 2021) and
its losses, in plain PyTorch: gathers, softmax, einsum and matmul over the
level graphs of :mod:`fgc_bench.reference.graph`, float32 (the caller turns
TF32 off), no kernels, no tables of the program.

The conv (the paper's eq. 2, FeaStNet's soft assignment): for node i with
slots N(i) (itself and its neighbours),
``y_i = b + (1/|N(i)|) Σ_{j∈N(i)} Σ_m q_ijm · W_m x_j`` with
``q_ij = softmax_M(u·x_i + v·x_j + c)``. The network: conv1 → max pool
(4:1) → conv2 → pool → conv3 → dconv3; unpool → upconv2 → concat → dconv2;
unpool → upconv1 → concat → dconv1 → fc1 → out0, leaky ReLU (slope 0.1)
after every conv but the two upconvs and after fc1; with three heads the
mid and coarse heads read dconv2's and dconv3's outputs.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch

Params = Dict[str, Dict[str, torch.Tensor]]
CONVS = (("conv1", 0), ("conv2", 1), ("conv3", 2), ("dconv3", 2), ("upconv2", 1),
         ("dconv2", 1), ("upconv1", 0), ("dconv1", 0))


def lrelu(x: torch.Tensor, alpha: float = 0.1) -> torch.Tensor:
    return torch.relu(x) - alpha * torch.relu(-x)


def conv(p: Dict[str, torch.Tensor], x: torch.Tensor, nbr: torch.Tensor) -> torch.Tensor:
    """``x`` [N, C] over the slot table ``nbr`` [N, K] (slot 0 the node,
    N an empty slot) → [N, out]; ``p``: ``w`` [M, out, C], ``b`` [out],
    ``u``, ``v`` [M, C], ``c`` [M]."""
    n = x.shape[0]
    valid = (nbr < n).to(x.dtype)                                  # [N, K]
    xj = torch.cat([x, x.new_zeros(1, x.shape[1])])[nbr]            # [N, K, C]
    logits = (x @ p["u"].T)[:, None, :] + xj @ p["v"].T + p["c"]    # [N, K, M]
    q = torch.softmax(logits, dim=-1) * valid[..., None]
    z = torch.einsum("nkm,nkc->nmc", q, xj) / valid.sum(dim=1)[:, None, None]
    return torch.einsum("nmc,moc->no", z, p["w"]) + p["b"]


def dense(p: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    return x @ p["w"] + p["b"]


def pool(x: torch.Tensor, fan: int) -> torch.Tensor:
    return x.reshape(-1, fan, x.shape[1]).amax(dim=1)


def unpool(x: torch.Tensor, fan: int) -> torch.Tensor:
    return x.repeat_interleave(fan, dim=0)


def unet(params: Params, x: torch.Tensor, nbrs: Sequence[torch.Tensor], fan: int = 4,
         heads: int = 1, alpha: float = 0.1) -> List[torch.Tensor]:
    """The per-node outputs [N_l, 3] of the fine head (and, with
    ``heads=3``, of the mid and coarse heads)."""
    def c(name, h, level):
        return conv(params[name], h, nbrs[level])

    h1 = lrelu(c("conv1", x, 0), alpha)
    h2 = lrelu(c("conv2", pool(h1, fan), 1), alpha)
    h3 = lrelu(c("conv3", pool(h2, fan), 2), alpha)
    d3 = lrelu(c("dconv3", h3, 2), alpha)
    u2 = c("upconv2", unpool(d3, fan), 1)
    d2 = lrelu(c("dconv2", torch.cat([u2, h2], dim=1), 1), alpha)
    u1 = c("upconv1", unpool(d2, fan), 0)
    d1 = lrelu(c("dconv1", torch.cat([u1, h1], dim=1), 0), alpha)
    outs = [dense(params["out0"], lrelu(dense(params["fc1"], d1), alpha))]
    if heads == 3:
        outs.append(dense(params["out1"], lrelu(dense(params["fc_mid"], d2), alpha)))
        outs.append(dense(params["out2"], lrelu(dense(params["fc_coarse"], d3), alpha)))
    return outs


def normalize(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """The paper's output normalisation: a global prescale by the mean
    |x|, then each row to unit length (rows of norm ≤ eps to 0)."""
    x = x / (x.abs().mean() + eps)
    norm = torch.sqrt(eps + (x * x).sum(dim=-1))
    inv = torch.where(norm > eps, 1.0 / (norm + eps), torch.zeros_like(norm))
    return x * inv[:, None]


def angular_loss(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Mean angle in degrees between predicted and true normals, over the
    nodes whose true normal is not zero (|gt|₁ > 1e-3)."""
    cos = torch.clamp((pred * gt).sum(dim=-1), -0.9999999, 0.9999999)
    ang = torch.acos(cos) * (180.0 / math.pi)
    real = gt.abs().sum(dim=-1) > 1e-3
    return torch.where(real, ang, 0.0).sum() / real.sum()


def chamfer_loss(p0: torch.Tensor, p1: torch.Tensor, idx0: torch.Tensor,
                 idx1: torch.Tensor, threshold: float = 5000.0,
                 tolerance: float = 0.0) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The sampled symmetric chamfer distance ×1000: the sampled points of
    ``p0`` to their nearest of ``p1``, and all of ``p0`` to the sampled
    points of ``p1`` (nearest of ``p0`` each), each distance counted only
    up to ``threshold``; distances are ``sqrt(d² + 1e-20)``.

    Returns ``(loss, ties, margins)``: for each sampled point whose nearest
    and second-nearest candidates lie within ``tolerance`` of each other,
    ``ties`` holds the change of the loss were the second chosen (a
    differentiable scalar each) and ``margins`` the gap between the two
    distances. Which of a near-tied pair is nearest is decided by rounding,
    so another float32 program may choose the second."""
    def dist(a, b):
        return torch.sqrt(((a[:, None, :] - b[None, :, :]) ** 2).sum(-1) + 1e-20)

    terms, ties, margins = [], [], []
    for d in (dist(p0[idx0], p1), dist(p0, p1[idx1]).T):        # [samples, candidates]
        two = torch.topk(d, 2, dim=1, largest=False).values
        best, second = (torch.where(v > threshold, 0.0, v) for v in two.unbind(dim=1))
        terms.append(best.mean())
        gap = (two[:, 1] - two[:, 0]).detach()
        tied = gap <= tolerance
        ties.append(1000.0 * (second - best)[tied] / d.shape[0])
        margins.append(gap[tied])
    return 1000.0 * (terms[0] + terms[1]), torch.cat(ties), torch.cat(margins)


def adam_step(params: Params, grads: Params, state: Dict, lr: float,
              betas: Tuple[float, float] = (0.9, 0.999), eps: float = 1e-8) -> None:
    """One Adam update in place (ε added outside the square root)."""
    b1, b2 = betas
    state["t"] = state.get("t", 0) + 1
    t = state["t"]
    for layer, leaves in params.items():
        for name, p in leaves.items():
            g = grads[layer][name]
            m, v = state.setdefault((layer, name), (torch.zeros_like(p), torch.zeros_like(p)))
            m = b1 * m + (1 - b1) * g
            v = b2 * v + (1 - b2) * g * g
            state[(layer, name)] = (m, v)
            p.sub_(lr * (m / (1 - b1 ** t)) / (torch.sqrt(v / (1 - b2 ** t)) + eps))
