"""The paper's rotation-invariant network (the reference code's
``bRotInvariant``, github.com/Elensil/Facet_Graph_Convolution ``model.py:
842``) in plain PyTorch, float32 (the caller turns TF32 off), over the level
graphs of :mod:`fgc_bench.reference.graph`: no kernels, no tables of the
program.

Only conv1 is rotation-invariant (``model.py:858``; every later conv keeps
the default assignment of :func:`network.conv`). For the 6-channel input
(unit normal n, then centroid p) its soft assignment is

    q_ij = softmax_M(u · [R_i n_j | R_i (p_j − p_i)] + c)

with R_i the Rodrigues rotation that takes face i's normal to +z
(``getRotationToAxis``, ``get_weight_assigments_rotation_invariance_with_
position``, ``model.py:128-377``). The aggregated rows x_j stay unrotated:
``y_i = b + (1/|N(i)|) Σ_{j∈N(i)} Σ_m q_ijm · W_m x_j``.

Departures from the TF code (the JAX package and the program make the
same):

- ``sin²`` of the rotation is taken per face (|n_i × z|²), where
  ``model.py:144`` takes one norm over the whole batch of normals (a
  missing ``axis=-1``; the path is off by default there);
- where ``sin² ≤ 1e-12`` (a zero normal, or one parallel or antiparallel to
  z) R = I, a guard the TF code lacks (the JAX package and the program keep
  ``I + [v]×`` there, within 1e-6 of I);
- the self slot's features are the analytic ``[0, 0, 1, 0, 0, 0]`` (the
  node's own normal rotated to +z at zero offset), where the TF code
  rotates the node's own row like any other slot's: the same up to
  rounding, but for a normal antiparallel to z.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from fgc_bench.reference.network import Params, conv, dense, lrelu, pool, unpool

SIN2_EPS = 1e-12


def rotation_to_axis(normals: torch.Tensor) -> torch.Tensor:
    """[N, 3] normals → [N, 3, 3] rotations R with R·n = +z for a unit n:
    ``R = I + [v]× + [v]×² (1 − cos) / sin²`` with ``v = n × z``,
    ``cos = n_z``, ``sin² = |v|²``; R = I where ``sin² ≤ 1e-12``."""
    v = torch.linalg.cross(normals, normals.new_tensor([0.0, 0.0, 1.0]).expand_as(normals),
                           dim=-1)
    sin2 = (v * v).sum(dim=-1)
    zero = torch.zeros_like(sin2)
    skew = torch.stack([torch.stack([zero, -v[:, 2], v[:, 1]], dim=-1),
                        torch.stack([v[:, 2], zero, -v[:, 0]], dim=-1),
                        torch.stack([-v[:, 1], v[:, 0], zero], dim=-1)], dim=-2)
    eye = torch.eye(3, dtype=normals.dtype, device=normals.device).expand_as(skew)
    turn = sin2 > SIN2_EPS
    coef = torch.where(turn, (1.0 - normals[:, 2]) / torch.where(turn, sin2, 1.0), zero)
    rot = eye + skew + (skew @ skew) * coef[:, None, None]
    return torch.where(turn[:, None, None], rot, eye)


def rotinv_features(x: torch.Tensor, xj: torch.Tensor, rotate: bool = True) -> torch.Tensor:
    """The assignment's features [N, K, 6] of node i's slots ``xj`` [N, K, 6]
    (slot 0 the node itself): ``[R_i n_j, R_i (p_j − p_i)]``, slot 0
    ``[0, 0, 1, 0, 0, 0]``. ``rotate=False`` takes R = I (a planted fault,
    ``no_rotation``)."""
    if x.shape[1] != 6:
        raise ValueError(f"rotinv_features: the position form takes 6 channels, got {x.shape[1]}")
    offsets = xj[..., 3:] - x[:, None, 3:]
    if rotate:
        rot = rotation_to_axis(x[:, :3])
        nrm = torch.einsum("nab,nkb->nka", rot, xj[..., :3])
        offsets = torch.einsum("nab,nkb->nka", rot, offsets)
    else:
        nrm = xj[..., :3]
    feats = torch.cat([nrm, offsets], dim=-1)
    own = feats.new_tensor([0.0, 0.0, 1.0, 0.0, 0.0, 0.0]).expand(x.shape[0], 1, 6)
    return torch.cat([own, feats[:, 1:]], dim=1)


def conv_rotinv(p, x: torch.Tensor, nbr: torch.Tensor, rotate: bool = True) -> torch.Tensor:
    """The rotation-invariant conv of ``x`` [N, 6] over the slot table
    ``nbr`` [N, K] (slot 0 the node, N an empty slot; :func:`network.conv`'s
    tables) → [N, out]; ``p``: ``w`` [M, out, 6], ``b`` [out], ``u`` [M, 6],
    ``c`` [M] (no ``v``)."""
    n = x.shape[0]
    valid = (nbr < n).to(x.dtype)                                   # [N, K]
    xj = torch.cat([x, x.new_zeros(1, x.shape[1])])[nbr]             # [N, K, C]
    logits = rotinv_features(x, xj, rotate) @ p["u"].T + p["c"]      # [N, K, M]
    q = torch.softmax(logits, dim=-1) * valid[..., None]
    z = torch.einsum("nkm,nkc->nmc", q, xj) / valid.sum(dim=1)[:, None, None]
    return torch.einsum("nmc,moc->no", z, p["w"]) + p["b"]


def unet(params: Params, x: torch.Tensor, nbrs: Sequence[torch.Tensor], fan: int = 4,
         heads: int = 1, alpha: float = 0.1, rotate: bool = True) -> List[torch.Tensor]:
    """:func:`network.unet` with conv1 rotation-invariant."""
    def c(name, h, level):
        return conv(params[name], h, nbrs[level])

    h1 = lrelu(conv_rotinv(params["conv1"], x, nbrs[0], rotate), alpha)
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
