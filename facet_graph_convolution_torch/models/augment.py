"""Rotation augmentation (torch counterpart of
``facet_graph_convolution_tpu/models/augment.py``).

The reference applies a fresh uniform-random global rotation to the input
normals and positions and to the GT normals every training iteration
(train.py:436-483, matrix from utils.py:2034). The random numbers come from
an explicit ``torch.Generator``; they are not the JAX package's numbers for
the same seed.
"""

from __future__ import annotations

import math

import torch


def random_rotation(generator: torch.Generator, deflection: float = 1.0) -> torch.Tensor:
    """Uniform random rotation matrix [3, 3] f32 on the generator's device
    (Arvo's method, as the reference's host generator, utils.py:2034-2074)."""
    theta, phi, z = torch.rand(3, generator=generator, device=generator.device).unbind()
    theta = theta * 2.0 * deflection * math.pi
    phi = phi * 2.0 * math.pi
    z = z * 2.0 * deflection
    r = torch.sqrt(z)
    v = torch.stack([torch.sin(phi) * r, torch.cos(phi) * r, torch.sqrt(2.0 - z)])
    st, ct = torch.sin(theta), torch.cos(theta)
    zero, one = torch.zeros_like(st), torch.ones_like(st)
    rot_z = torch.stack([torch.stack([ct, st, zero]), torch.stack([-st, ct, zero]),
                         torch.stack([zero, zero, one])])
    return (torch.outer(v, v) - torch.eye(3, device=v.device)) @ rot_z


def rotate_vec3(rot: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Rotate [N, 3] vectors by one [3, 3] matrix."""
    return x @ rot.T


def rotate_inputs(rot: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Rotate a channel-stacked signal [N, C]. Channel layouts follow the
    reference (train.py:444-479):

    - C % 3 == 0: C/3 consecutive 3-vectors (e.g. normal + position);
    - C == 7: normal(3) + border flag(1) + position(3);
    - C == 8: normal(3) + area/border(2) + position(3).
    """
    n, c = x.shape
    if c % 3 == 0:
        return (x.reshape(n, c // 3, 3) @ rot.T).reshape(n, c)
    if c == 7:
        return torch.cat([rotate_vec3(rot, x[:, :3]), x[:, 3:4], rotate_vec3(rot, x[:, 4:])],
                         dim=-1)
    if c == 8:
        return torch.cat([rotate_vec3(rot, x[:, :3]), x[:, 3:5], rotate_vec3(rot, x[:, 5:])],
                         dim=-1)
    raise ValueError(f"unsupported channel count {c}")
