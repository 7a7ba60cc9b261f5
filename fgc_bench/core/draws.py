"""The random choices of a training run, drawn by the benchmark from the
run's seed and handed to both the program and the reference: which patch
each step trains on (a fresh permutation of the patches each epoch, so
every patch is trained equally often), each step's rotation of the inputs
and each step's sampled faces or points."""

from __future__ import annotations

from typing import List

import numpy as np

from fgc_bench.traffic.meshes import seed_sequence


def rotation(rng: np.random.Generator) -> np.ndarray:
    """A uniformly random rotation [3, 3] float32 (QR of a Gaussian matrix,
    signs fixed, determinant +1)."""
    q, r = np.linalg.qr(rng.normal(size=(3, 3)))
    q = q * np.sign(np.diag(r))
    if np.linalg.det(q) < 0:
        q[:, 0] = -q[:, 0]
    return q.astype(np.float32)


class PatchOrder:
    """Patch indices step after step: epochs of seeded permutations."""

    def __init__(self, seed: int, num_patches: int):
        self.rng = seed_sequence(seed, "patch_order")
        self.num = num_patches
        self.queue: List[int] = []

    def take(self, count: int) -> List[int]:
        while len(self.queue) < count:
            self.queue += [int(i) for i in self.rng.permutation(self.num)]
        out, self.queue = self.queue[:count], self.queue[count:]
        return out
