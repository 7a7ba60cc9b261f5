"""The one generator of the benchmark's traffic: the noisy training meshes
of a traffic mix, made from the run's seed.

A mix (the ``traffic`` object of a workload file) names its meshes by
generator and arguments, and the noise level of all of them::

    {"meshes": [{"shape": "icosphere", "args": {"subdiv": 5}}, ...],
     "noise": 0.2, ...}

Each mesh gets Gaussian vertex noise of σ = noise × its mean edge length,
drawn from one ``numpy`` generator seeded with the run's seed, mesh after
mesh in the order listed. The other keys of a mix (patch size, steps a
call, ...) are read by the drivers.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

import numpy as np

from fgc_bench.traffic import synthetic

SHAPES = {"icosphere": synthetic.icosphere, "torus": synthetic.torus,
          "chamfered_box": synthetic.chamfered_box}


@dataclass
class Mesh:
    name: str
    clean: np.ndarray          # [V, 3] float32, the ground truth
    noisy: np.ndarray          # [V, 3] float32, the network's input
    faces: np.ndarray          # [F, 3] int32


def seed_sequence(seed: int, stream: str) -> np.random.Generator:
    """A numpy generator for one named stream of draws of a run: the same
    seed and name give the same numbers, and streams of one seed do not
    share numbers. Any integer seed is taken (reduced mod 2**64)."""
    key = [int(seed) % 2**64] + [ord(ch) for ch in stream]
    return np.random.default_rng(np.random.SeedSequence(key))


def make_meshes(mix: Dict, seed: int) -> List[Mesh]:
    """The mix's meshes, each with its noisy copy drawn from ``seed``."""
    rng = seed_sequence(seed, "noise")
    out = []
    for spec in mix["meshes"]:
        v, f = SHAPES[spec["shape"]](**spec.get("args", {}))
        noisy = synthetic.add_vertex_noise(v, f, float(mix["noise"]), rng)
        out.append(Mesh(spec["shape"], np.asarray(v, np.float32), noisy, np.asarray(f, np.int32)))
    return out
