"""The group of ranks that one partitioned graph runs on (the port's
counterpart of ``facet_graph_convolution_tpu/parallel/mesh.py``).

JAX lays its devices out as a ``Mesh`` and runs one program over all of
them; under ``torch.distributed`` each rank is a process with one device,
and a :class:`GraphGroup` says which: its rank (= its shard of the graph),
the group's size (= the number of shards), its device and the backend of the
process group that carries the halo exchange (NCCL between cards, gloo
between CPU processes).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist

from facet_graph_convolution_torch.config import resolve_device


@dataclass(frozen=True)
class GraphGroup:
    """One rank's place in the group that shares a partitioned graph.
    ``group`` is the process group (None: the default one); at ``size`` 1
    no collective is issued and no process group need exist."""

    rank: int
    size: int
    device: torch.device
    backend: Optional[str] = None
    group: Optional[object] = None

    def global_rank(self, rank: int) -> int:
        """The default group's rank of this group's ``rank`` (the peer that
        point-to-point operations name)."""
        return rank if self.group is None else dist.get_global_rank(self.group, rank)


def local_device_count() -> int:
    """The cards this process sees (JAX's ``len(jax.devices())`` on one
    host); 0 without CUDA."""
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def local_card(rank: int) -> int:
    """The card of global ``rank`` on its host: ``LOCAL_RANK`` where
    torchrun sets it, else the rank modulo this host's cards. The one
    choice that :func:`..distributed.initialize` selects and
    :func:`make_mesh` places the rank's tensors on."""
    local = os.environ.get("LOCAL_RANK")
    return int(local) if local else rank % max(1, local_device_count())


def _rank_device(device: str) -> torch.device:
    """``device``, with a bare ``"cuda"`` resolved to this rank's card
    (:func:`local_card` of the default group's rank; card 0 without a
    process group)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        rank = dist.get_rank() if dist.is_available() and dist.is_initialized() else 0
        dev = torch.device("cuda", local_card(rank))
    return dev


def make_mesh(device: str = "cuda", group=None) -> GraphGroup:
    """The :class:`GraphGroup` of this process over ``group`` (default: the
    default process group, when one is initialized, else a group of one).
    The device is explicit: ``"cuda"`` (this rank's card) unless the caller
    asks for ``"cpu"``. The process group's backend must suit it: NCCL for
    cards, gloo for the CPU (:func:`..distributed.initialize` picks it)."""
    dev = _rank_device(device)
    if not dist.is_available() or not dist.is_initialized():
        if group is not None:
            raise RuntimeError("make_mesh: a process group was given but torch.distributed "
                               "is not initialized")
        return GraphGroup(0, 1, dev)
    backend = str(dist.get_backend(group))
    want = "nccl" if dev.type == "cuda" else "gloo"
    if backend != want:
        raise ValueError(f"make_mesh: the process group runs {backend}, but the device "
                         f"{dev} needs {want}")
    return GraphGroup(dist.get_rank(group), dist.get_world_size(group), dev, backend, group)
