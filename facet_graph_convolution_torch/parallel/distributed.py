"""Process-group bootstrap (the port's counterpart of
``facet_graph_convolution_tpu/parallel/distributed.py``).

JAX's ``jax.distributed.initialize`` joins the processes of a pod into one
runtime; here :func:`initialize` joins them into one ``torch.distributed``
process group, one rank a device: NCCL between cards, gloo between CPU
processes. Its arguments are JAX's (coordinator address, process count,
process id); where they are absent it reads ``torchrun``'s environment
(``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``), and without
either it runs one process and initializes nothing.

JAX's ``make_multihost_mesh``, ``distribute`` and ``replicate`` have no
counterpart (:data:`NO_COUNTERPART`): a rank here holds its own shard's
tensors, built from the host tables that every process computes, and its
own copy of the parameters, so no global array is assembled.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from facet_graph_convolution_torch.parallel.mesh import local_card

NO_COUNTERPART = {
    "make_multihost_mesh": "a rank is one process with one device; the group's rank order "
                           "is the shard order (parallel.mesh.make_mesh)",
    "distribute": "no global array exists: each rank builds its own shard's tensors "
                  "(parallel.halo.partition_operands)",
    "replicate": "each rank holds its own copy of the parameters, kept equal by the "
                 "all-reduced gradients",
}

TIMEOUT = datetime.timedelta(minutes=10)


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device: str = "cuda",
) -> Tuple[int, int]:
    """Join the process group; returns ``(rank, world_size)``.

    ``coordinator_address`` (``host:port``), ``num_processes`` and
    ``process_id`` fall back to torchrun's ``MASTER_ADDR:MASTER_PORT``,
    ``WORLD_SIZE`` and ``RANK``. With no process count anywhere it returns
    (0, 1) and initializes nothing. Otherwise it initializes the default group,
    also for one process (a one-rank group issues no collective): NCCL when
    ``device`` is ``"cuda"`` (after selecting this rank's card,
    :func:`..mesh.local_card`), gloo for ``"cpu"``. Every
    collective fails after :data:`TIMEOUT` rather than hanging."""
    if num_processes is None and os.environ.get("WORLD_SIZE"):
        num_processes = int(os.environ["WORLD_SIZE"])
    if process_id is None and os.environ.get("RANK"):
        process_id = int(os.environ["RANK"])
    if coordinator_address is None and os.environ.get("MASTER_ADDR"):
        coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                               f"{os.environ.get('MASTER_PORT', '29500')}")
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    if num_processes is None:
        return 0, 1
    rank = process_id or 0
    if coordinator_address is None:
        raise ValueError("initialize: num_processes given without a coordinator address")
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("initialize: device 'cuda' requested but no CUDA device is "
                               "available; pass device='cpu'")
        torch.cuda.set_device(local_card(rank))
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=rank, timeout=TIMEOUT)
    return rank, num_processes


def devices_per_host() -> Optional[int]:
    """Ranks on this host: torchrun's ``LOCAL_WORLD_SIZE``, None when it is
    not set (then the ranks are taken to share one host). Fed to
    ``build_partition(devices_per_host=...)``: rows owned on another host
    ride one all-to-all a layer."""
    value = os.environ.get("LOCAL_WORLD_SIZE")
    return int(value) if value else None


def shutdown() -> None:
    """Destroy the default process group, if one exists."""
    if dist.is_initialized():
        dist.destroy_process_group()
