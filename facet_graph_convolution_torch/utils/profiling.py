"""Profiling helpers: ``torch.profiler`` traces and per-step throughput (the
port's counterpart of ``facet_graph_convolution_tpu/utils/profiling.py``).

The north-star metric is edges/s on the facet-conv fwd+bwd (SURVEY.md §6);
the reference only ever printed wall-clock stage times
(dataClasses.py:39-66, infer.py:87,98).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import torch


class StepTimer:
    """Wall-clock timer with warmup discard and summary stats. With a CUDA
    ``device`` it synchronizes the card at the start and the end of each
    timed block, so the time covers the block's device work."""

    def __init__(self, warmup: int = 2, device: Optional[str] = None):
        self.warmup = warmup
        self.times = []
        self._count = 0
        self._t0 = None
        self._cuda = device is not None and torch.device(device).type == "cuda"

    def __enter__(self):
        if self._cuda:
            torch.cuda.synchronize()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self._cuda:
            torch.cuda.synchronize()
        dt = time.perf_counter() - self._t0
        self._count += 1
        if self._count > self.warmup:
            self.times.append(dt)
        return False

    @property
    def mean(self) -> float:
        return sum(self.times) / max(len(self.times), 1)

    @property
    def best(self) -> float:
        return min(self.times) if self.times else float("nan")


@contextlib.contextmanager
def trace_context(log_dir: Optional[str] = None):
    """``torch.profiler`` scope (CPU, and CUDA where a card is present) that
    writes a Chrome trace to ``<log_dir>/trace.json``; no-op when log_dir is
    None. Yields the profiler (or None)."""
    if log_dir is None:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def edges_per_second(num_edges: int, step_seconds: float) -> float:
    return num_edges / step_seconds if step_seconds > 0 else float("inf")
