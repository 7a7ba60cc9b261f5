"""The window's arithmetic: each call's completion on the host clock, each
step's time (its call's completion-to-completion time over the call's
steps, so that the steps' times sum to the window and a stall lands in the
tail), the rate of real faces and the percentile of step times."""

from __future__ import annotations

import time
from typing import List

import numpy as np


class WindowRecord:
    """Calls as they complete, from ``start`` (host clock, seconds)."""

    def __init__(self, start: float):
        self.start = start
        self.last = start
        self.step_ms: List[float] = []
        self.steps = 0
        self.faces = 0
        self.failed = 0

    def add(self, steps: int, faces: int, losses: np.ndarray, now: float = None) -> None:
        """A call of ``steps`` steps over ``faces`` real faces completed at
        ``now`` (default: the host clock now) with ``losses``."""
        now = time.perf_counter() if now is None else now
        self.step_ms += [1e3 * (now - self.last) / steps] * steps
        self.last = now
        self.steps += steps
        self.faces += faces
        self.failed += int(np.sum(~np.isfinite(np.asarray(losses, np.float64))))

    @property
    def window_s(self) -> float:
        return self.last - self.start


def step_ms_percentile(step_ms: List[float], q: float) -> float:
    """The ``q``-th percentile of the step times (numpy's linear rule)."""
    return float(np.percentile(np.asarray(step_ms, np.float64), q))
