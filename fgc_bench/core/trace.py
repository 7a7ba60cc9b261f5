"""The traced stretch of a run: ``torch.profiler`` over a few calls, its
device activities (kernels, copies, sets) and what the host was doing.

``busy_s`` is the union of the device activities' intervals, so
overlapping activities count once; ``window_s`` is the stretch's length on
the host clock, from a synchronised start to a synchronised end. The
breakdown holds the device operations that took most time, summed by name,
and the longest gaps between device activities, each named by the
innermost host operation running at its middle."""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Tuple

HARNESS_LABEL = "fgcb"


@dataclass
class Stretch:
    events: List[Tuple[str, float, float]]     # device activities: (name, start us, end us)
    host: List[Tuple[str, float, float]]       # host operations
    window_s: float
    busy_s: float = 0.0

    def device_time(self, match: Callable[[str], bool]) -> Tuple[float, int]:
        """(seconds, launches) of the device activities whose name matches."""
        hits = [(b - a) for name, a, b in self.events if match(name)]
        return sum(hits) * 1e-6, len(hits)

    def top_ops(self, count: int = 10) -> List[List]:
        by_name: Dict[str, float] = {}
        for name, a, b in self.events:
            by_name[name] = by_name.get(name, 0.0) + (b - a) * 1e-6
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:count]
        return [[name[:160], seconds] for name, seconds in top]

    def idle_gaps(self, count: int = 10) -> List[List]:
        spans = sorted((a, b) for _, a, b in self.events)
        gaps, end = [], None
        for a, b in spans:
            if end is not None and a > end:
                gaps.append((end, a))
            end = b if end is None else max(end, b)
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for a, b in gaps[:count]:
            mid = 0.5 * (a + b)
            inside = [(hb - ha, name) for name, ha, hb in self.host if ha <= mid <= hb]
            label = min(inside)[1] if inside else "host: no operation recorded"
            out.append([label[:160], (b - a) * 1e-6])
        return out


def _union_s(events) -> float:
    total, end = 0.0, None
    for a, b in sorted((a, b) for _, a, b in events):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total * 1e-6


def profile(run: Callable[[], object]) -> Tuple[Stretch, object]:
    """Trace ``run`` (which enqueues and waits for its calls) between two
    synchronisations of the card; returns the stretch and what ``run``
    returned."""
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        result = run()
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    device, host = [], []
    for e in prof.events():
        span = (e.name, float(e.time_range.start), float(e.time_range.end))
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if not getattr(e, "is_user_annotation", False):
                device.append(span)
        else:
            host.append(span)
    return Stretch(device, host, window_s, _union_s(device)), result
