"""What the program's own tracer leaves in a traced stretch, for the
per-layer metrics that read it.

- Device marks: empty kernels named ``fgc_mark_<mark>`` among the device
  activities (``utils/profiling.py::mark`` of the program). A phase of a
  step runs from one mark to the next; its device time is the union of the
  other activities between them.
- Host spans: host operations whose names start ``fgc.`` (the program's
  ``span``), beside the harness's own ``fgcb.`` labels. ``fgc.loop.
  read_losses`` is a wait: the host has nothing to enqueue there.
- The profiler's own host operations (its activity buffers' requests and
  flushes): an idle gap that overlaps one is the trace's own doing, and
  the readers of idle leave it out (:func:`own_idle`).

A program without the tracer (an older commit) leaves neither: every
reader here then finds nothing and returns None, and its metric is left
out of the result line.
"""

from __future__ import annotations

import bisect
from typing import Callable, List, Optional, Sequence, Tuple

MARK_PREFIX = "fgc_mark_"
SPAN_PREFIX = "fgc."
WAIT_SPANS = ("fgc.loop.read_losses",)
PROFILER_OPS = ("Activity Buffer Request", "Buffer Flush")

Interval = Tuple[float, float]


def kernel_name(name: str) -> str:
    """A device activity's name without its argument list."""
    return name.split("(")[0].strip()


def is_mark(name: str) -> bool:
    return kernel_name(name).startswith(MARK_PREFIX)


def merge(intervals) -> List[Interval]:
    """The union of ``intervals`` as sorted disjoint intervals."""
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def intersect(xs: Sequence[Interval], ys: Sequence[Interval]) -> List[Interval]:
    """The intersection of two sorted disjoint interval lists."""
    out, i, j = [], 0, 0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if a < b:
            out.append((a, b))
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return out


def subtract(xs: Sequence[Interval], ys: Sequence[Interval]) -> List[Interval]:
    """``xs`` less ``ys`` (both sorted and disjoint)."""
    out, j = [], 0
    for a, b in xs:
        while j < len(ys) and ys[j][1] <= a:
            j += 1
        k, start = j, a
        while k < len(ys) and ys[k][0] < b:
            if ys[k][0] > start:
                out.append((start, ys[k][0]))
            start = max(start, ys[k][1])
            k += 1
        if start < b:
            out.append((start, b))
    return out


def length(xs: Sequence[Interval]) -> float:
    return sum(b - a for a, b in xs)


class Busy:
    """The union of device activities (profiler microseconds), asked for
    its length inside any interval."""

    def __init__(self, events, keep: Callable[[str], bool] = lambda name: True):
        self.spans = merge((a, b) for name, a, b in events if keep(name))
        self.starts = [a for a, _ in self.spans]
        self.cum, total = [], 0.0
        for a, b in self.spans:
            total += b - a
            self.cum.append(total)

    def _upto(self, t: float) -> float:
        i = bisect.bisect_right(self.starts, t)
        if i == 0:
            return 0.0
        return self.cum[i - 1] - max(0.0, self.spans[i - 1][1] - t)

    def within(self, a: float, b: float) -> float:
        return self._upto(b) - self._upto(a) if b > a else 0.0


def marks(stretch, name: str) -> List[Interval]:
    """The launches of mark ``name``, by start."""
    want = MARK_PREFIX + name
    return sorted((a, b) for n, a, b in stretch.events if kernel_name(n) == want)


def phases(stretch, begin: str, end: str) -> List[float]:
    """The device busy microseconds of each phase from a ``begin`` mark to
    the first ``end`` mark after it (before the next ``begin``), the marks
    left out."""
    starts, ends = marks(stretch, begin), marks(stretch, end)
    if not starts or not ends:
        return []
    busy = Busy(stretch.events, lambda n: not is_mark(n))
    end_starts = [a for a, _ in ends]
    out = []
    for i, (_, b0) in enumerate(starts):
        limit = starts[i + 1][0] if i + 1 < len(starts) else float("inf")
        j = bisect.bisect_left(end_starts, b0)
        if j < len(ends) and ends[j][0] < limit:
            out.append(busy.within(b0, ends[j][0]))
    return out


def phase_ms(stretch, begin: str, end: str) -> Optional[float]:
    """Mean device busy ms of the ``begin`` → ``end`` phase over the steps
    of the stretch; None where the marks are not there."""
    found = phases(stretch, begin, end)
    return 1e-3 * sum(found) / len(found) if found else None


def spans(stretch, match: Callable[[str], bool]) -> List[Interval]:
    return sorted((a, b) for n, a, b in stretch.host if match(n))


def idle(stretch) -> List[Interval]:
    """The stretch's idle intervals: no device activity, from its first
    event (host or device) to its last."""
    everything = [(a, b) for _, a, b in stretch.events] + [(a, b) for _, a, b in stretch.host]
    if not everything:
        return []
    lo, hi = min(a for a, _ in everything), max(b for _, b in everything)
    return subtract([(lo, hi)], Busy(stretch.events).spans)


def own_idle(stretch) -> List[Interval]:
    """:func:`idle` less every idle interval that overlaps one of the
    profiler's own host operations (:data:`PROFILER_OPS`)."""
    own = merge(spans(stretch, lambda n: n in PROFILER_OPS))
    ends = [b for _, b in own]
    out = []
    for a, b in idle(stretch):
        i = bisect.bisect_right(ends, a)
        if not (i < len(own) and own[i][0] < b):
            out.append((a, b))
    return out


def host_stall_s(stretch) -> Optional[float]:
    """Seconds of the stretch's idle (:func:`own_idle`) inside a program
    span other than a wait; None where the stretch holds no program
    span."""
    if not spans(stretch, lambda n: n.startswith(SPAN_PREFIX)):
        return None
    work = merge(spans(stretch, lambda n: n.startswith(SPAN_PREFIX) and n not in WAIT_SPANS))
    waits = merge(spans(stretch, lambda n: n in WAIT_SPANS))
    return 1e-6 * length(subtract(intersect(own_idle(stretch), work), waits))


def switch_replays(stretch) -> List[Interval]:
    """The ``fgc.loop.replay`` spans whose call followed a graph switch:
    the last ``fgc.graphs.get`` before each holds a ``fgc.graphs.switch``."""
    gets = spans(stretch, lambda n: n == "fgc.graphs.get")
    switches = spans(stretch, lambda n: n == "fgc.graphs.switch")
    out = []
    for a, b in spans(stretch, lambda n: n == "fgc.loop.replay"):
        before = [g for g in gets if g[0] < a]
        if not before:
            continue
        g0, g1 = before[-1]
        if any(g0 <= s0 and s1 <= g1 for s0, s1 in switches):
            out.append((a, b))
    return out


def replay_idle_ms(stretch, replays: Optional[Sequence[Interval]] = None) -> List[float]:
    """The device idle ms (:func:`own_idle`) inside each of ``replays``
    (by default every ``fgc.loop.replay`` span of the stretch)."""
    if replays is None:
        replays = spans(stretch, lambda n: n == "fgc.loop.replay")
    gaps = own_idle(stretch)
    return [1e-3 * length(intersect(gaps, [r])) for r in replays]
