"""The port's tracer: host spans, device marks and the spans' totals.

Spans. ``with span("fgc.<layer>.<stage>"):`` times a stage on the host. It
always adds its host seconds to in-memory totals by name (:func:`totals`,
:func:`reset`): how many times it ran, its seconds, and its seconds as an
outermost span of its prefix (the name up to its last dot: a
``fgc.prep.coarsen`` inside a ``fgc.prep.dataset`` adds none there). While
a ``torch.profiler`` records (its own enabled flag), the span also opens
``torch.profiler.record_function(name)``, so the stage lands in the same
trace as the device's activities, on the profiler's clock; parent and child
there come from containment. With no profiler recording a span enters no
``record_function``: it costs a flag check, two clock reads and a few dict
updates. Spans are opened on the host thread that drives the step, never
inside the body of a captured CUDA graph (they would record the capture
once and none of the replays).

Marks. :func:`mark` launches the empty kernel ``fgc_mark_<name>`` of
``csrc/trace_mark.cu`` (through its ``fgc_mark_launch_<name>``) on the
device's current stream; :func:`mark_grad` is an identity over tensors
that launches one mark in its forward and one in its backward, which runs
once all its outputs' gradients are in.
:func:`marked_step` puts the marks ``step_begin``, ``fwd_end``, ``bwd_end``
and ``opt_end`` around a train step's phases. A mark is device work: a CUDA
graph captures it and every replay launches it again, so marks split a
captured step's device time in a trace where host spans cannot. On a CPU
device they launch nothing.

Counters stay as attributes where the work happens: the kernel wrappers'
``.launches``, ``graph_step.GraphCache.captures`` / ``evictions`` /
``switches``. ``PERF.md`` lists every span, mark and counter with the
metric that reads it.
"""

from __future__ import annotations

import contextlib
import ctypes
import time
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

# the marks: each a kernel and its launcher in csrc/trace_mark.cu
MARKS = ("step_begin", "fwd_end", "bwd_end", "opt_end",
         "solver_begin", "solver_end", "solver_bwd_begin", "solver_bwd_end",
         "rotinv_begin", "rotinv_end", "rotinv_bwd_begin", "rotinv_bwd_end")

_TOTALS: Dict[str, list] = {}       # name → [count, seconds, outermost seconds]
_OPEN: Dict[str, int] = {}          # prefix → spans of it open now


class span:
    """A host span ``name`` (``fgc.<layer>.<stage>``). After the block,
    ``seconds`` holds its host duration."""

    __slots__ = ("name", "seconds", "_prefix", "_outer", "_record", "_t0")

    def __init__(self, name: str):
        self.name = name
        self.seconds: Optional[float] = None
        self._prefix = name.rpartition(".")[0]
        self._record = None

    def __enter__(self) -> "span":
        depth = _OPEN.get(self._prefix, 0)
        _OPEN[self._prefix] = depth + 1
        self._outer = depth == 0
        if torch.autograd._profiler_enabled():
            self._record = torch.profiler.record_function(self.name)
            self._record.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        self.seconds = time.perf_counter() - self._t0
        if self._record is not None:
            self._record.__exit__(*exc)
            self._record = None
        _OPEN[self._prefix] -= 1
        total = _TOTALS.get(self.name)
        if total is None:
            total = _TOTALS[self.name] = [0, 0.0, 0.0]
        total[0] += 1
        total[1] += self.seconds
        if self._outer:
            total[2] += self.seconds
        return False


def totals() -> Dict[str, Dict[str, float]]:
    """Every span name run since the last :func:`reset`: ``count``,
    ``seconds`` and ``outer_seconds`` (as an outermost span of its
    prefix)."""
    return {name: {"count": c, "seconds": s, "outer_seconds": o}
            for name, (c, s, o) in _TOTALS.items()}


def reset() -> None:
    """Clear the totals (spans open now still add theirs when they close)."""
    _TOTALS.clear()


def _launcher(name: str):
    """``fgc_mark_launch_<name>(stream)`` of ``csrc/trace_mark.cu``."""
    from facet_graph_convolution_torch.ops import cuda_library

    fn = getattr(cuda_library.load("trace_mark"), "fgc_mark_launch_" + name)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def mark(name: str, device) -> None:
    """Launch the empty kernel ``fgc_mark_<name>`` (``name`` one of
    :data:`MARKS`) on ``device``'s current stream; nothing on a CPU
    device."""
    if name not in MARKS:
        raise ValueError(f"mark: unknown mark {name!r}; the marks are {MARKS}")
    device = torch.device(device)
    if device.type != "cuda":
        return
    with torch.cuda.device(device):
        err = _launcher(name)(torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"mark {name!r}: kernel launch failed (cudaError {err})")


class _MarkGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, names: Tuple[str, str], device, *tensors):
        ctx.set_materialize_grads(False)
        ctx.bwd_name, ctx.device = names[1], device
        mark(names[0], device)
        return tuple(t.view_as(t) for t in tensors)

    @staticmethod
    def backward(ctx, *grads):
        mark(ctx.bwd_name, ctx.device)
        return (None, None, *grads)


def mark_grad(tensors: Sequence[torch.Tensor], fwd_name: str, bwd_name: str
              ) -> Tuple[torch.Tensor, ...]:
    """The ``tensors`` unchanged, behind the mark ``fwd_name`` now and the
    mark ``bwd_name`` once the gradients of all of them are in."""
    for name in (fwd_name, bwd_name):
        if name not in MARKS:
            raise ValueError(f"mark_grad: unknown mark {name!r}; the marks are {MARKS}")
    tensors = tuple(tensors)
    return _MarkGrad.apply((fwd_name, bwd_name), tensors[0].device, *tensors)


def marked_step(device, forward: Callable[[], torch.Tensor],
                backward: Callable[[torch.Tensor], None], update: Callable[[], None],
                spans: Optional[str] = None) -> torch.Tensor:
    """One train step between the marks ``step_begin``, ``fwd_end``,
    ``bwd_end`` and ``opt_end``: ``loss = forward()``, ``backward(loss)``
    (with any gradient all-reduce), ``update()``; returns the loss. With
    ``spans`` (a prefix such as ``"fgc.sharded"``) the three phases are
    also the host spans ``<spans>.forward``, ``.backward`` and ``.adam``; a
    step captured in a CUDA graph passes none."""
    def phase(stage):
        return contextlib.nullcontext() if spans is None else span(f"{spans}.{stage}")

    mark("step_begin", device)
    with phase("forward"):
        loss = forward()
    mark("fwd_end", device)
    with phase("backward"):
        backward(loss)
    mark("bwd_end", device)
    with phase("adam"):
        update()
    mark("opt_end", device)
    return loss
