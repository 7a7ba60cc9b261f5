"""Multi-step train calls: the port's counterpart of
``facet_graph_convolution_tpu/training/trainer.py::make_scanned_train_step``
(a jitted ``lax.scan`` over ``steps_per_call`` steps) and of the vertex
step's ``scanned``.

On the card one train step (forward through K1/K2/K3, backward, the
capturable Adam update) is captured once as a ``torch.cuda.CUDAGraph`` and
replayed, once a step. A call of N steps does on the host:

1. copy the N steps' draws (drawn by the caller in the order N single steps
   draw them, plus each step's learning rate ``schedule(step)``) from
   pinned memory into static device buffers ``[steps_per_call, ...]``;
2. set a device counter to 0 and replay the graph N times; the captured step
   reads its draws at the counter (``index_select``), writes its loss to the
   loss buffer there and adds one to the counter, so one step costs the host
   one ``replay()``;
3. copy the N losses into pinned host memory behind an event.

Nothing in a call waits for the device; :meth:`CallLosses.numpy` waits for
the event once, which the training loops do one call late (the JAX loop's
deferred ``consume``). The first call runs its first step eagerly on a side
stream (the warm-up whole-network capture needs: lazy state, cuBLAS
workspaces) and captures the second; the warm-up is a real step of the call.
A failed capture raises: there is no eager fallback on the card.

On the CPU the same step runs eagerly, once a step, on the same buffers and
counter (the caller asked for the CPU; the tests drive this path).

Under ``compute_dtype="bfloat16"`` the captured step is the same graph with
the convs' bfloat16 interiors (K1/K2/K3's bfloat16 launches, the products
into f32) allocated in the graph's pool like any activation; the draws, the
parameters, their gradients, Adam's state, the learning rate and the loss
stay float32, and :meth:`GraphStep._step` refuses a loss of another dtype.

The host stages are the tracer's spans (``utils/profiling.py``):
``fgc.loop.stage_draws`` (1), ``fgc.loop.replay`` (2 and 3),
``fgc.loop.read_losses`` (the wait), ``fgc.graph.capture`` and
``fgc.graphs.get`` (with ``fgc.graphs.switch`` inside where the key
changed). The captured step holds no span: it launches the device marks of
``marked_step`` (``step_begin``, ``fwd_end``, ``bwd_end``, ``opt_end``),
which every replay launches again.

Each graph keeps its step's activations in a memory pool of its own, ~1 GiB
for a full-width vertex step. :class:`GraphCache` holds a trainer's graphs
(one a vertex patch) least recently used first, within a byte budget: it
releases the oldest graphs before a new one is captured, and a released
patch is captured again at its next use.
"""

from __future__ import annotations

import contextlib
from collections import OrderedDict
from typing import Callable, Dict, Hashable, Optional

import numpy as np
import torch

from facet_graph_convolution_torch.utils.profiling import marked_step, span


def set_learning_rate(optimizer: torch.optim.Optimizer, lr) -> None:
    """Set every group's learning rate: in place into the tensor a capturable
    Adam holds on the card (a graph reads it at replay; a Python float would
    be frozen into the graph), else as a Python float."""
    for group in optimizer.param_groups:
        if torch.is_tensor(group["lr"]):
            if torch.is_tensor(lr):
                group["lr"].copy_(lr)
            else:
                group["lr"].fill_(lr)
        else:
            group["lr"] = float(lr)


class CallLosses:
    """The per-step losses of one call, read on the host once."""

    def __init__(self, host: torch.Tensor, event: Optional[torch.cuda.Event]):
        self._host, self._event = host, event

    def numpy(self) -> np.ndarray:
        """The losses [N]; on the card this waits for the call's event (its
        one host synchronisation; the span ``fgc.loop.read_losses``)."""
        with span("fgc.loop.read_losses"):
            if self._event is not None:
                self._event.synchronize()
            return self._host.numpy()


class CapturedGraph:
    """A captured ``torch.cuda.CUDAGraph`` (``graph``, None before the
    capture) with what its capture allocated: ``graph_bytes`` (the device
    memory, ``torch.cuda.max_memory_allocated`` around it) and
    ``pool_bytes`` (what its pool reserved, ``torch.cuda.memory_reserved``
    around it); ``captures`` counts its captures (one, and one more after
    each :meth:`release` that a later call captured again)."""

    def __init__(self, device: torch.device):
        self.device = device
        self.captures = 0
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.capture_s: Optional[float] = None
        self.graph_bytes: Optional[int] = None
        self.pool_bytes: Optional[int] = None

    @property
    def held_bytes(self) -> int:
        """The device memory the captured graph holds (its pool, at least
        its capture's peak); 0 before a capture or after :meth:`release`."""
        if self.graph is None:
            return 0
        return max(self.graph_bytes, self.pool_bytes)

    def release(self) -> None:
        """Drop the captured graph, once the device has run every replay
        enqueued: its pool goes back to the allocator. The next call captures
        again, over the tensors its body reads then (the streaming trainer
        releases its step's graph when it allocates its window buffers
        anew)."""
        if self.graph is not None:
            torch.cuda.synchronize(self.device)
            self.graph.reset()
            self.graph = None

    def capture(self, body: Callable[[], None],
                before_capture: Optional[Callable[[], None]] = None,
                warm_up: bool = True) -> None:
        """Run ``body`` once eagerly on the device's side stream (the warm-up
        a capture needs: lazy state, cuBLAS workspaces; ``warm_up=False``
        where the caller has run the same code eagerly before), then
        ``before_capture`` and the capture of ``body``, which only replays
        execute. ``capture_s`` is the host seconds of it all, warm-up
        included: the span ``fgc.graph.capture``."""
        with span("fgc.graph.capture") as timed:
            if warm_up:
                side = _side_stream(self.device)
                side.wait_stream(torch.cuda.current_stream(self.device))
                with torch.cuda.stream(side):
                    body()
                torch.cuda.current_stream(self.device).wait_stream(side)
            torch.cuda.synchronize(self.device)
            before = torch.cuda.memory_allocated(self.device)
            reserved = torch.cuda.memory_reserved(self.device)
            torch.cuda.reset_peak_memory_stats(self.device)
            if before_capture is not None:
                before_capture()
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                body()
            torch.cuda.synchronize(self.device)
        self.capture_s = timed.seconds
        self.graph_bytes = torch.cuda.max_memory_allocated(self.device) - before
        self.pool_bytes = torch.cuda.memory_reserved(self.device) - reserved
        self.graph = graph
        self.captures += 1


class GraphStep(CapturedGraph):
    """Up to ``steps_per_call`` train steps a call of ``loss_fn(params,
    **draw) → loss`` on ``state`` (a ``trainer.TrainState``; its Adam must be
    capturable on the card). ``__call__(state, draws) → (state, losses)``:
    ``draws`` maps names to CPU tensors ``[N, ...]``, one row a step, the
    same names every call; the state is updated in place and its ``step``
    advanced by N.

    After the first call on the card: ``capture_s`` (the capture's host
    seconds, its warm-up step included), ``graph_bytes`` (the device memory
    the capture allocated, ``torch.cuda.max_memory_allocated`` around it)
    and ``pool_bytes`` (what its pool reserved, ``torch.cuda.memory_reserved``
    around it)."""

    def __init__(self, state, loss_fn: Callable[..., torch.Tensor], steps_per_call: int):
        if steps_per_call < 1:
            raise ValueError(f"steps_per_call must be >= 1, got {steps_per_call}")
        super().__init__(next(iter(next(iter(state.params.values())).values())).device)
        self.loss_fn = loss_fn
        self.steps_per_call = steps_per_call
        self.on_card = self.device.type == "cuda"
        self.buffers: Optional[Dict[str, torch.Tensor]] = None
        self.losses = torch.zeros(steps_per_call, device=self.device)
        self.counter = torch.zeros(1, dtype=torch.int64, device=self.device)
        self._state = state

    def _step(self) -> None:
        """One train step on the draws at the counter, between the marks of
        ``marked_step``; it advances the counter and waits for nothing, so
        it can be captured."""
        optimizer = self._state.optimizer
        lr = []

        def forward():
            draw = {name: buf.index_select(0, self.counter)[0]
                    for name, buf in self.buffers.items()}
            lr.append(draw.pop("lr"))
            loss = self.loss_fn(self._state.params, **draw)
            if loss.dtype != self.losses.dtype:
                raise TypeError(f"GraphStep: the loss is {loss.dtype}, the loss buffer "
                                f"{self.losses.dtype}")
            return loss

        def backward(loss):
            optimizer.zero_grad(set_to_none=True)
            loss.backward()

        def update():
            set_learning_rate(optimizer, lr[0])
            optimizer.step()

        loss = marked_step(self.device, forward, backward, update)
        self.losses.index_copy_(0, self.counter, loss.detach().reshape(1))
        self.counter.add_(1)

    def _capture(self) -> None:
        """The call's first step eagerly on a side stream, then the capture
        of one step (executed only by replays)."""
        # the gradients are made in the graph's pool, written by its backward
        self.capture(self._step, lambda: self._state.optimizer.zero_grad(set_to_none=True))

    def __call__(self, state, draws: Dict[str, torch.Tensor]):
        if state is not self._state:
            raise ValueError("GraphStep: called with another state than it was built for")
        chunk = len(next(iter(draws.values())))
        if not 0 < chunk <= self.steps_per_call:
            raise ValueError(f"GraphStep: {chunk} steps in a call of at most "
                             f"{self.steps_per_call}")
        with span("fgc.loop.stage_draws"):
            draws = {**draws, "lr": torch.tensor(
                [state.schedule(state.step + j) for j in range(chunk)], dtype=torch.float64)}
            if self.buffers is None:
                self.buffers = {name: torch.zeros((self.steps_per_call, *d.shape[1:]),
                                                  dtype=d.dtype, device=self.device)
                                for name, d in draws.items()}
            if set(draws) != set(self.buffers):
                raise ValueError(f"GraphStep: draws {sorted(draws)}, want {sorted(self.buffers)}")
            self.counter.zero_()
            for name, d in draws.items():
                if len(d) != chunk:
                    raise ValueError(f"GraphStep: {len(d)} rows of {name!r}, want {chunk}")
                self.buffers[name][:chunk].copy_(d.pin_memory() if self.on_card else d,
                                                 non_blocking=self.on_card)
        state.step += chunk
        if not self.on_card:
            for _ in range(chunk):
                self._step()
            return state, CallLosses(self.losses[:chunk].clone(), None)
        done = 0
        if self.graph is None:
            self._capture()
            done = 1
        with span("fgc.loop.replay"):
            for _ in range(chunk - done):
                self.graph.replay()
            host = torch.empty(chunk, pin_memory=True)
            host.copy_(self.losses[:chunk], non_blocking=True)
            event = torch.cuda.Event()
            event.record()
        return state, CallLosses(host, event)


_SIDE_STREAMS: Dict[torch.device, "torch.cuda.Stream"] = {}
_NO_KEY = object()


def _side_stream(device: torch.device) -> "torch.cuda.Stream":
    """One side stream a device for every capture's warm-up step: the
    allocator caches a stream's freed blocks for that stream alone, so a new
    stream a capture would keep another step's worth of blocks each."""
    if device not in _SIDE_STREAMS:
        _SIDE_STREAMS[device] = torch.cuda.Stream(device)
    return _SIDE_STREAMS[device]


class GraphCache:
    """:class:`CapturedGraph` s by key (a vertex patch's :class:`GraphStep`
    each, or a server's batched forward), least recently used first, held to
    ``budget_bytes`` of device memory (None: no budget, as on the CPU, where
    nothing is captured) and to ``max_entries`` entries (None: no bound).

    :meth:`get` returns the key's entry, or makes one with ``make()``; before
    making one it releases the least recently used entries until one more
    fits ``max_entries`` and what they hold plus the new one's size fits the
    budget, sizing the new one as the largest ``held_bytes`` it has seen (0
    before any capture). A released key is made, and on the card captured,
    again at its next use.
    ``captures`` counts the entries made (on the card, each captures its
    graph at its first call), ``evictions`` the entries released and
    ``switches`` the gets whose key differs from the previous get's (the
    first get has none before it); each get is the span
    ``fgc.graphs.get``, with ``fgc.graphs.switch`` inside it on a switch;
    ``peak_held`` is the most its entries held at once (past the budget
    only where a new graph outgrew every one before it)."""

    def __init__(self, budget_bytes: Optional[int] = None, max_entries: Optional[int] = None):
        self.budget_bytes = budget_bytes
        self.max_entries = max_entries
        self.entries: "OrderedDict[Hashable, CapturedGraph]" = OrderedDict()
        self.captures = 0
        self.evictions = 0
        self.switches = 0
        self._last_key = _NO_KEY
        self.largest = 0
        self.peak_held = 0

    def held_bytes(self) -> int:
        return sum(e.held_bytes for e in self.entries.values())

    def observe(self) -> None:
        """Take in what the entries hold now (a capture happens at an
        entry's first call, after :meth:`get`)."""
        for entry in self.entries.values():
            self.largest = max(self.largest, entry.held_bytes)
        self.peak_held = max(self.peak_held, self.held_bytes())

    def _full(self) -> bool:
        """No room for one more entry."""
        if self.max_entries is not None and len(self.entries) >= self.max_entries:
            return True
        return (self.budget_bytes is not None
                and self.held_bytes() + self.largest > self.budget_bytes)

    def get(self, key: Hashable, make: Callable[[], CapturedGraph]) -> CapturedGraph:
        with span("fgc.graphs.get"):
            switch = self._last_key is not _NO_KEY and key != self._last_key
            self._last_key = key
            self.switches += switch
            with span("fgc.graphs.switch") if switch else contextlib.nullcontext():
                return self._get(key, make)

    def _get(self, key: Hashable, make: Callable[[], CapturedGraph]) -> CapturedGraph:
        self.observe()
        entry = self.entries.pop(key, None)
        if entry is None:
            held = self.held_bytes()
            while self.entries and self._full():
                self.entries.popitem(last=False)[1].release()
                self.evictions += 1
            if self.held_bytes() < held:
                torch.cuda.empty_cache()        # the released pools, back to the device
            entry = make()
            self.captures += 1
        self.entries[key] = entry
        return entry


def default_graph_budget(device: torch.device) -> Optional[int]:
    """Half the card's free memory now (the rest for the eager warm-up of a
    capture, the tables and the optimizer), or None on the CPU."""
    if device.type != "cuda":
        return None
    return torch.cuda.mem_get_info(device)[0] // 2
