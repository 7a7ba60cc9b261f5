"""The port's tracer (``utils/profiling.py``) on the CPU: span totals and
their outermost-prefix seconds, spans in a ``torch.profiler`` trace by
name and containment, no ``record_function`` without a profiler, marks
that are identities launching nothing on the CPU, ``GraphCache.switches``,
``capture_s`` from the capture's span, and the spans of the host stages
(the draws' staging, the losses' wait, the set-up's dataset, partition
and upload, the step's mask), and a launcher in ``csrc/trace_mark.cu`` for
every mark."""

import contextlib
import os
import re

import numpy as np
import pytest
import torch

from facet_graph_convolution_torch.config import default_config
from facet_graph_convolution_torch.data.dataset import TrainingSet
from facet_graph_convolution_torch.data.synthetic import add_vertex_noise, icosphere
from facet_graph_convolution_torch.ops import cuda_library
from facet_graph_convolution_torch.parallel.halo import (
    _prepare_sharded_mesh_arrays,
    sample_mask_from,
    shard_rows,
)
from facet_graph_convolution_torch.parallel.mesh import make_mesh
from facet_graph_convolution_torch.training import graph_step
from facet_graph_convolution_torch.training.graph_step import CapturedGraph, GraphCache
from facet_graph_convolution_torch.utils.profiling import (
    MARKS,
    mark,
    mark_grad,
    marked_step,
    reset,
    span,
    totals,
)


@pytest.fixture(autouse=True)
def fresh_totals():
    reset()
    yield
    reset()


@pytest.fixture
def no_library(monkeypatch):
    """Loading or building a CUDA library fails the test."""
    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA library was loaded on the CPU")

    monkeypatch.setattr(cuda_library, "load", refuse)
    monkeypatch.setattr(cuda_library, "build", refuse)


def test_span_totals_and_outermost_prefix_seconds():
    with span("fgc.t.outer") as outer:
        for _ in range(3):
            with span("fgc.t.inner"):
                with span("fgc.u.other"):
                    pass
    with span("fgc.t.inner") as alone:
        pass
    got = totals()
    assert set(got) == {"fgc.t.outer", "fgc.t.inner", "fgc.u.other"}
    assert got["fgc.t.outer"]["count"] == 1 and got["fgc.t.inner"]["count"] == 4
    assert got["fgc.t.outer"]["seconds"] == outer.seconds > 0
    assert got["fgc.t.outer"]["outer_seconds"] == outer.seconds
    # three inner spans ran inside an fgc.t span, one alone
    assert got["fgc.t.inner"]["outer_seconds"] == alone.seconds
    assert got["fgc.t.inner"]["seconds"] > alone.seconds
    # another prefix is outermost of its own inside fgc.t spans
    assert got["fgc.u.other"]["outer_seconds"] == got["fgc.u.other"]["seconds"]
    assert got["fgc.u.other"]["count"] == 3
    reset()
    assert totals() == {}


def test_span_adds_its_seconds_when_the_block_raises():
    with pytest.raises(KeyError):
        with span("fgc.t.raises"):
            raise KeyError("x")
    assert totals()["fgc.t.raises"]["count"] == 1
    with span("fgc.t.after"):
        pass
    # the raising span closed: the next one of its prefix is outermost again
    assert totals()["fgc.t.after"]["outer_seconds"] > 0


def test_spans_land_in_a_cpu_profile_by_name_and_nest():
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("fgc.t.parent"):
            with span("fgc.t.child"):
                torch.ones(16).sum()
            torch.ones(4).sum()
    events = {e.name: e for e in prof.events() if e.name.startswith("fgc.")}
    assert set(events) == {"fgc.t.parent", "fgc.t.child"}
    parent, child = events["fgc.t.parent"].time_range, events["fgc.t.child"].time_range
    assert parent.start <= child.start <= child.end <= parent.end
    sums = [e.time_range for e in prof.events() if e.name == "aten::sum"]
    assert sum(child.start <= r.start and r.end <= child.end for r in sums) == 1
    assert totals()["fgc.t.child"]["count"] == 1


def test_no_record_function_without_a_profiler(monkeypatch):
    entered = []

    class Counting(contextlib.nullcontext):
        def __init__(self, name, args=None):
            entered.append(name)
            super().__init__()

    monkeypatch.setattr(torch.profiler, "record_function", Counting)
    with span("fgc.t.quiet"):
        pass
    assert entered == [] and totals()["fgc.t.quiet"]["count"] == 1
    monkeypatch.setattr(torch.autograd, "_profiler_enabled", lambda: True)
    with span("fgc.t.loud"):
        pass
    assert entered == ["fgc.t.loud"]


def test_marks_are_identities_on_the_cpu(no_library):
    rng = np.random.default_rng(0)
    a = torch.tensor(rng.standard_normal((5, 3)), requires_grad=True)
    b = torch.tensor(rng.standard_normal((5, 3)), requires_grad=True)
    w = torch.tensor(rng.standard_normal((5, 3)))

    def loss(x, y):
        return ((x * y).sin() * w).sum() + (y ** 2).sum()

    want = torch.autograd.grad(loss(a, b), (a, b))
    ma, mb = mark_grad([a, b], "solver_begin", "solver_bwd_end")
    assert torch.equal(ma, a) and torch.equal(mb, b)
    (out,) = mark_grad([loss(ma, mb)], "solver_end", "solver_bwd_begin")
    got = torch.autograd.grad(out, (a, b))
    for g, h in zip(got, want):
        torch.testing.assert_close(g, h, rtol=0, atol=0)
    # one of two outputs unused: its gradient stays None, the other flows
    ma, mb = mark_grad([a, b], "solver_begin", "solver_bwd_end")
    (ga,) = torch.autograd.grad(ma.sum(), (a,))
    assert torch.equal(ga, torch.ones_like(a))
    with torch.no_grad():
        (c,) = mark_grad([a], "fwd_end", "bwd_end")
    assert torch.equal(c, a)
    mark("step_begin", "cpu")
    with pytest.raises(ValueError, match="unknown mark"):
        mark("nowhere", "cpu")
    with pytest.raises(ValueError, match="unknown mark"):
        mark_grad([a], "step_begin", "nowhere")


def test_marked_step_runs_the_phases_in_order_with_spans(no_library):
    order = []
    loss = marked_step("cpu", lambda: order.append("forward") or torch.tensor(2.0),
                       lambda l: order.append(("backward", float(l))),
                       lambda: order.append("update"), spans="fgc.t")
    assert float(loss) == 2.0 and order == ["forward", ("backward", 2.0), "update"]
    assert {k: v["count"] for k, v in totals().items()} == {
        "fgc.t.forward": 1, "fgc.t.backward": 1, "fgc.t.adam": 1}
    marked_step("cpu", lambda: torch.tensor(1.0), lambda l: None, lambda: None)
    assert sum(v["count"] for v in totals().values()) == 3     # no spans without a prefix


def test_graph_cache_counts_switches_only_on_key_changes():
    cache = GraphCache()
    made = []

    def make():
        made.append(1)
        return CapturedGraph(torch.device("cpu"))

    for key in ["a", "a", "b", "b", "b", "a", "c", "c", "a"]:
        cache.get(key, make)
    assert cache.switches == 4 and cache.captures == len(made) == 3
    got = totals()
    assert got["fgc.graphs.get"]["count"] == 9
    assert got["fgc.graphs.switch"]["count"] == 4
    # a switch is a get's child
    assert got["fgc.graphs.switch"]["outer_seconds"] == 0.0
    assert got["fgc.graphs.get"]["outer_seconds"] == got["fgc.graphs.get"]["seconds"]


def test_capture_s_is_the_capture_span(monkeypatch):
    """The capture with the card's calls stubbed (the CPU stub path)."""
    class Graph:
        def reset(self):
            pass

    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda *a: 100)
    monkeypatch.setattr(torch.cuda, "memory_reserved", lambda *a: 1000)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 300)
    monkeypatch.setattr(torch.cuda, "reset_peak_memory_stats", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", Graph)
    monkeypatch.setattr(torch.cuda, "graph", lambda g: contextlib.nullcontext())
    ran = []
    entry = CapturedGraph(torch.device("cpu"))
    entry.capture(lambda: ran.append("body"), lambda: ran.append("before"), warm_up=False)
    assert ran == ["before", "body"] and entry.captures == 1
    assert entry.capture_s > 0
    assert entry.capture_s == totals()["fgc.graph.capture"]["seconds"]
    assert entry.graph_bytes == 200 and entry.held_bytes == 200


def test_graph_step_stages_draws_and_reads_losses_in_spans(no_library):
    from facet_graph_convolution_torch.training.trainer import create_train_state

    cfg = default_config("./").replace(model={"channels": (4, 8, 8), "num_filters": 3,
                                              "fc_channels": 8})
    state = create_train_state(cfg, device="cpu")
    w = next(iter(next(iter(state.params.values())).values()))

    def loss_fn(params, scale):
        return (w.sum() * scale).reshape(())

    step = graph_step.GraphStep(state, loss_fn, steps_per_call=3)
    _, losses = step(state, {"scale": torch.ones(2)})
    assert losses.numpy().shape == (2,)
    got = totals()
    assert got["fgc.loop.stage_draws"]["count"] == 1
    assert got["fgc.loop.read_losses"]["count"] == 1
    assert "fgc.loop.replay" not in got            # the CPU runs its steps eagerly


def test_set_up_spans_of_the_dataset_upload_and_mask():
    """The dataset's spans, the sharded trainer's partition and upload, and
    the step's mask, whose rows open no upload span."""
    v, f = icosphere(3)
    ds = TrainingSet(max_patch_size=400, coarsening_steps=2, coarsening_levels=3, k_faces=23,
                     seed=0)
    ds.add_mesh(add_vertex_noise(v, f, 0.2, np.random.default_rng(0)), f, gt_vertices=v)
    got = totals()
    assert got["fgc.prep.dataset"]["count"] == 1
    assert got["fgc.prep.coarsen"]["count"] == len(ds.patches) > 1
    assert got["fgc.prep.patching"]["count"] >= len(ds.patches)
    for child in ("fgc.prep.mesh_tables", "fgc.prep.patching", "fgc.prep.coarsen"):
        assert got[child]["outer_seconds"] == 0.0
    outer = sum(t["outer_seconds"] for k, t in got.items() if k.startswith("fgc.prep."))
    assert outer == got["fgc.prep.dataset"]["seconds"]

    reset()
    cfg = default_config("./").replace(model={"coarsening_steps": 2, "coarsening_levels": 3})
    group = make_mesh("cpu")
    part, x, gt, num_nodes = _prepare_sharded_mesh_arrays(cfg, ds.patches[0], group)
    assert x.shape[0] == gt.shape[0] == num_nodes == part.levels[0].block
    got = totals()
    assert got["fgc.prep.partition"]["count"] == 1 and got["fgc.prep.upload"]["count"] == 1

    # a step's rows and its mask are no set-up upload: shard_rows opens no span
    reset()
    rows = shard_rows(np.ones((8, 3), np.float32), group)
    mask = sample_mask_from(np.array([1, 5]), 8, group)
    assert rows.shape == (8, 3) and mask.tolist() == [0, 1, 0, 0, 0, 1, 0, 0]
    assert set(totals()) == {"fgc.sharded.sample_mask"}


def test_every_mark_has_its_kernel_and_launcher():
    src = os.path.join(os.path.dirname(cuda_library.__file__), os.pardir, "csrc",
                       "trace_mark.cu")
    with open(src) as fh:
        defined = re.findall(r"^FGC_MARK\((\w+)\)$", fh.read(), re.M)
    assert defined == list(MARKS)
