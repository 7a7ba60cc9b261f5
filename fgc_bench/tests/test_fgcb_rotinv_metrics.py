"""The readers of the rotation-invariant conv's metrics against stretches
made by hand: ``rotinv_conv_ms`` from the conv's four marks (forward and
backward phases, the marks left out, nothing without them), and K3's two
roofline shares against bounds counted by hand on a small level graph."""

from types import SimpleNamespace

import numpy as np
import pytest

from fgc_bench.core import peaks
from fgc_bench.core.trace import Stretch, _union_s
from fgc_bench.metrics import k3_bwd_roofline_pct, k3_fwd_roofline_pct, rotinv_conv_ms
from fgc_bench.reference.graph import LevelGraph
from fgc_bench.tests.tiny import TINY_CONFIG

# two steps (microseconds on the profiler's clock)
DEVICE = [
    ("fgc_mark_step_begin", 0, 1), ("fgc_mark_rotinv_begin", 1, 2), ("gather", 2, 6),
    ("void (anonymous namespace)::weighted_aggregate_kernel<float, 9, 6>(float const*)", 5, 9),
    ("fgc_mark_rotinv_end", 9, 10), ("gemm", 10, 20), ("fgc_mark_fwd_end", 20, 21),
    ("gemm", 21, 30), ("fgc_mark_rotinv_bwd_begin", 30, 31),
    ("void (anonymous namespace)::weighted_aggregate_bwd_kernel<float, 9, 6>(float const*)", 31, 37),
    ("sum", 40, 42),                           # an idle hole 37..40 inside the backward
    ("fgc_mark_rotinv_bwd_end", 42, 43), ("fgc_mark_bwd_end", 43, 44),
    ("fgc_mark_step_begin", 100, 101), ("fgc_mark_rotinv_begin", 101, 102),
    ("void (anonymous namespace)::weighted_aggregate_kernel<float, 9, 6>(float const*)", 102, 106),
    ("fgc_mark_rotinv_end", 106, 107), ("fgc_mark_rotinv_bwd_begin", 110, 111),
    ("void (anonymous namespace)::weighted_aggregate_bwd_kernel<float, 9, 6>(float const*)", 111, 119),
    ("fgc_mark_rotinv_bwd_end", 119, 120),
]


def _stretch(device=DEVICE):
    return Stretch(list(device), [], 200e-6, _union_s(device))


def test_rotinv_conv_ms_sums_the_forward_and_backward_phases():
    ctx = SimpleNamespace(stretch=_stretch())
    # forward 2..9 (7) and 102..106 (4); backward 31..37 + 40..42 (8) and 111..119 (8)
    assert rotinv_conv_ms.read(ctx) == pytest.approx(1e-3 * ((7 + 4) / 2 + (8 + 8) / 2))


@pytest.mark.parametrize("missing", ["rotinv_begin", "rotinv_end", "rotinv_bwd_begin",
                                     "rotinv_bwd_end"])
def test_rotinv_conv_ms_reads_nothing_without_a_mark(missing):
    device = [e for e in DEVICE if e[0] != "fgc_mark_" + missing]
    assert rotinv_conv_ms.read(SimpleNamespace(stretch=_stretch(device))) is None


# a level 0 of 4 nodes, the last fake: slots (the node, then its neighbours, 4 empty)
LEVEL0 = LevelGraph(np.array([[0, 1, 2], [1, 0, 4], [2, 0, 4], [3, 4, 4]]),
                    np.array([True, True, True, False]))


class _Session:
    def __init__(self, convs):
        self.convs = convs

    def kernel_convs(self, kernel):
        return self.convs if kernel == "k3" else []

    def step_levels(self, steps):
        return [[LEVEL0] for _ in steps]


def _ctx(device=DEVICE, convs=("conv1",), config=None):
    config = dict(TINY_CONFIG, num_filters=9, **(config or {}))
    return SimpleNamespace(stretch=_stretch(device), session=_Session(list(convs)),
                           cell=SimpleNamespace(config=config), steps=[0, 1])


def test_k3_shares_against_a_hand_count():
    # 3 real nodes, S = 3 + 2 + 2 = 7 live slots, C = 6 (conv1's input), M = 9, f32
    n, s, c, m = 3, 7, 6, 9
    fwd_bytes = 4 * (s * m + s + s * c + n * m * c)
    bwd_bytes = 4 * (2 * s * m + s + s * c + n * m * c)
    fwd = max(fwd_bytes / peaks.HBM_BYTES_PER_S, s * m * (2 * c + 6) / peaks.F32_FLOPS)
    bwd = max(bwd_bytes / peaks.HBM_BYTES_PER_S, s * m * (4 * c + 10) / peaks.F32_FLOPS)
    assert k3_fwd_roofline_pct.launch_bound_s(n, s, c, m, 4) == fwd
    assert k3_bwd_roofline_pct.launch_bound_s(n, s, c, m, 4) == bwd
    ctx = _ctx()
    # two steps; K3's launches 4 + 4 us, its backward's 6 + 8 us
    assert k3_fwd_roofline_pct.read(ctx) == pytest.approx(100.0 * 2 * fwd / 8e-6)
    assert k3_bwd_roofline_pct.read(ctx) == pytest.approx(100.0 * 2 * bwd / 14e-6)
    # bfloat16 storage: x_slots, z and dz at 2 bytes, logits, rows and dlogits at 4
    half = _ctx(config={"compute_dtype": "bfloat16"})
    want = 4 * (s * m + s) + 2 * (s * c + n * m * c)
    assert k3_fwd_roofline_pct.read(half) == pytest.approx(
        100.0 * 2 * want / peaks.HBM_BYTES_PER_S / 8e-6)


def test_k3_shares_read_nothing_without_launches_or_a_k3_conv():
    no_k3 = [e for e in DEVICE if "weighted_aggregate" not in e[0]]
    for metric in (k3_fwd_roofline_pct, k3_bwd_roofline_pct):
        assert metric.read(_ctx(no_k3)) is None
        assert metric.read(_ctx(convs=())) is None


def test_k3_bound_is_scaled_down_to_the_launches_seen():
    one = [e for e in DEVICE if not ("weighted_aggregate_kernel" in e[0] and e[1] == 102)]
    full = k3_fwd_roofline_pct.read(_ctx())
    # one launch of the two steps' two: half the bound over its own 4 us
    assert k3_fwd_roofline_pct.read(_ctx(one)) == pytest.approx(full)
