"""The yardstick's arithmetic against hand counts: the window's rate and
tail, the kernels' bytes and operations, the step's products, the idle
share of a traced stretch."""

import numpy as np
import pytest

from fgc_bench.core import peaks
from fgc_bench.core.stats import WindowRecord, step_ms_percentile
from fgc_bench.core.trace import Stretch, _union_s
from fgc_bench.metrics import (
    device_idle_pct,
    k1_roofline_pct,
    k2_roofline_pct,
    k5_bwd_roofline_pct,
    k5_fwd_roofline_pct,
    step_mfu_pct,
)


def _window(stall_s=0.0, calls=20):
    """``calls`` calls of 10 steps over 10,000 real faces, 50 ms each; the
    middle call stalls ``stall_s`` more."""
    rec = WindowRecord(0.0)
    t = 0.0
    for call in range(calls):
        t += 0.05 + (stall_s if call == calls // 2 else 0.0)
        rec.add(10, 10_000, np.zeros(10), now=t)
    return rec


def test_rate_and_tail_of_a_steady_window():
    rec = _window()
    assert rec.steps == 200 and rec.faces == 200_000 and rec.failed == 0
    assert rec.window_s == pytest.approx(1.0)
    assert rec.faces / rec.window_s == pytest.approx(200_000.0)
    assert step_ms_percentile(rec.step_ms, 95) == pytest.approx(5.0)
    assert sum(rec.step_ms) == pytest.approx(1e3 * rec.window_s)


def test_a_stall_moves_the_tail_and_the_rate():
    steady, stalled = _window(), _window(stall_s=0.2)
    # the stalled call's 10 steps of 25 ms are 5 % of the window's steps
    assert sorted(stalled.step_ms)[-10:] == pytest.approx([25.0] * 10)
    assert step_ms_percentile(stalled.step_ms, 95) == pytest.approx(6.0)
    assert step_ms_percentile(steady.step_ms, 95) == pytest.approx(5.0)
    assert stalled.faces / stalled.window_s == pytest.approx(200_000.0 / 1.2)


def test_failed_steps_are_counted():
    rec = WindowRecord(0.0)
    rec.add(3, 30, np.array([1.0, np.nan, np.inf]), now=1.0)
    assert rec.failed == 2


def test_k1_bound_by_hand():
    # N = 4 real nodes, S = 10 live slots, C = 2, M = 3, float32
    n, s, c, m = 4, 10, 2, 3
    nbytes = 4 * (n * (c + m) + n * m + m + n * m * c) + 4 * ((s - n) + s)
    ops = s * m * (2 * c + 6)
    assert nbytes == 4 * (20 + 12 + 3 + 24) + 4 * 16 == 300
    assert ops == 300
    want = max(300 / peaks.HBM_BYTES_PER_S, 300 / peaks.F32_FLOPS)
    assert k1_roofline_pct.launch_bound_s(n, s, c, m, 4) == pytest.approx(want)


def test_k2_bound_by_hand():
    n, s, c, m = 4, 10, 2, 3
    nbytes = 4 * (2 * 20 + 2 * 12 + 3 + 24) + 4 * (2 * 6 + 10)
    ops = 10 * 3 * (4 * 2 + 10) + 6 * 5
    assert (nbytes, ops) == (452, 570)
    want = max(nbytes / peaks.HBM_BYTES_PER_S, ops / peaks.F32_FLOPS)
    assert k2_roofline_pct.conv_bound_s(n, s, c, m, 4) == pytest.approx(want)


def test_k5_bounds_by_hand():
    n, s, c, m, out = 1000, 9000, 64, 9, 32
    fwd_bytes = 4 * (1000 * 73 + 9000 + 32 * 9 * 64 + 32000) + 4 * (9 + 9000 + 8000)
    fwd = max(fwd_bytes / peaks.HBM_BYTES_PER_S, 2 * 1000 * 9 * 64 * 32 / 495e12,
              9000 * 9 * 134 / 67e12)
    assert k5_fwd_roofline_pct.conv_bound_s(n, s, c, m, out, 4, "float32") == pytest.approx(fwd)
    bwd_bytes = 4 * (2 * 73000 + 2 * 9000 + 2 * 32 * 9 * 64 + 32000) + 4 * (18 + 9000 + 16000)
    bwd = max(bwd_bytes / peaks.HBM_BYTES_PER_S, 4 * 1000 * 9 * 64 * 32 / 495e12,
              9000 * 9 * (4 * 64 + 10) / 67e12)
    assert k5_bwd_roofline_pct.conv_bound_s(n, s, c, m, out, 4, "float32") == pytest.approx(bwd)


def test_step_products_by_hand():
    config = {"channels": [2, 4, 4], "num_filters": 3, "fc_channels": 8, "out_channels": 3,
              "in_channels": 6}
    real = [16, 4, 1]
    convs = [(0, 6, 2), (1, 2, 4), (2, 4, 4), (2, 4, 4), (1, 4, 4), (1, 8, 4), (0, 4, 2),
             (0, 4, 2)]
    hand = sum(2 * real[lvl] * cin * 3 * 2 + 2 * real[lvl] * 3 * cin * cout
               for lvl, cin, cout in convs)
    hand += 2 * 16 * 2 * 8 + 2 * 16 * 8 * 3
    assert step_mfu_pct.step_products(config, 1, real) == hand
    heads = hand + 2 * 4 * 4 * 8 + 2 * 4 * 8 * 3 + 2 * 1 * 4 * 8 + 2 * 1 * 8 * 3
    assert step_mfu_pct.step_products(config, 3, real) == heads


def test_idle_share_of_a_synthetic_stretch():
    events = [("a", 0.0, 100.0), ("b", 50.0, 150.0), ("c", 300.0, 400.0)]   # µs, overlap once
    assert _union_s(events) == pytest.approx(250e-6)
    stretch = Stretch(events, [("cudaGraphLaunch", 140.0, 320.0)], window_s=500e-6,
                      busy_s=_union_s(events))

    class Ctx:
        pass

    ctx = Ctx()
    ctx.stretch = stretch
    assert device_idle_pct.read(ctx) == pytest.approx(50.0)
    assert stretch.idle_gaps() == [["cudaGraphLaunch", pytest.approx(150e-6)]]
    assert [t for _, t in stretch.top_ops()] == pytest.approx([100e-6] * 3)
