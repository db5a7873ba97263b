"""The trace's reduction: busy time as the union of the device intervals,
idle gaps by the innermost host operation open when each began, kernels
counted without copies."""

from __future__ import annotations

import pytest

from benchmark.device_trace import summarise


def test_union_gaps_and_counts():
    ms = 1_000_000  # ns
    device = [("k1", 10 * ms, 30 * ms), ("k2", 20 * ms, 40 * ms),  # overlap: 30 busy
              ("Memcpy HtoD", 50 * ms, 55 * ms), ("k1", 80 * ms, 100 * ms),
              ("k3", 95 * ms, 120 * ms)]  # the last reaches past the window
    host = [("step", 0, 110 * ms), ("aten::copy_", 39 * ms, 52 * ms),
            ("cudaLaunchKernel", 55 * ms, 60 * ms)]
    s = summarise(host, device, (0, 110 * ms), units=2)
    assert s.window_s == pytest.approx(0.110)
    assert s.busy_s == pytest.approx(0.030 + 0.005 + 0.030)
    assert s.idle_share == pytest.approx(1 - 0.065 / 0.110)
    assert s.kernels == 4
    gaps = dict((n, t) for n, t in s.idle_gaps)
    # 0-10 under "step"; 40-50 under aten::copy_ (opened at 39); 55-80 under the launch
    assert gaps == {"step": pytest.approx(0.010), "aten::copy_": pytest.approx(0.010),
                    "cudaLaunchKernel": pytest.approx(0.025)}
    ops = dict((n, t) for n, t in s.device_ops)
    assert ops["k1"] == pytest.approx(0.040) and ops["k3"] == pytest.approx(0.015)
    assert s.device_ops[0][0] == "k1"
