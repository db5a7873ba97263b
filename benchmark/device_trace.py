"""The device trace of a short traced sub-window: ``torch.profiler`` (CUPTI)
over a few steps or requests, reduced to a summary; no trace file is
written.

From the kernels' and copies' intervals on the device: the time some
operation ran (the union of the intervals, so overlapping streams count
once), the idle share of the sub-window, the operations that took the most
device time, and the idle gaps by what the host was running when each
began (the innermost host operation open at the gap's start).
"""

from __future__ import annotations

import heapq
import time
from dataclasses import dataclass, field
from typing import Callable

__all__ = ["Summary", "summarise", "traced"]

_NAME_CHARS = 160


@dataclass
class Summary:
    window_s: float
    busy_s: float
    kernels: int  # device kernels launched (copies and fills not counted)
    units: int  # steps or requests the sub-window ran
    device_ops: list = field(default_factory=list)  # [[name, seconds]], most first
    idle_gaps: list = field(default_factory=list)  # [[host op, seconds]], most first

    @property
    def idle_share(self) -> float:
        return max(0.0, 1.0 - self.busy_s / self.window_s)


def _merge(intervals):
    """Sorted, merged (start, end) pairs."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _top(totals: dict, n: int = 10) -> list:
    return [[name[:_NAME_CHARS], s] for name, s in
            sorted(totals.items(), key=lambda kv: -kv[1])[:n]]


def summarise(host: list, device: list, window: tuple, units: int) -> Summary:
    """``host`` and ``device``: (name, start_ns, end_ns) events; ``window``:
    (start_ns, end_ns) of the traced sub-window."""
    w0, w1 = window
    clipped = [(max(s, w0), min(e, w1), n) for n, s, e in device if e > w0 and s < w1]
    merged = _merge([(s, e) for s, e, _ in clipped])
    busy = sum(e - s for s, e in merged)
    by_op: dict = {}
    for s, e, name in clipped:
        by_op[name] = by_op.get(name, 0.0) + (e - s) * 1e-9
    gaps, edges = {}, [w0] + [x for iv in merged for x in iv] + [w1]
    host_sorted = sorted(host, key=lambda ev: ev[1])
    open_ops: list = []  # heap of (-start, end, name): the latest-started on top
    nxt = 0
    for g0, g1 in zip(edges[0::2], edges[1::2]):
        if g1 <= g0:
            continue
        while nxt < len(host_sorted) and host_sorted[nxt][1] <= g0:
            name, s, e = host_sorted[nxt]
            heapq.heappush(open_ops, (-s, e, name))
            nxt += 1
        while open_ops and open_ops[0][1] <= g0:  # ended before this gap: never open again
            heapq.heappop(open_ops)
        name = open_ops[0][2] if open_ops else "(host idle)"
        gaps[name] = gaps.get(name, 0.0) + (g1 - g0) * 1e-9
    kernels = sum(1 for _, _, n in clipped if not n.startswith(("Memcpy", "Memset")))
    return Summary(window_s=(w1 - w0) * 1e-9, busy_s=busy * 1e-9, kernels=kernels, units=units,
                   device_ops=_top(by_op), idle_gaps=_top(gaps))


def _events(prof, with_host: bool):
    import torch

    host, device = [], []
    for ev in prof.profiler.kineto_results.events():
        span = (ev.name(), ev.start_ns(), ev.start_ns() + ev.duration_ns())
        if ev.device_type() == torch.autograd.DeviceType.CUDA:
            if not getattr(ev, "is_user_annotation", lambda: False)():
                device.append(span)
        elif with_host:
            host.append(span)
    if not device:
        raise RuntimeError("the profiler recorded no device activity: CUPTI saw no kernel")
    return host, device


def _profiled(run: Callable[[], int], with_host: bool):
    """``run()`` under the profiler, synchronised at both ends; the window
    on the wall clock, which is the clock of the profiler's events."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if with_host else [])
    torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        w0 = time.time_ns()
        units = run()
        torch.cuda.synchronize()
        w1 = time.time_ns()
    host, device = _events(prof, with_host)
    # every operation of the window ran inside it: a device event outside it
    # is a skew between the card's clock and the host's, which widens it
    window = (min(w0, min(e[1] for e in device)), max(w1, max(e[2] for e in device)))
    return window, units, (host, device)


def traced(run: Callable[[], int], attribute: Callable[[], int]) -> Summary:
    """The summary of ``run()`` (which returns the steps or requests it ran)
    traced on the device alone, so that the host runs at its own pace; its
    idle gaps named from ``attribute()``, traced again with the host's
    operations (which slow the host: those gaps are longer than the first
    trace's, and say what the host was doing, not how long)."""
    window, units, (_, device) = _profiled(run, False)
    out = summarise([], device, window, units)
    window, units, (host, device) = _profiled(attribute, True)
    out.idle_gaps = summarise(host, device, window, units).idle_gaps
    return out
