"""One ``torch.profiler`` trace of a short stretch of serving, reduced to
what the per-layer metrics and the result line read.

The trace is taken after the measured window, so the window's numbers are
those of an untraced run. It starts and stops on a synchronized device, so
every kernel the traced steps launched lies inside it, and nothing from
before. The raw events are read straight from the profiler's results
(``kineto_results.events()``), without building its event tree.

A trace of the device alone (``host=False``) is what the metrics read: it
records no host operation, which would slow the host that sets the pace. A
trace with the host's operations (``host=True``) labels the device's idle
gaps by what the host was doing, for the breakdown only.
"""

from __future__ import annotations

import bisect
import time
from collections import defaultdict

import torch

TOP = 10  # entries of each breakdown list
SCAN_BACK = 256  # host events searched back for the one a gap falls in
STEP_ANNOTATION = "servebench.step"


class Trace:
    """``start`` / ``stop`` around the traced steps; then ``busy_s``,
    ``window_s``, ``kernel_s`` (device seconds by kernel name), and the
    breakdown lists (``idle_gaps`` with ``host`` only)."""

    def __init__(self, host: bool = False):
        self.host = host
        self.busy_s = self.window_s = 0.0
        self.kernel_s: dict = {}
        self.stop_s = self.read_s = 0.0
        self.n_events = 0
        self.device_ops: list = []
        self.idle_gaps: list = []
        self._prof = None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if self.host else [])
        self._prof = profile(activities=activities)
        self._prof.start()
        self._t0 = time.time_ns()

    def stop(self) -> None:
        torch.cuda.synchronize()
        t1 = time.time_ns()
        a = time.perf_counter()
        self._prof.stop()
        b = time.perf_counter()
        events = self._prof.profiler.kineto_results.events()
        self._prof = None
        self.n_events = len(events)
        self.reduce(events, self._t0, t1)
        self.stop_s, self.read_s = b - a, time.perf_counter() - b

    def reduce(self, events, t0: int, t1: int) -> None:
        dev, host = [], []
        for e in events:
            start = e.start_ns()
            end = start + e.duration_ns()
            if end <= t0 or start >= t1:
                continue
            name = e.name()
            item = (max(start, t0), min(end, t1), name)
            if e.device_type() != torch.autograd.DeviceType.CUDA:
                host.append(item)
            elif not (name == STEP_ANNOTATION or _annotation(e)):
                dev.append(item)  # an annotation's device-side copy is no operation
        self.window_s = (t1 - t0) / 1e9
        by_name = defaultdict(float)
        for a, b, name in dev:
            by_name[name] += (b - a) / 1e9
        self.kernel_s = dict(by_name)
        self.device_ops = [[short(n), s] for n, s in
                           sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]]
        merged = union(sorted((a, b) for a, b, _ in dev))
        self.busy_s = sum(b - a for a, b in merged) / 1e9
        if not self.host:
            return
        gaps, prev = [], t0
        for a, b in merged:
            if a > prev:
                gaps.append((prev, a))
            prev = max(prev, b)
        if t1 > prev:
            gaps.append((prev, t1))
        host.sort()
        steps = [h for h in host if h[2] == STEP_ANNOTATION]
        ops = [h for h in host if h[2] != STEP_ANNOTATION]
        idle = defaultdict(float)
        for a, b in gaps:
            idle[host_label(ops, steps, (a + b) // 2)] += (b - a) / 1e9
        self.idle_gaps = [[n, s] for n, s in sorted(idle.items(), key=lambda kv: -kv[1])[:TOP]]


def union(intervals: list) -> list:
    """Sorted ``(start, end)`` pairs merged where they overlap."""
    out = []
    for a, b in intervals:
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _holder(events: list, t: int, scan: int):
    """The latest-starting of the (start-sorted) ``events`` that holds ``t``,
    searched back over at most ``scan`` of them."""
    i = bisect.bisect_right(events, (t, float("inf"), ""))
    for j in range(i - 1, max(-1, i - 1 - scan), -1):
        if events[j][0] <= t < events[j][1]:
            return events[j]
    return None


def host_label(ops: list, steps: list, t: int) -> str:
    """What the host was doing at ``t``: the innermost host operation that
    holds it, else Python inside a traced step (``steps``, the step
    annotations), else outside a step (the harness's own loop)."""
    op = _holder(ops, t, SCAN_BACK)
    if op is not None:
        return short(op[2])
    if _holder(steps, t, 1) is not None:
        return f"{STEP_ANNOTATION} (python)"
    return "outside a step"


def _annotation(e) -> bool:
    f = getattr(e, "is_user_annotation", None)
    return bool(f()) if f is not None else False


def short(name: str) -> str:
    """A kernel or operation name without its trailing argument list, at
    most 120 characters."""
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i].rstrip() or name
                break
    return name[:120]


def kernel_seconds(kernel_s: dict, patterns: tuple) -> float:
    """Device seconds of the kernels whose names hold any of ``patterns``."""
    return sum(s for name, s in kernel_s.items() if any(p in name for p in patterns))
