"""The traced part of a run: ``torch.profiler`` over it, reduced to what
the per-layer metrics and the result line read.

A run with ``--trace 1`` wraps the passes or steps it traces after its
measured window in :class:`Trace`.  The reduction keeps, from the
profiler's events inside that span: device time by kernel name, the seconds
in which any operation ran on the device (``busy_s``, the union of the
device's kernel, copy and set intervals), the device operations that took
most time, and the device's idle gaps, each named by the innermost host
operation running at the gap's middle (else, the host running Python
between operations, by the benchmark's own range around it, "<range>
(python)").
"""
from __future__ import annotations

import bisect

RANGE = "perfbench."
WINDOW = RANGE + "window"
TOP = 10


class Trace:
    """Context manager over the traced passes or steps."""

    def __init__(self):
        self.prof = None
        self.events = None

    def __enter__(self):
        import torch
        act = torch.profiler.ProfilerActivity
        self.prof = torch.profiler.profile(activities=[act.CPU, act.CUDA])
        self.prof.__enter__()
        self._range = torch.profiler.record_function(WINDOW)
        self._range.__enter__()
        return self

    def __exit__(self, *exc):
        self._range.__exit__(*exc)
        self.prof.__exit__(*exc)
        self.events = self.prof.profiler.kineto_results.events()
        return False

    def reduce(self) -> dict:
        """The reduction of the window's events (see :func:`reduce`)."""
        return reduce(self.events)


def _start(e) -> int:
    return e.start_ns() if hasattr(e, "start_ns") else int(
        e.start_us() * 1000)


def _duration(e) -> int:
    return e.duration_ns() if hasattr(e, "duration_ns") else int(
        e.duration_us() * 1000)


def _on_device(e) -> bool:
    from torch.autograd import DeviceType
    return e.device_type() == DeviceType.CUDA


def _window(events) -> tuple[int, int]:
    for e in events:
        if e.name() == WINDOW and not _on_device(e):
            s = _start(e)
            return s, s + _duration(e)
    raise RuntimeError("the trace holds no window range")


def merge(intervals: list[tuple[int, int]]) -> list[tuple[int, int]]:
    """The union of ``[start, end)`` intervals, sorted and disjoint."""
    out: list[list[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def reduce(events) -> dict:
    """``{"window_s", "busy_s", "kernels": {name: [seconds, count]},
    "device_ops": [[name, seconds]] (the most time), "idle_gaps": [[name,
    seconds]] (idle time by the host operation under it, the most
    first)}`` over the window's span."""
    w0, w1 = _window(events)
    dev, host, ranges = [], [], []
    kernels: dict[str, list] = {}
    for e in events:
        name, s, d = e.name(), _start(e), _duration(e)
        if name.startswith(RANGE):
            # the benchmark's own ranges (also mirrored on the device's
            # timeline, where they are no device work)
            if not _on_device(e) and name != WINDOW:
                ranges.append((s, s + d, name))
        elif _on_device(e):
            if s + d <= w0 or s >= w1:
                continue
            dev.append((max(s, w0), min(s + d, w1)))
            k = kernels.setdefault(name, [0.0, 0])
            k[0] += d * 1e-9
            k[1] += 1
        else:
            host.append((s, s + d, name))
    busy = merge(dev)
    busy_ns = sum(e - s for s, e in busy)
    gaps = []
    edge = w0
    for s, e in busy:
        if s > edge:
            gaps.append((edge, s))
        edge = e
    if w1 > edge:
        gaps.append((edge, w1))
    host.sort()
    ranges.sort()
    starts, rstarts = [h[0] for h in host], [r[0] for r in ranges]
    idle: dict[str, float] = {}
    for s, e in gaps:
        t = (s + e) // 2
        name = _host_at(host, starts, t) or \
            (_host_at(ranges, rstarts, t) or "outside") + " (python)"
        idle[name] = idle.get(name, 0.0) + (e - s) * 1e-9
    ops = sorted(([n, v[0]] for n, v in kernels.items()),
                 key=lambda r: -r[1])[:TOP]
    return {"window_s": (w1 - w0) * 1e-9, "busy_s": busy_ns * 1e-9,
            "kernels": kernels, "device_ops": ops,
            "idle_gaps": sorted(([n, v] for n, v in idle.items()),
                                key=lambda r: -r[1])[:TOP]}


#: how many host events before a time :func:`_host_at` looks back through
LOOK_BACK = 256


def _host_at(host, starts, t: int) -> str | None:
    """The innermost of ``host``'s operations running at ``t`` (the
    latest-started one that has not ended, among the :data:`LOOK_BACK`
    that started last before it), or None."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(-1, i - LOOK_BACK), -1):
        if host[j][1] > t:
            return host[j][2]
    return None
