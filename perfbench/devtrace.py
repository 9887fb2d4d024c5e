"""A profiled sub-window: the device's busy time, kernel time by name, and
the idle gaps with what the host was doing in them.

The window is marked by a ``record_function`` range on the thread that
opens it, so its bounds and the kernels' intervals share the profiler's
clock.  Busy time is the union of the device intervals (kernels, copies,
sets) clipped to the window.
"""
from __future__ import annotations

import time

import torch

MARK = "perfbench.window"
TOP = 10            # entries of each breakdown list
NAME_CHARS = 160    # a kernel's name is cut to this length in the breakdown


def merge(intervals: list) -> list:
    """Sorted, disjoint union of (start, end) intervals."""
    out: list = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def summarize(window: tuple, device_events: list, host_events: list) -> dict:
    """``window`` (start, end) and events (name, start, end), all in one
    clock (ns): the busy and window seconds, each kernel name's
    [seconds, count], the top kernels and the longest idle gaps, each gap
    named by the innermost host range that covers its middle."""
    w0, w1 = window
    clipped = [(n, max(s, w0), min(e, w1)) for n, s, e in device_events
               if e > w0 and s < w1]
    busy = merge([(s, e) for _, s, e in clipped])
    kernels: dict = {}
    for n, s, e in clipped:
        k = kernels.setdefault(n, [0.0, 0])
        k[0] += (e - s) / 1e9
        k[1] += 1
    gaps, t = [], w0
    for s, e in busy:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if w1 > t:
        gaps.append((t, w1))
    gaps.sort(key=lambda g: g[0] - g[1])
    named = []
    for s, e in gaps[:TOP]:
        mid = (s + e) / 2
        cover = [(he - hs, n) for n, hs, he in host_events
                 if hs <= mid <= he and n != MARK]
        named.append([min(cover)[1] if cover else "no host range",
                      (e - s) / 1e9])
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:TOP]
    return {"busy_s": sum(e - s for s, e in busy) / 1e9,
            "window_s": (w1 - w0) / 1e9,
            "kernels": kernels,
            "breakdown": {
                "device_ops": [[n[:NAME_CHARS], v[0]] for n, v in top],
                "idle_gaps": named}}


class Profiled:
    """``with Profiled() as p:`` profiles the block on the card; ``p.result``
    is :func:`summarize` of it.  The device is synchronised at both ends,
    so the kernels in the window are those launched in it."""

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile, record_function
        torch.cuda.synchronize()
        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        self._prof.__enter__()
        self._mark = record_function(MARK)
        self._mark.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self._mark.__exit__(*exc)
        self._prof.__exit__(*exc)
        if exc[0] is None:
            self.result = self._read()
        return False

    def _read(self) -> dict:
        from torch.autograd import DeviceType
        dev, host, window = [], [], None
        for e in self._prof.profiler.kineto_results.events():
            s = e.start_ns()
            span = (e.name(), s, s + e.duration_ns())
            if e.device_type() == DeviceType.CUDA:
                # a host range's mirror on the device's timeline (the
                # window mark's among them) is no operation
                if not _annotation(e):
                    dev.append(span)
            elif e.name() == MARK:
                window = span[1:]
            else:
                host.append(span)
        if window is None:
            raise RuntimeError("the profiler recorded no window mark")
        return summarize(window, dev, host)


def _annotation(e) -> bool:
    """Whether a device-side event mirrors a host range."""
    return e.name() == MARK or e.is_user_annotation()


def kernel_seconds(kernels: dict, *needles: str) -> tuple[float, int]:
    """(seconds, launches) of the kernels whose name holds a needle."""
    sec = n = 0
    for name, (s, c) in kernels.items():
        if any(x in name for x in needles):
            sec += s
            n += c
    return sec, n
