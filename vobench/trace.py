"""Spans, the profiled sub-window and its reduction to device numbers.

The benchmark opens its own spans around each call into a layer (a job,
the runner call, ``initialize``, ``process_frame``): ``Spans`` keeps them
in memory on the trace's clock (Unix time in ns). A traced run profiles
one sub-window of whole steps (``SubWindow``, CPU and CUDA activity,
opened and closed around a ``vobench.window`` range) and
``reduce_trace`` turns its events into the
numbers the per-layer readers take: device busy time as the union of
kernel, copy and set intervals (never a sum), kernel time and count, LK
kernel time and count, CUDA runtime calls on the host, and the
``breakdown``: the kernels that took most device time, and the longest
device idle gaps by the benchmark span the host was in.
"""

from __future__ import annotations

import contextlib
import re
import time
from typing import NamedTuple

import torch

WINDOW = "vobench.window"
#: host calls that put work on the device: kernel and graph launches,
#: copies and sets (the `cuda*` and `cu*` API entry points)
RUNTIME_CALL = re.compile(
    r"^cu(da)?(GraphLaunch|LaunchKernel|LaunchKernelEx|LaunchKernelExC|"
    r"LaunchCooperativeKernel|Memcpy\w*|Memset\w*)(_v\d+)?$")
LK_KERNEL = re.compile(r"lk_\w*kernel")
TOP = 10


class Interval(NamedTuple):
    name: str
    start: int   # ns, the trace's clock
    end: int


class Spans:
    """The benchmark's spans of one run, kept in memory."""

    def __init__(self):
        self.done: list = []

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.time_ns()
        try:
            yield
        finally:
            self.done.append(Interval(name, t0, time.time_ns()))


class SubWindow:
    """One profiled sub-window. ``start()`` and ``stop()`` may be called
    from any thread; the profile records CPU and CUDA activity of the
    whole process between them."""

    def __init__(self):
        self._prof = None
        self._range = None
        self.events = None
        self.host_start_ns = self.host_stop_ns = None

    def start(self) -> None:
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.start()
        self.host_start_ns = time.time_ns()
        self._range = torch.profiler.record_function(WINDOW)
        self._range.__enter__()

    def stop(self) -> None:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._range.__exit__(None, None, None)
        self.host_stop_ns = time.time_ns()
        self._prof.stop()
        self.events = self._prof.profiler.kineto_results.events()
        self._prof = None


def union_ns(intervals, lo: int, hi: int) -> int:
    """Length of the union of sorted ``intervals`` ((start, end) pairs)
    clipped to [lo, hi]."""
    return (hi - lo) - sum(b - a for a, b in gaps_ns(intervals, lo, hi))


def gaps_ns(intervals, lo: int, hi: int) -> list:
    """The (start, end) gaps in [lo, hi] that none of the sorted
    ``intervals`` covers."""
    out, t = [], lo
    for s, e in intervals:
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if hi > t:
        out.append((t, hi))
    return out


class DeviceTrace(NamedTuple):
    window_s: float
    busy_s: float            # union of device intervals in the window
    kernel_s: float          # sum of kernel durations
    kernels: int
    lk_kernel_s: float
    lk_kernels: int
    runtime_calls: int
    device_ops: list         # [[kernel name, seconds]], most time first
    idle_gaps: list          # [[host span, seconds]], longest first


def reduce_trace(window: SubWindow, spans=()) -> DeviceTrace:
    """The sub-window's numbers from its kineto events; idle gaps are
    named by the innermost of ``spans`` (``Interval``s on the host's clock,
    moved onto the trace's by the window's start) that covers them. One
    pass over the events: a traced job holds millions of kernels."""
    events = window.events
    cuda = torch.autograd.DeviceType.CUDA
    ns = hasattr(events[0], "start_ns") if events else True
    bounds = None
    device, calls, by_name = [], [], {}
    for e in events:
        name = e.name()
        if ns:
            s, t = e.start_ns(), e.start_ns() + e.duration_ns()
        else:
            s = int(e.start_us() * 1000)
            t = s + int(e.duration_us() * 1000)
        if e.device_type() == cuda:
            if name.startswith(WINDOW):
                continue
            device.append((s, t))
            if not name.startswith(("Memcpy", "Memset", "Memory")):
                k = by_name.get(name)
                if k is None:
                    k = by_name[name] = []
                k.append((s, t))
        elif name == WINDOW:
            bounds = (s, t)
        elif RUNTIME_CALL.match(name):
            calls.append(s)
    if bounds is None:
        raise RuntimeError("the trace holds no vobench.window range")
    lo, hi = bounds
    shift = lo - window.host_start_ns
    spans = [Interval(sp.name, sp.start + shift, sp.end + shift)
             for sp in spans]
    totals = {}          # name -> (count, ns) of kernels starting inside
    for name, ks in by_name.items():
        inside = [t - s for s, t in ks if lo <= s < hi]
        if inside:
            totals[name] = (len(inside), sum(inside))
    lk = [v for n, v in totals.items() if LK_KERNEL.search(n)]
    ops = sorted(totals.items(), key=lambda kv: -kv[1][1])[:TOP]

    def host_span(t: int) -> str:
        cover = [sp for sp in spans if sp.start <= t < sp.end]
        if not cover:
            return "outside spans"
        return min(cover, key=lambda sp: sp.end - sp.start).name

    device.sort()
    gaps = gaps_ns(device, lo, hi)
    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:TOP]
    return DeviceTrace(
        window_s=(hi - lo) / 1e9,
        busy_s=((hi - lo) - sum(b - a for a, b in gaps)) / 1e9,
        kernel_s=sum(v[1] for v in totals.values()) / 1e9,
        kernels=sum(v[0] for v in totals.values()),
        lk_kernel_s=sum(v[1] for v in lk) / 1e9,
        lk_kernels=sum(v[0] for v in lk),
        runtime_calls=sum(lo <= c < hi for c in calls),
        device_ops=[[n, v[1] / 1e9] for n, v in ops],
        idle_gaps=[[host_span((a + b) // 2), (b - a) / 1e9]
                   for a, b in longest])
