"""Profiling and tracing hooks.

Port of ``visual_odom_tpu/utils/profiling.py``: the reference's clock()
prints (LK stage src/feature.cpp:135-141, PnP stage src/main.cpp:180-183,
frame time :209-213) become named ranges in a ``torch.profiler`` trace and
a Chrome trace written for offline reading, beside host wall timers.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


@contextlib.contextmanager
def stage(name: str):
    """Name a pipeline stage: a ``torch.profiler.record_function`` range,
    which a profiler running around it records (host ops, and the
    launches made inside it)."""
    with torch.profiler.record_function(name):
        yield


@contextlib.contextmanager
def trace_to(logdir: str):
    """Profile the enclosed region (the CPU, and CUDA where a card is
    present) and write it as a Chrome trace, ``trace.json``, into
    ``logdir``. Yields the profiler."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


class StageTimer:
    """Host-side wall timers printing the reference's per-stage lines
    (ms per stage + FPS) for interactive parity."""

    def __init__(self):
        self._t = {}
        self._acc = {}

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter()
        yield
        dt = (time.perf_counter() - t0) * 1000.0
        self._acc[name] = self._acc.get(name, 0.0) + dt
        self._t[name] = dt

    def last_ms(self, name: str) -> float:
        return self._t.get(name, 0.0)

    def report(self) -> dict:
        return dict(self._t)
