"""The traffic generator: jobs drawn from the seed, through a front door.

One general generator reads every traffic mix (``traffic/<name>.json``):
a job is ``clips`` clips of ``clip_frames`` frames of the bank, each
starting at a frame drawn from 0..``offset_max``, with a RANSAC seed drawn
beside them. Every seed gives the same sizes; only the starts and the
RANSAC seeds change. The mix's ``door`` names how a job enters the
program: the module ``vobench/doors/<door>.py``, found by that name, whose
class ``Door`` (a ``FrontDoor``) runs one job. A later mix that needs
another door adds such a file.

Jobs are a closed loop: the next starts when the last returns.
"""

from __future__ import annotations

import contextlib
import importlib
import os
from typing import NamedTuple, Optional

import numpy as np

from vobench.bank import Bank
from vobench.trace import Spans, SubWindow

HERE = os.path.dirname(os.path.abspath(__file__))


class Job(NamedTuple):
    index: int
    starts: list          # clip start frames in the bank
    ransac_seed: int      # clip b's generator is seeded ransac_seed + b
    t0: float             # perf_counter at the job's start and end
    t1: float
    steps: int            # frames that got a pose estimated (all clips)
    poses: list           # per clip (clip_frames, 4, 4) float64
    accept: list          # per clip (clip_frames - 1,) bool
    mean_inliers: list    # per clip
    counters: dict        # what the door read beside the poses, by name


def draw_job(seed: int, stream: int, index: int, traffic: dict):
    """(starts, ransac seed) of job ``index`` of ``stream`` (0: the
    window, 1: warm-up)."""
    rng = np.random.default_rng([seed, stream, index])
    starts = rng.integers(0, traffic["offset_max"] + 1,
                          traffic["clips"]).tolist()
    return starts, int(rng.integers(0, 2 ** 31))


def accepts_from_poses(poses: np.ndarray) -> np.ndarray:
    """Which steps were accepted: the chained pose moved."""
    return np.any(poses[1:] != poses[:-1], axis=(1, 2))


class FrontDoor:
    """A front door of the program, driven job by job. A door sets
    ``warm_frames`` (the short warm-up job's frames at the least) and
    ``run(index, starts, ransac_seed, frames, traced) -> Job``."""

    warm_frames = 2

    def __init__(self, traffic: dict, bank: Bank, config, intrinsics,
                 device, spans: Spans):
        self.traffic = traffic
        self.bank = bank
        self.config = config
        self.intrinsics = intrinsics
        self.device = device
        self.spans = spans
        self.trace: Optional[SubWindow] = None

    @contextlib.contextmanager
    def traced(self, on: bool):
        """Profile the enclosed job (``self.trace``) when ``on``."""
        if not on:
            yield
            return
        self.trace = SubWindow()
        self.trace.start()
        try:
            yield
        finally:
            self.trace.stop()

    def warm(self, seed: int) -> None:
        """A short job, then a whole one, through every shape the cell's
        jobs use: the captures, the LK library's load, the allocator's
        pools and the pinned host buffers."""
        full = self.traffic["clip_frames"]
        short = min(max(2, self.traffic["chunk"] + 1, self.warm_frames), full)
        for k, frames in enumerate((short, full)):
            starts, rs = draw_job(seed, 1, k, self.traffic)
            self.run(k, starts, rs, frames, traced=False)

    def job(self, seed: int, index: int, traced: bool) -> Job:
        starts, rs = draw_job(seed, 0, index, self.traffic)
        return self.run(index, starts, rs, self.traffic["clip_frames"],
                        traced)

    def memory_peak_bytes(self, chips: int) -> int:
        """Peak device memory on the fullest of the ``chips`` cards."""
        import torch

        if torch.device(self.device).type != "cuda":
            return 0
        return int(max(torch.cuda.max_memory_allocated(i)
                       for i in range(chips)))


def names() -> list:
    """The doors there are, by file."""
    return sorted(f[:-3] for f in os.listdir(HERE)
                  if f.endswith(".py") and not f.startswith("_"))


def make(traffic: dict, *args) -> FrontDoor:
    """The door ``traffic["door"]`` names, from ``doors/<door>.py``."""
    name = traffic["door"]
    if name not in names():
        raise SystemExit(f"no door {name!r} (have {names()})")
    return importlib.import_module(f"vobench.doors.{name}").Door(traffic,
                                                                 *args)
