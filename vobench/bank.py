"""The frame bank: the rendered frames every cell draws its clips from.

The bank is frames 0..BANK_FRAMES-1 of the 1,025-frame ``long`` course
(1.25 m a frame, exact 90-degree turns) at 1241x376, seed 0, through KITTI
00's camera (``intrinsics``).
It is rendered by the frozen renderer (``vobench.synthetic``) on a pool of
spawned processes, all cores but one, the first time a checkout needs it,
and stored uncompressed as ``.npy`` files in a fixed directory inside this
package (``_bank/``, git-ignored); later runs read it in about a second.
The textures do not change with the run's seed: the seed picks each clip's
start in the bank and the RANSAC seeds.
"""

from __future__ import annotations

import concurrent.futures
import multiprocessing
import os
from typing import NamedTuple

import numpy as np

from vobench.reference.config import CameraIntrinsics

HERE = os.path.dirname(os.path.abspath(__file__))
BANK_DIR = os.path.join(HERE, "_bank")
COURSE = "long"
COURSE_FRAMES = 1025
BANK_FRAMES = 513
HEIGHT, WIDTH = 376, 1241
#: bump when the renderer copy or the bank's geometry changes
VERSION = 2


def intrinsics(height: int = HEIGHT, width: int = WIDTH) -> CameraIntrinsics:
    """KITTI 00's camera (``P0`` and ``P1`` of its ``calib.txt``: fx = fy =
    718.856, principal point (607.1928, 185.2157), bf = -386.1448), scaled
    to the image for renders at other sizes."""
    sx, sy = width / 1241.0, height / 376.0
    return CameraIntrinsics(
        fx=718.856 * sx, fy=718.856 * sx, cx=607.1928 * sx,
        cy=185.2157 * sy, bf=-386.1448 * sx, width=width, height=height)


class Bank(NamedTuple):
    lefts: np.ndarray    # (F, H, W) uint8
    rights: np.ndarray   # (F, H, W) uint8
    poses: np.ndarray    # (F, 4, 4) float64 ground truth


def _render_range(args):
    from vobench.synthetic import make_course

    num_frames, height, width, lo, hi = args
    seq = make_course(COURSE, intrinsics(height, width),
                      num_frames=num_frames)
    frames = [seq.frame(i) for i in range(lo, hi)]
    return (np.stack([f[0] for f in frames]),
            np.stack([f[1] for f in frames]))


def render(n: int, height: int, width: int,
           course_frames: int = COURSE_FRAMES, workers: int = None) -> Bank:
    """Frames 0..n-1 of the ``course_frames``-frame course, rendered on
    ``workers`` spawned processes (default: all cores but one)."""
    from vobench.synthetic import make_course

    workers = max(1, (os.cpu_count() or 2) - 1) if workers is None else workers
    poses = make_course(COURSE, intrinsics(height, width),
                        num_frames=course_frames).poses[:n]
    cuts = np.linspace(0, n, min(n, workers) + 1).astype(int)
    jobs = [(course_frames, height, width, int(a), int(b))
            for a, b in zip(cuts[:-1], cuts[1:]) if b > a]
    if workers == 1:
        parts = [_render_range(j) for j in jobs]
    else:
        with concurrent.futures.ProcessPoolExecutor(
                workers, mp_context=multiprocessing.get_context("spawn")) as ex:
            parts = list(ex.map(_render_range, jobs))
    return Bank(np.concatenate([p[0] for p in parts]),
                np.concatenate([p[1] for p in parts]), np.asarray(poses))


def bank_path(height: int = HEIGHT, width: int = WIDTH,
              n: int = BANK_FRAMES) -> str:
    return os.path.join(BANK_DIR, f"{COURSE}_{width}x{height}_{n}_v{VERSION}")


def load(height: int = HEIGHT, width: int = WIDTH,
         n: int = BANK_FRAMES) -> Bank:
    """The bank, rendered and stored first if this checkout has none. The
    arrays are read whole into memory, so a run does not depend on the
    page cache."""
    path = bank_path(height, width, n)
    names = ("lefts", "rights", "poses")
    if not all(os.path.exists(os.path.join(path, k + ".npy")) for k in names):
        bank = render(n, height, width)
        os.makedirs(path, exist_ok=True)
        for k, arr in zip(names, bank):
            tmp = os.path.join(path, f"{k}.tmp{os.getpid()}.npy")
            np.save(tmp, arr)
            os.replace(tmp, os.path.join(path, k + ".npy"))
    return Bank(*(np.array(np.load(os.path.join(path, k + ".npy"),
                                   mmap_mode="r")) for k in names))


class Clip:
    """``frames`` consecutive frames of the bank from ``start``: random
    access by ``frame(i)`` and ``len``, as the batched runner reads
    sequences."""

    def __init__(self, bank: Bank, start: int, frames: int):
        if start < 0 or start + frames > len(bank.lefts):
            raise ValueError(f"clip {start}+{frames} outside the bank's "
                             f"{len(bank.lefts)} frames")
        self.bank, self.start, self.frames = bank, start, frames

    def __len__(self) -> int:
        return self.frames

    def frame(self, i: int):
        j = self.start + i
        return self.bank.lefts[j], self.bank.rights[j]

    def stacks(self):
        """(lefts, rights), each (frames, H, W)."""
        s = slice(self.start, self.start + self.frames)
        return self.bank.lefts[s], self.bank.rights[s]
