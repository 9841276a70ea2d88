"""KITTI odometry dataset I/O.

Port of ``visual_odom_tpu/io/kitti.py``:

- the image layout ``<seq>/image_0/%06d.png`` (left) and ``image_1``
  (right), read as grayscale (reference loadImageLeft/Right,
  src/utils.cpp:172-190), through ``KittiSequence``;
- pose files: rows of 12 floats, the top 3x4 of a 4x4 pose (reference
  loadPoses, src/evaluate/evaluate_odometry.cpp:17-33), read into float64
  and written as ``%.9e`` so the devkit scorer takes the port's results as
  they are.

A sequence finds its own length, and ends at the last good frame where a
PNG is missing or does not decode (the reference crashes there,
src/main.cpp:123, src/utils.cpp:178), so a partial run stays scorable.
"""

from __future__ import annotations

import os
import sys
from typing import Iterator

import numpy as np


def _imread_gray(path: str) -> np.ndarray:
    """Grayscale image load matching cv::imread + BGR2GRAY rounding: the
    native decoder (``io.native``, the same BT.601 fixed-point weights)
    first for a PNG, then cv2, then PIL."""
    if path.endswith(".png"):
        from visual_odom_tpu_torch.io import native

        if native.available():
            try:
                return native.decode_png_gray(path)
            except OSError:
                pass  # a PNG flavour it does not take -> the fallbacks
    try:
        import cv2

        img = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
        if img is None:
            raise FileNotFoundError(path)
        return img
    except ImportError:
        from PIL import Image

        return np.asarray(Image.open(path).convert("L"))


class KittiSequence:
    """Random-access (left, right) grayscale uint8 frames of one KITTI
    sequence directory."""

    def __init__(self, path: str):
        self.path = path
        self.left_dir = os.path.join(path, "image_0")
        self.right_dir = os.path.join(path, "image_1")
        n = 0
        while os.path.exists(os.path.join(self.left_dir, f"{n:06d}.png")):
            n += 1
        self.num_frames = n
        if n == 0:
            raise FileNotFoundError(f"no frames under {self.left_dir}")

    def frame(self, i: int) -> tuple[np.ndarray, np.ndarray]:
        left = _imread_gray(os.path.join(self.left_dir, f"{i:06d}.png"))
        right = _imread_gray(os.path.join(self.right_dir, f"{i:06d}.png"))
        return left, right

    def __len__(self) -> int:
        return self.num_frames

    def __iter__(self) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        """Every frame in order; a missing or undecodable frame ends the
        sequence at the last good one, with a warning on stderr."""
        for i in range(self.num_frames):
            try:
                yield self.frame(i)
            except (OSError, ValueError) as e:  # missing file, bad PNG, ...
                print(f"warning: frame {i} unreadable ({e!r}); "
                      f"ending sequence at {i} frames", file=sys.stderr)
                return

    def iter_prefetched(self, n_threads: int = 4, capacity: int = 16,
                        max_frames: int = 0,
                        ) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        """Frames through the native multithreaded prefetcher, so PNG
        decode overlaps the caller's work; one ring over L0, R0, L1, R1,
        ... keeps the pairs in lockstep, and a frame that does not decode
        ends the stream with a warning on stderr. Without the native
        runtime the frames are read by ``frame`` in turn."""
        n = self.num_frames if not max_frames else min(self.num_frames,
                                                       max_frames)
        from visual_odom_tpu_torch.io import native

        if not native.available():
            for i in range(n):
                yield self.frame(i)
            return
        paths = []
        for i in range(n):
            paths.append(os.path.join(self.left_dir, f"{i:06d}.png"))
            paths.append(os.path.join(self.right_dir, f"{i:06d}.png"))
        loader = native.PrefetchingLoader(paths, n_threads=n_threads,
                                          capacity=capacity)
        try:
            while True:
                try:
                    a = loader.next_frame()
                    if a is None:
                        return
                    b = loader.next_frame()
                    if b is None:
                        return
                except (OSError, ValueError) as e:  # truncated/corrupt PNG
                    print(f"warning: unreadable frame in prefetch stream "
                          f"({e!r}); ending sequence early", file=sys.stderr)
                    return
                yield a[1], b[1]
        finally:
            loader.close()


def load_poses(path: str) -> np.ndarray:
    """(N, 4, 4) float64 poses from a KITTI 12-float-per-row file."""
    rows = np.loadtxt(path, dtype=np.float64)
    if rows.ndim == 1:
        rows = rows[None]
    if rows.shape[1] != 12:
        raise ValueError(f"expected 12 values per row in {path}, got "
                         f"{rows.shape[1]}")
    n = rows.shape[0]
    poses = np.tile(np.eye(4, dtype=np.float64), (n, 1, 1))
    poses[:, :3, :] = rows.reshape(n, 3, 4)
    return poses


def save_poses_kitti(path: str, poses: np.ndarray) -> None:
    """Write (N, 4, 4) poses as KITTI 12-float rows (devkit input format)."""
    rows = np.asarray(poses)[:, :3, :].reshape(len(poses), 12)
    np.savetxt(path, rows, fmt="%.9e")


class PoseWriter:
    """Streaming KITTI-format pose writer: each pose reaches the disk as it
    is appended, so a run cut short leaves a scorable prefix."""

    def __init__(self, path: str):
        self._f = open(path, "w")

    def append(self, pose: np.ndarray) -> None:
        row = np.asarray(pose, dtype=np.float64)[:3, :].reshape(12)
        self._f.write(" ".join(f"{v:.9e}" for v in row) + "\n")
        self._f.flush()

    def close(self) -> None:
        self._f.close()
