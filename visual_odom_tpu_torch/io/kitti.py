"""KITTI pose files.

The pose half of ``visual_odom_tpu/io/kitti.py``: rows of 12 floats, the
top 3x4 of a 4x4 pose (reference loadPoses,
src/evaluate/evaluate_odometry.cpp:17-33), read into float64 and written
as ``%.9e`` so the devkit scorer takes the port's results as they are.
"""

from __future__ import annotations

import numpy as np


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
