"""Gyro log I/O.

A copy of ``visual_odom_tpu/io/gyro.py`` (numpy only): the reference's
gyro loader ``loadGyro`` (src/utils.cpp:137-170, declared but never
called) reads whitespace rows of ``timestamp gx gy gz``. They come back as
one (N, 4) float64 array; malformed rows are skipped rather than raising.
"""

from __future__ import annotations

import numpy as np


def load_gyro(path: str) -> np.ndarray:
    """Read ``timestamp gx gy gz`` rows -> (N, 4) float64."""
    rows = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) < 4:
                continue
            try:
                rows.append([float(v) for v in parts[:4]])
            except ValueError:
                continue
    if not rows:
        return np.zeros((0, 4), np.float64)
    return np.asarray(rows, np.float64)


def integrate_gyro(time_gyro: np.ndarray) -> np.ndarray:
    """Cumulative trapezoidal integration of body rates -> (N, 3) angles
    (rad), usable as a rotation prior for the pose gate."""
    t = time_gyro[:, 0]
    w = time_gyro[:, 1:4]
    if len(t) < 2:
        return np.zeros_like(w)
    dt = np.diff(t)
    mid = 0.5 * (w[1:] + w[:-1]) * dt[:, None]
    return np.concatenate([np.zeros((1, 3)), np.cumsum(mid, axis=0)])
