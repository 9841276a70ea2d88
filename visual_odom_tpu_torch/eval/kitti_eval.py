"""KITTI odometry devkit scoring.

A copy of ``visual_odom_tpu/eval/kitti_eval.py``, which is numpy float64
and has no JAX in it: the libviso2 devkit bundled with the reference
(src/evaluate/evaluate_odometry.cpp).

- trajectoryDistances (:35-47): cumulative GT path length.
- calcSequenceErrors (:71-116): for every 10th start frame and each segment
  length in {100, ..., 800} m (:14), pose_error =
  inv(delta_result) * delta_gt, with
  r_err = acos(clamp((trace-1)/2)) / len   (:56-62)
  t_err = ||translation|| / len            (:64-69)
  plus segment speed len / (0.1 * num_frames).
- average_errors mirrors saveStats (:376-396): mean over all segments.

ATE (not in the devkit) is the RMSE of the positions after a Horn
alignment of the result to the ground truth.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

LENGTHS = (100.0, 200.0, 300.0, 400.0, 500.0, 600.0, 700.0, 800.0)
STEP_SIZE = 10  # every second (reference :77)


@dataclass
class SegmentError:
    first_frame: int
    r_err: float   # rad per meter
    t_err: float   # dimensionless (m per m)
    length: float
    speed: float


def trajectory_distances(poses: np.ndarray) -> np.ndarray:
    """Cumulative distance along (N, 4, 4) poses (reference :35-47)."""
    d = np.diff(poses[:, :3, 3], axis=0)
    return np.concatenate([[0.0], np.cumsum(np.linalg.norm(d, axis=1))])


def _last_frame_from_segment_length(dist, first_frame, length):
    """Reference :49-54."""
    idx = np.searchsorted(dist, dist[first_frame] + length, side="right")
    return int(idx) if idx < len(dist) else -1


def rotation_error(pose_error: np.ndarray) -> float:
    """Reference :56-62."""
    d = 0.5 * (np.trace(pose_error[:3, :3]) - 1.0)
    return float(np.arccos(np.clip(d, -1.0, 1.0)))


def translation_error(pose_error: np.ndarray) -> float:
    """Reference :64-69."""
    return float(np.linalg.norm(pose_error[:3, 3]))


def calc_sequence_errors(
    poses_gt: np.ndarray, poses_result: np.ndarray
) -> list[SegmentError]:
    """Reference calcSequenceErrors (:71-116), bit-faithful structure."""
    errors: list[SegmentError] = []
    dist = trajectory_distances(poses_gt)
    n = len(poses_gt)
    for first_frame in range(0, n, STEP_SIZE):
        for length in LENGTHS:
            last_frame = _last_frame_from_segment_length(dist, first_frame, length)
            if last_frame == -1 or last_frame >= len(poses_result):
                continue
            delta_gt = np.linalg.inv(poses_gt[first_frame]) @ poses_gt[last_frame]
            delta_res = (
                np.linalg.inv(poses_result[first_frame]) @ poses_result[last_frame]
            )
            pose_error = np.linalg.inv(delta_res) @ delta_gt
            r_err = rotation_error(pose_error)
            t_err = translation_error(pose_error)
            num_frames = float(last_frame - first_frame + 1)
            speed = length / (0.1 * num_frames)
            errors.append(
                SegmentError(first_frame, r_err / length, t_err / length,
                             length, speed)
            )
    return errors


def average_errors(errors: list[SegmentError]) -> tuple[float, float]:
    """(t_err, r_err) means over all segments (reference saveStats :376-396).
    t_err is usually reported as a percentage (x100); r_err in rad/m."""
    if not errors:
        return float("nan"), float("nan")
    t = float(np.mean([e.t_err for e in errors]))
    r = float(np.mean([e.r_err for e in errors]))
    return t, r


def ate_rmse(poses_gt: np.ndarray, poses_result: np.ndarray) -> float:
    """Absolute trajectory error (RMSE of translation), after Horn alignment
    of the result to GT (standard ATE; the devkit itself does not align —
    BASELINE.md's ATE bound is computed this way)."""
    n = min(len(poses_gt), len(poses_result))
    P = poses_result[:n, :3, 3]
    Q = poses_gt[:n, :3, 3]
    mp, mq = P.mean(0), Q.mean(0)
    Pc, Qc = P - mp, Q - mq
    U, _, Vt = np.linalg.svd(Pc.T @ Qc)
    S = np.eye(3)
    if np.linalg.det(U @ Vt) < 0:
        S[2, 2] = -1
    R = (U @ S @ Vt).T
    t = mq - R @ mp
    aligned = P @ R.T + t
    return float(np.sqrt(np.mean(np.sum((aligned - Q) ** 2, axis=1))))


def rpe_errors(
    poses_gt: np.ndarray, poses_result: np.ndarray, delta: int = 1
) -> tuple[float, float]:
    """Frame-to-frame relative pose error (RMSE translation m, RMSE rotation
    rad) at frame offset ``delta``."""
    n = min(len(poses_gt), len(poses_result))
    ts, rs = [], []
    for i in range(n - delta):
        dgt = np.linalg.inv(poses_gt[i]) @ poses_gt[i + delta]
        dres = np.linalg.inv(poses_result[i]) @ poses_result[i + delta]
        err = np.linalg.inv(dres) @ dgt
        ts.append(translation_error(err))
        rs.append(rotation_error(err))
    return float(np.sqrt(np.mean(np.square(ts)))), float(
        np.sqrt(np.mean(np.square(rs)))
    )


def evaluate_sequence(poses_gt: np.ndarray, poses_result: np.ndarray) -> dict:
    """Full scorecard for one sequence."""
    segs = calc_sequence_errors(poses_gt, poses_result)
    t_err, r_err = average_errors(segs)
    rpe_t, rpe_r = rpe_errors(poses_gt, poses_result)
    return {
        "num_segments": len(segs),
        "t_err_pct": t_err * 100.0,
        "r_err_deg_per_m": np.degrees(r_err),
        "ate_rmse_m": ate_rmse(poses_gt, poses_result),
        "rpe_trans_m": rpe_t,
        "rpe_rot_deg": np.degrees(rpe_r),
    }
