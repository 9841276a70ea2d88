"""VO -> windowed-BA wiring: build BAProblems from the pipeline's tracks.

Port of ``visual_odom_tpu/ba/window.py``. The pipeline's persistent
per-feature ids key multi-frame observation tracks. This module turns a
run's per-frame TrackSnapshots into windowed bundle-adjustment problems and
smooths the frame-to-frame chained trajectory with them:

1. collect (ids, u_l, v_l, u_r, valid) per frame;
2. per W-frame window, pick the tracks observed in >= min_track_len frames,
   triangulate each from its first in-window stereo observation, and emit a
   BAProblem in the window-start camera frame (pose 0 = identity = gauge);
3. solve with ``ba.schur.ba_solve`` on the device (or a ``solver`` the
   caller passes);
4. re-chain: refined window-relative poses replace the odometry chain
   inside the window, windows compose sequentially.

Problem construction is host-side numpy glue (once per window, not in the
frame loop); the solve runs on the given device.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from visual_odom_tpu_torch import resolve_device
from visual_odom_tpu_torch.ba.problem import BAProblem, residuals
from visual_odom_tpu_torch.ba.schur import ba_solve
from visual_odom_tpu_torch.config import CameraIntrinsics
from visual_odom_tpu_torch.core.lie import rodrigues


class WindowTracks(NamedTuple):
    """Per-frame stacked snapshots over one window of F frames."""

    ids: np.ndarray     # (F, N) int32, -1 = dead slot
    obs: np.ndarray     # (F, N, 3) (u_l, v_l, u_r)
    valid: np.ndarray   # (F, N) bool


def _rot_to_rvec(R: np.ndarray) -> np.ndarray:
    """Axis-angle from rotation matrix (host, float64; matches core.lie)."""
    tr = np.clip((np.trace(R) - 1.0) * 0.5, -1.0, 1.0)
    theta = np.arccos(tr)
    if theta < 1e-10:
        return np.zeros(3)
    w = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    return w * (theta / (2.0 * np.sin(theta)))


def build_window_problem(
    tracks: WindowTracks,
    poses_w_cam: np.ndarray,
    intr: CameraIntrinsics,
    max_landmarks: int = 256,
    min_track_len: int = 3,
    min_disparity: float = 0.25,
    max_residual_px: float = 4.0,
    device=None,
) -> Optional[BAProblem]:
    """BAProblem from one window's tracks, in the window-start camera frame,
    on ``device``.

    Args:
      tracks: stacked snapshots for frames [a, a+F).
      poses_w_cam: (F, 4, 4) chained odometry poses (camera->world) of the
        window frames, the initialization BA refines.
      intr: stereo calibration.
      max_landmarks: fixed landmark capacity L (top tracks by observation
        count fill it; the rest are dropped).
      min_track_len: minimum frames a track must appear in.
      min_disparity: triangulation guard (px).
      max_residual_px: observations whose initial reprojection residual
        exceeds this are pruned as LK failures.

    Returns None when fewer than 8 usable tracks exist (not enough signal
    to constrain a solve).
    """
    dev = resolve_device(device)
    F, N = tracks.ids.shape
    ids = np.where(tracks.valid, tracks.ids, -1)

    # Track id -> observation count over the window.
    flat = ids.reshape(-1)
    live = flat[flat >= 0]
    if live.size == 0:
        return None
    uniq, counts = np.unique(live, return_counts=True)
    keep = uniq[counts >= min_track_len]
    if keep.size < 8:
        return None
    order = np.argsort(-counts[counts >= min_track_len], kind="stable")
    keep = keep[order][:max_landmarks]
    L = keep.size
    id_to_slot = {int(t): s for s, t in enumerate(keep)}

    obs = np.zeros((F, L, 3), np.float64)
    mask = np.zeros((F, L), bool)
    for f in range(F):
        for n in np.nonzero(ids[f] >= 0)[0]:
            s = id_to_slot.get(int(ids[f, n]))
            if s is not None:
                obs[f, s] = tracks.obs[f, n]
                mask[f, s] = True

    # Window-local poses: camera_j -> camera_a (local world = first frame).
    G_a_inv = np.linalg.inv(poses_w_cam[0])
    T_local = np.einsum("ij,fjk->fik", G_a_inv, poses_w_cam)  # cam_j -> local
    pose6 = np.zeros((F, 6))
    for f in range(F):
        Tcw = np.linalg.inv(T_local[f])                        # local -> cam_j
        pose6[f, :3] = _rot_to_rvec(Tcw[:3, :3])
        pose6[f, 3:] = Tcw[:3, 3]

    # Triangulate each landmark from its FIRST in-window observation.
    lms = np.zeros((L, 3))
    lm_ok = np.zeros(L, bool)
    first = np.argmax(mask, axis=0)                            # (L,)
    for s in range(L):
        if not mask[:, s].any():
            continue
        f = first[s]
        u_l, v_l, u_r = obs[f, s]
        d = u_l - u_r
        if d < min_disparity:
            continue
        z = -intr.bf / d
        x = (u_l - intr.cx) * z / intr.fx
        y = (v_l - intr.cy) * z / intr.fy
        X_cam = np.array([x, y, z, 1.0])
        lms[s] = (T_local[f] @ X_cam)[:3]
        lm_ok[s] = True

    mask = mask & lm_ok[None, :]
    if int(mask.any(axis=0).sum()) < 8:
        return None

    def t(x, dtype=torch.float32):
        return torch.tensor(x, dtype=dtype, device=dev)

    problem = BAProblem(
        poses=t(pose6), landmarks=t(lms), observations=t(obs),
        mask=t(mask, torch.bool),
        fx=float(intr.fx), fy=float(intr.fy),
        cx=float(intr.cx), cy=float(intr.cy), bf=float(intr.bf),
    )

    # Outlier pruning: the odometry initialization is good, so any
    # observation with a large initial reprojection residual is an LK
    # failure that slipped through the closure check; plain (non-robust)
    # GN would let it distort the whole window.
    r = residuals(problem).cpu().numpy()                       # (F, L, 3)
    inlier = np.abs(r).max(axis=-1) <= max_residual_px
    mask = mask & inlier
    mask = mask & (mask.sum(axis=0, keepdims=True) >= 2)      # need 2+ views
    if int(mask.any(axis=0).sum()) < 8:
        return None
    return problem._replace(mask=t(mask, torch.bool))


def _pose6_to_T_inv(pose6: np.ndarray) -> np.ndarray:
    """camera_j -> local-world 4x4 from a solved [rvec|tvec] (world->cam):
    the rotation in float32 (host), composed in float64."""
    R = rodrigues(torch.from_numpy(pose6[:3].astype(np.float32))).numpy()
    R = R.astype(np.float64)
    t = pose6[3:].astype(np.float64)
    T = np.eye(4)
    T[:3, :3] = R.T
    T[:3, 3] = -R.T @ t
    return T


def window_tracks(snapshots: list, frames) -> WindowTracks:
    """Stack the observations of ``frames`` from per-frame snapshots
    (index i = frame i+1's). Frame 0 has no own snapshot: its observations
    are the L0/R0 legs of frame 1's circular match (positions AT frame 0).
    Without them the first window's gauge pose is unobserved and the solve
    has a free rigid mode."""
    rows = []
    for f in frames:
        s = snapshots[max(f, 1) - 1]
        pl, pr = ((s.points_l0, s.points_r0) if f == 0
                  else (s.points_l1, s.points_r1))
        pl, pr = np.asarray(pl), np.asarray(pr)
        uvr = np.stack([pl[:, 0], pl[:, 1], pr[:, 0]], axis=1)
        rows.append((np.asarray(s.ids), uvr, np.asarray(s.valid)))
    return WindowTracks(ids=np.stack([r[0] for r in rows]),
                        obs=np.stack([r[1] for r in rows]),
                        valid=np.stack([r[2] for r in rows]))


def smooth_trajectory_ba(
    snapshots: list,
    poses_chained: np.ndarray,
    intr: CameraIntrinsics,
    window: int = 8,
    iterations: int = 8,
    max_landmarks: int = 256,
    min_track_len: int = 3,
    solver=None,
    huber_delta: float = 1.5,
    device=None,
) -> np.ndarray:
    """Windowed-BA smoothing of a chained VO trajectory.

    Args:
      snapshots: per-frame TrackSnapshots (numpy) for frames 1..N (index
        i = frame i+1's snapshot), as ``run_sequence_scan(...,
        collect_tracks=True)`` returns them.
      poses_chained: (N+1, 4, 4) chained odometry poses including frame 0.
      window: frames per BA window (non-overlapping, sequential).
      solver: optional override called as solver(problem) -> problem;
        defaults to ``ba_solve`` with Huber IRLS at ``huber_delta`` px (live
        tracks carry occasional outliers past the closure check; robust
        weighting bounds their influence).
      device: where the problems are built and solved.

    Returns the smoothed (N+1, 4, 4) trajectory: refined window-relative
    poses composed sequentially; frames past the last full window keep
    their odometry deltas relative to the refined chain.
    """
    dev = resolve_device(device)
    n_frames = len(poses_chained)
    out = poses_chained.astype(np.float64).copy()
    if solver is None:
        def solver(p):
            return ba_solve(p, iterations=iterations, huber_delta=huber_delta)

    a = 0
    while a + window <= n_frames:
        fr = list(range(a, a + window))
        problem = build_window_problem(
            window_tracks(snapshots, fr), out[fr], intr,
            max_landmarks=max_landmarks, min_track_len=min_track_len,
            device=dev)
        if problem is not None:
            pose6 = solver(problem).poses.cpu().numpy().astype(np.float64)
            base = out[a].copy()                   # refined start (continuity)
            prev_end = out[a + window - 1].copy()  # pre-refinement chain end
            for k, f in enumerate(fr):
                out[f] = base @ _pose6_to_T_inv(pose6[k])
            # Re-base everything after the window so downstream odometry
            # deltas ride on the refined chain end.
            if a + window < n_frames:
                shift = out[a + window - 1] @ np.linalg.inv(prev_end)
                out[a + window:] = np.einsum(
                    "ij,fjk->fik", shift, out[a + window:])
        a += window
    return out
