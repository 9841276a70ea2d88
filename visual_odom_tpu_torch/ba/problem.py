"""Windowed bundle-adjustment problem structure.

Port of ``visual_odom_tpu/ba/problem.py``. The problem is dense and masked:

- W keyframe poses (axis-angle + translation, 6 params each; pose 0 is
  gauged fixed),
- L landmarks (3 params each),
- a dense (W, L) observation grid of stereo measurements (u_left, v_left,
  u_right) with a validity mask: real tracks fill only part of the grid,
  but every Jacobian block is then one batched op.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from visual_odom_tpu_torch import resolve_device
from visual_odom_tpu_torch.core.lie import rodrigues


class BAProblem(NamedTuple):
    poses: torch.Tensor         # (W, 6) [rvec|tvec], world -> camera, f32
    landmarks: torch.Tensor     # (L, 3) world coordinates, f32
    observations: torch.Tensor  # (W, L, 3) (u_l, v_l, u_r), f32
    mask: torch.Tensor          # (W, L) bool
    fx: float
    fy: float
    cx: float
    cy: float
    bf: float                   # P_right[0, 3] = -fx * baseline


def intrinsics_of(problem: BAProblem) -> tuple:
    return (problem.fx, problem.fy, problem.cx, problem.cy, problem.bf)


def project_stereo(pose6: torch.Tensor, X: torch.Tensor, intr) -> torch.Tensor:
    """Stereo projection of (..., 3) points under one pose6: returns
    (..., 3) = (u_l, v_l, u_r). u_r = u_l + bf/z (rectified pair)."""
    fx, fy, cx, cy, bf = intr
    # A leading unit dim keeps rodrigues' angle terms 1-d: under
    # torch.func.jacfwd a 0-d tensor times a Python float gets a float64
    # tangent.
    R = rodrigues(pose6[None, :3])[0]
    p = torch.matmul(X, R.transpose(-1, -2)) + pose6[3:]
    z = torch.where(torch.abs(p[..., 2:3]) < 1e-9,
                    torch.full_like(p[..., 2:3], 1e-9), p[..., 2:3])
    u_l = p[..., 0:1] / z * fx + cx
    v_l = p[..., 1:2] / z * fy + cy
    u_r = u_l + bf / z
    return torch.cat([u_l, v_l, u_r], dim=-1)


def residuals(problem: BAProblem) -> torch.Tensor:
    """(W, L, 3) masked reprojection residuals."""
    intr = intrinsics_of(problem)
    pred = torch.func.vmap(
        lambda p: project_stereo(p, problem.landmarks, intr))(problem.poses)
    r = pred - problem.observations
    return torch.where(problem.mask[..., None], r, torch.zeros_like(r))


def total_cost(problem: BAProblem) -> torch.Tensor:
    r = residuals(problem)
    return 0.5 * torch.sum(r * r)


def synthetic_ba_problem(
    num_poses: int = 6,
    num_landmarks: int = 64,
    pixel_noise: float = 0.25,
    pose_perturb: float = 0.02,
    landmark_perturb: float = 0.1,
    seed: int = 0,
    fx: float = 718.856,
    fy: float = 718.856,
    cx: float = 607.19,
    cy: float = 185.21,
    bf: float = -386.1448,
    obs_window: int | None = None,
    device=None,
):
    """Ground-truth BA problem + perturbed initialization (for tests).

    ``obs_window`` localizes observations the way real VO tracks are: each
    landmark is assigned an anchor keyframe and observed only by poses
    within +-obs_window of it (track length <= 2*obs_window + 1). None =
    every pose observes every landmark (dense grid). The numpy draws are the
    JAX package's, in its order; the projection is float32.

    Returns (problem_init, poses_gt (W, 6), landmarks_gt (L, 3)).
    """
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    poses_gt = np.zeros((num_poses, 6))
    poses_gt[:, 5] = -0.8 * np.arange(num_poses)  # camera advancing in +z world
    poses_gt[:, :3] = rng.normal(0, 0.01, (num_poses, 3))

    landmarks_gt = np.stack(
        [
            rng.uniform(-15, 15, num_landmarks),
            rng.uniform(-4, 4, num_landmarks),
            rng.uniform(8, 50, num_landmarks) + 0.8 * num_poses,
        ],
        axis=1,
    )

    intr = (fx, fy, cx, cy, bf)
    X = torch.tensor(landmarks_gt, dtype=torch.float32)
    obs = torch.func.vmap(lambda p: project_stereo(p, X, intr))(
        torch.tensor(poses_gt, dtype=torch.float32)).numpy()
    obs = obs + rng.normal(0, pixel_noise, obs.shape)
    if obs_window is None:
        mask = np.ones((num_poses, num_landmarks), bool)
    else:
        anchor_kf = rng.integers(0, num_poses, num_landmarks)      # (L,)
        dist = np.abs(np.arange(num_poses)[:, None] - anchor_kf[None, :])
        mask = dist <= obs_window

    poses_init = poses_gt + rng.normal(0, pose_perturb, poses_gt.shape)
    poses_init[0] = poses_gt[0]  # gauge
    landmarks_init = landmarks_gt + rng.normal(0, landmark_perturb,
                                               landmarks_gt.shape)

    def t(x, dtype=torch.float32):
        return torch.tensor(x, dtype=dtype, device=dev)

    problem = BAProblem(poses=t(poses_init), landmarks=t(landmarks_init),
                        observations=t(obs), mask=t(mask, torch.bool),
                        fx=fx, fy=fy, cx=cx, cy=cy, bf=bf)
    return problem, poses_gt, landmarks_gt
