"""Pose gating.

Frozen copy of ``visual_odom_tpu_torch/backend/integrate.py`` at commit 245329126dfa,
with its imports pointed at this package: the benchmark's yardstick, which
a change to the program must not move. The text below is the original's.

Port of ``visual_odom_tpu/backend/integrate.py:gate_and_integrate``: the
reference's Euler gate (every |angle| < 0.1 rad, src/main.cpp:196-208) and
scale gate (0.05 < ||t|| < 10, src/utils.cpp:71-84). The device returns
T^-1 and the accept flag; the host chains poses in float64
(``runner.pipeline.chain_poses_host``, or ``integrate_pose_host`` one
frame at a time). ``pose_delta`` chains on the device instead.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from vobench.reference.lie import (rodrigues, rotation_to_euler,
                                            se3_inverse, se3_matrix)


class PoseGate(NamedTuple):
    T_inv: torch.Tensor    # (4, 4) frame delta inverse
    accept: torch.Tensor   # () bool, both gates passed
    scale: torch.Tensor    # () ||t||
    euler: torch.Tensor    # (3,) diagnostic


def gate_and_integrate(rvec: torch.Tensor, tvec: torch.Tensor) -> PoseGate:
    """Apply both reference gates to a solved (rvec, t) frame delta, or to
    (B, 3) batches of them."""
    R = rodrigues(rvec)
    euler = rotation_to_euler(R)
    rot_ok = torch.all(torch.abs(euler) < 0.1, dim=-1)
    scale = torch.sqrt((tvec * tvec).sum(dim=-1))
    scale_ok = (scale > 0.05) & (scale < 10.0)
    return PoseGate(T_inv=se3_inverse(se3_matrix(R, tvec)),
                    accept=rot_ok & scale_ok, scale=scale, euler=euler)


def pose_delta(frame_pose: torch.Tensor, gate: PoseGate) -> torch.Tensor:
    """Chaining on the device: ``frame_pose @ T^-1`` where the gate
    accepted, else ``frame_pose``."""
    new = torch.matmul(frame_pose, gate.T_inv.to(frame_pose.dtype))
    return torch.where(gate.accept[..., None, None], new, frame_pose)


def integrate_pose_host(frame_pose: np.ndarray, T_inv: np.ndarray,
                        accept: bool) -> np.ndarray:
    """Float64 chaining on the host (the reference's double-precision
    cv::Mat arithmetic, src/main.cpp:87 and src/utils.cpp:84)."""
    if accept:
        return frame_pose @ np.asarray(T_inv, dtype=np.float64)
    return frame_pose
