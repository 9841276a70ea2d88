"""Pose gating.

Port of ``visual_odom_tpu/backend/integrate.py:gate_and_integrate``: the
reference's Euler gate (every |angle| < 0.1 rad, src/main.cpp:196-208) and
scale gate (0.05 < ||t|| < 10, src/utils.cpp:71-84). The device returns
T^-1 and the accept flag; the host chains poses in float64
(``runner.pipeline.chain_poses_host``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from visual_odom_tpu_torch.core.lie import (rodrigues, rotation_to_euler,
                                            se3_inverse, se3_matrix)


class PoseGate(NamedTuple):
    T_inv: torch.Tensor    # (4, 4) frame delta inverse
    accept: torch.Tensor   # () bool, both gates passed
    scale: torch.Tensor    # () ||t||
    euler: torch.Tensor    # (3,) diagnostic


def gate_and_integrate(rvec: torch.Tensor, tvec: torch.Tensor) -> PoseGate:
    """Apply both reference gates to a solved (rvec, t) frame delta."""
    R = rodrigues(rvec)
    euler = rotation_to_euler(R)
    rot_ok = torch.all(torch.abs(euler) < 0.1)
    scale = torch.sqrt((tvec * tvec).sum())
    scale_ok = (scale > 0.05) & (scale < 10.0)
    return PoseGate(T_inv=se3_inverse(se3_matrix(R, tvec)),
                    accept=rot_ok & scale_ok, scale=scale, euler=euler)
