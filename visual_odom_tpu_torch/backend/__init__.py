"""Pose estimation (PnP-RANSAC) and the acceptance gates."""

from visual_odom_tpu_torch.backend.integrate import (gate_and_integrate,
                                                     integrate_pose_host,
                                                     pose_delta)
from visual_odom_tpu_torch.backend.pnp import PnPResult, pnp_ransac

__all__ = [
    "pnp_ransac",
    "PnPResult",
    "pose_delta",
    "gate_and_integrate",
    "integrate_pose_host",
]
