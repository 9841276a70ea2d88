"""Keyframe record.

Port of ``visual_odom_tpu/core/frame.py``. The reference declares a
``Frame`` class (src/Frame.h:12-36: stereo projection matrices, a world
pose, matched stereo feature points and ``triangulateFeaturePoints``) that
its ``main`` never builds; here it is a dataclass of numpy arrays whose
triangulation runs the port's ``core.triangulate.triangulate_points`` on a
device (CUDA unless the caller names the CPU) and returns numpy.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from visual_odom_tpu_torch import resolve_device
from visual_odom_tpu_torch.core.triangulate import triangulate_points


@dataclass
class Frame:
    """One stereo frame: projection matrices, world pose, matched features.

    ``world_pose`` is the 4x4 camera->world transform (the reference splits
    it into m_worldRotation / m_worldTranslation, src/Frame.h:29).
    """

    frame_id: int
    proj_left: np.ndarray            # (3, 4)
    proj_right: np.ndarray           # (3, 4)
    world_pose: np.ndarray           # (4, 4)
    points_left: Optional[np.ndarray] = None   # (N, 2)
    points_right: Optional[np.ndarray] = None  # (N, 2)
    valid: Optional[np.ndarray] = field(default=None)  # (N,) bool

    def set_features(self, points_left: np.ndarray, points_right: np.ndarray,
                     valid: Optional[np.ndarray] = None) -> None:
        """Attach index-aligned stereo matches (Frame::setFeatures)."""
        self.points_left = np.asarray(points_left, np.float32)
        self.points_right = np.asarray(points_right, np.float32)
        self.valid = (np.ones(len(self.points_left), bool)
                      if valid is None else np.asarray(valid, bool))

    def triangulate_feature_points(self, device=None) -> np.ndarray:
        """DLT triangulation of the attached matches on ``device`` -> (N, 3)
        float32 points in the camera frame (Frame::triangulateFeaturePoints,
        reference src/Frame.cpp:25-28, euclidean, not homogeneous)."""
        if self.points_left is None or self.points_right is None:
            raise ValueError("set_features() before triangulating")
        dev = resolve_device(device)

        def t(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=dev)

        pts = triangulate_points(t(self.proj_left), t(self.proj_right),
                                 t(self.points_left), t(self.points_right))
        return pts.cpu().numpy()

    def points_world(self, device=None) -> np.ndarray:
        """The triangulated points lifted into the world frame by
        ``world_pose``."""
        pc = self.triangulate_feature_points(device)
        R, t = self.world_pose[:3, :3], self.world_pose[:3, 3]
        return pc @ R.T + t
