"""Geometry primitives: SO(3)/SE(3), small SPD solves, triangulation, and
the keyframe record."""

from visual_odom_tpu_torch.core.lie import (euler_to_rotation,
                                            is_rotation_matrix, rodrigues,
                                            rodrigues_inverse,
                                            rotation_to_euler, se3_inverse,
                                            se3_matrix)
from visual_odom_tpu_torch.core.triangulate import triangulate_points

__all__ = [
    "rodrigues",
    "rodrigues_inverse",
    "rotation_to_euler",
    "euler_to_rotation",
    "is_rotation_matrix",
    "se3_matrix",
    "se3_inverse",
    "triangulate_points",
]
