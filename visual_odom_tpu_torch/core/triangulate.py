"""Batched linear (DLT) stereo triangulation.

Port of ``visual_odom_tpu/core/triangulate.py:triangulate_points``, the
equivalent of cv::triangulatePoints + convertPointsFromHomogeneous
(reference src/main.cpp:169-171): the rows of the 4x4 DLT system are
normalised, w is fixed to 1 and the 4x3 system is solved through its 3x3
normal equations with a closed-form adjugate inverse.
"""

from __future__ import annotations

import torch


def triangulate_points(P_left: torch.Tensor, P_right: torch.Tensor,
                       pts_left: torch.Tensor,
                       pts_right: torch.Tensor) -> torch.Tensor:
    """(3, 4) projections, (..., N, 2) pixels -> (..., N, 3) points in the
    left-camera frame."""
    Pl = P_left.to(pts_left.dtype)
    Pr = P_right.to(pts_left.dtype)
    xl, yl = pts_left[..., 0:1], pts_left[..., 1:2]
    xr, yr = pts_right[..., 0:1], pts_right[..., 1:2]
    A = torch.stack([xl * Pl[2] - Pl[0], yl * Pl[2] - Pl[1],
                     xr * Pr[2] - Pr[0], yr * Pr[2] - Pr[1]], dim=-2)
    A = A / (torch.linalg.vector_norm(A, dim=-1, keepdim=True) + 1e-12)

    M = A[..., :3]                                   # (..., N, 4, 3)
    b = -A[..., 3]                                   # (..., N, 4)
    AtA = (M[..., :, :, None] * M[..., :, None, :]).sum(dim=-3)
    Atb = (M * b[..., None]).sum(dim=-2)

    a00, a01, a02 = AtA[..., 0, 0], AtA[..., 0, 1], AtA[..., 0, 2]
    a11, a12, a22 = AtA[..., 1, 1], AtA[..., 1, 2], AtA[..., 2, 2]
    c00 = a11 * a22 - a12 * a12
    c01 = a02 * a12 - a01 * a22
    c02 = a01 * a12 - a02 * a11
    c11 = a00 * a22 - a02 * a02
    c12 = a01 * a02 - a00 * a12
    c22 = a00 * a11 - a01 * a01
    det = a00 * c00 + a01 * c01 + a02 * c02
    det = torch.where(torch.abs(det) < 1e-18, torch.full_like(det, 1e-18), det)
    b0, b1, b2 = Atb[..., 0], Atb[..., 1], Atb[..., 2]
    x = (c00 * b0 + c01 * b1 + c02 * b2) / det
    y = (c01 * b0 + c11 * b1 + c12 * b2) / det
    z = (c02 * b0 + c12 * b1 + c22 * b2) / det
    return torch.stack([x, y, z], dim=-1)
