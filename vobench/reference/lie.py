"""SO(3)/SE(3) primitives.

Frozen copy of ``visual_odom_tpu_torch/core/lie.py`` at commit 245329126dfa,
with its imports pointed at this package: the benchmark's yardstick, which
a change to the program must not move. The text below is the original's.

Port of ``visual_odom_tpu/core/lie.py``; conventions match the reference:
``rodrigues`` == cv::Rodrigues(rvec -> R) (src/visualOdometry.cpp:188),
``rotation_to_euler`` == rotationMatrixToEulerAngles (src/utils.cpp:107-131),
``se3_inverse`` is the closed-form inverse used for pose chaining
(src/utils.cpp:78-84). Batched over leading dimensions; safe at theta -> 0
(series fallbacks) and at theta -> pi (diagonal axis extraction).
"""

from __future__ import annotations

import math

import torch

_EPS = 1e-8


def _hat(v: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrix of (..., 3) vectors -> (..., 3, 3)."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack([
        torch.stack([zero, -z, y], dim=-1),
        torch.stack([z, zero, -x], dim=-1),
        torch.stack([-y, x, zero], dim=-1),
    ], dim=-2)


def rodrigues(rvec: torch.Tensor) -> torch.Tensor:
    """Axis-angle (..., 3) -> rotation matrix (..., 3, 3).

    R = cos(t) I + sin(t)/t [w]_x + (1-cos(t))/t^2 w w^T, with series
    expansions near t = 0.
    """
    theta2 = (rvec * rvec).sum(dim=-1)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    small = theta2 < 1e-8
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2)
    K = _hat(rvec)
    outer = rvec[..., :, None] * rvec[..., None, :]
    eye = torch.eye(3, dtype=rvec.dtype, device=rvec.device).expand(K.shape)
    cos_t = torch.where(small, 1.0 - theta2 * 0.5, torch.cos(theta))
    return (cos_t[..., None, None] * eye + a[..., None, None] * K
            + b[..., None, None] * outer)


def rodrigues_inverse(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) -> axis-angle (..., 3) (log map; near pi
    the axis comes from the largest diagonal of (R + I)/2)."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    theta = torch.arccos(cos_theta)
    vee = torch.stack([R[..., 2, 1] - R[..., 1, 2],
                       R[..., 0, 2] - R[..., 2, 0],
                       R[..., 1, 0] - R[..., 0, 1]], dim=-1)
    sin_theta = torch.sin(theta)
    generic_scale = torch.where(
        torch.abs(sin_theta) < 1e-6,
        0.5 + theta * theta / 12.0,
        theta / (2.0 * torch.clamp(torch.abs(sin_theta), min=_EPS))
        * torch.sign(sin_theta + _EPS))
    w_generic = vee * generic_scale[..., None]

    A = 0.5 * (R + torch.eye(3, dtype=R.dtype, device=R.device))
    diag = torch.stack([A[..., 0, 0], A[..., 1, 1], A[..., 2, 2]], dim=-1)
    axis = torch.sqrt(torch.clamp(diag, min=0.0) + _EPS * _EPS)
    k = torch.argmax(diag, dim=-1)
    s01 = torch.sign(A[..., 0, 1])
    s02 = torch.sign(A[..., 0, 2])
    s12 = torch.sign(A[..., 1, 2])
    a0, a1, a2 = axis[..., 0], axis[..., 1], axis[..., 2]
    cands = torch.stack([
        torch.stack([a0, a1 * s01, a2 * s02], dim=-1),
        torch.stack([a0 * s01, a1, a2 * s12], dim=-1),
        torch.stack([a0 * s02, a1 * s12, a2], dim=-1),
    ], dim=-2)                                          # (..., 3 cands, 3)
    axis_fixed = torch.take_along_dim(cands, k[..., None, None], dim=-2)[..., 0, :]
    axis_fixed = axis_fixed / torch.linalg.vector_norm(axis_fixed, dim=-1,
                                                       keepdim=True)
    w_pi = axis_fixed * theta[..., None]
    near_pi = (math.pi - theta) < 1e-3
    return torch.where(near_pi[..., None], w_pi, w_generic)


def rotation_to_euler(R: torch.Tensor) -> torch.Tensor:
    """Reference rotationMatrixToEulerAngles: (..., 3) = (x, y, z)."""
    sy = torch.sqrt(R[..., 0, 0] ** 2 + R[..., 1, 0] ** 2)
    singular = sy < 1e-6
    x = torch.where(singular, torch.atan2(-R[..., 1, 2], R[..., 1, 1]),
                    torch.atan2(R[..., 2, 1], R[..., 2, 2]))
    y = torch.atan2(-R[..., 2, 0], sy)
    z = torch.where(singular, torch.zeros_like(sy),
                    torch.atan2(R[..., 1, 0], R[..., 0, 0]))
    return torch.stack([x, y, z], dim=-1)


def se3_matrix(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) [R|t; 0 1]."""
    # Filled on the device: a scalar written by index would be copied from
    # the host, which waits for the device.
    lead = R.shape[:-2] + (1,)
    bottom = torch.cat([R.new_zeros(lead + (3,)), R.new_ones(lead + (1,))],
                       dim=-1)
    top = torch.cat([R, t[..., :, None]], dim=-1)
    return torch.cat([top, bottom], dim=-2)


def se3_inverse(T: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of (..., 4, 4) rigid transforms."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    Rt = R.transpose(-1, -2)
    t_inv = -(Rt * t[..., None, :]).sum(dim=-1)
    return se3_matrix(Rt, t_inv)


def is_rotation_matrix(R: torch.Tensor, tol: float = 1e-6) -> torch.Tensor:
    """Frobenius check ||R^T R - I|| < tol (reference src/utils.cpp:93-102),
    over leading dimensions."""
    RtR = torch.matmul(R.transpose(-1, -2), R)
    err = RtR - torch.eye(3, dtype=R.dtype, device=R.device)
    return torch.sqrt((err * err).sum(dim=(-2, -1))) < tol


def euler_to_rotation(euler: torch.Tensor) -> torch.Tensor:
    """Reference euler2rot (src/visualOdometry.cpp:4-42), kept for API
    parity. It is not the inverse of ``rotation_to_euler``: the reference
    composes the axes in another order, and this reproduces it."""
    x, y, z = euler[..., 0], euler[..., 1], euler[..., 2]
    ch, sh = torch.cos(z), torch.sin(z)
    ca, sa = torch.cos(y), torch.sin(y)
    cb, sb = torch.cos(x), torch.sin(x)
    row0 = torch.stack([ch * ca, sh * sb - ch * sa * cb,
                        ch * sa * sb + sh * cb], -1)
    row1 = torch.stack([sa, ca * cb, -ca * sb], -1)
    row2 = torch.stack([-sh * ca, sh * sa * cb + ch * sb,
                        -sh * sa * sb + ch * cb], -1)
    return torch.stack([row0, row1, row2], dim=-2)
