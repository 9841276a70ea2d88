"""Vectorised PnP-RANSAC with damped Gauss-Newton refinement.

Port of ``visual_odom_tpu/backend/pnp.py:pnp_ransac``, the counterpart of
cv::solvePnPRansac(SOLVEPNP_ITERATIVE, useExtrinsicGuess=true, 500
iterations, 0.5 px) as the reference calls it (src/visualOdometry.cpp:
161-189). All hypotheses run at once: each draws a minimal sample (top-k of
iid uniforms over valid slots), runs a fixed number of damped GN steps
(even hypotheses from the warm start, odd ones from the identity), and is
scored against every correspondence; the best is polished on its inliers
with twice the steps.

Random draws come from an explicit ``torch.Generator``; ``uniforms``
replaces the draw with given (iterations, N) numbers, so a test can feed the
port the exact draws the JAX package made.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from visual_odom_tpu_torch.core.lie import rodrigues, rodrigues_inverse
from visual_odom_tpu_torch.core.linalg import solve_spd


class PnPResult(NamedTuple):
    rvec: torch.Tensor             # (3,) axis-angle, camera(t1) <- world(t0)
    tvec: torch.Tensor             # (3,)
    inliers: torch.Tensor          # (N,) bool
    num_inliers: torch.Tensor      # () int32
    best_hypothesis: torch.Tensor  # () int64 (diagnostic)


def _transform(R: torch.Tensor, t: torch.Tensor, X: torch.Tensor):
    """p = X R^T + t for batched (H, 3, 3), (H, 3) and (H, M, 3)."""
    return (X[..., None, :] * R[:, None, :, :]).sum(-1) + t[:, None, :]


def _project(R, t, X, K):
    """(H, M, 2) pixel projections of (H, M, 3) points."""
    p = _transform(R, t, X)
    z = p[..., 2:3]
    z = torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)
    uv = p[..., :2] / z
    return torch.stack([uv[..., 0] * K[0, 0] + K[0, 2],
                        uv[..., 1] * K[1, 1] + K[1, 2]], dim=-1)


def _gn_refine(pose6, X, x_obs, w, K, iters: int, damping: float = 1e-3):
    """Weighted damped Gauss-Newton on the reprojection residual, batched
    over hypotheses: pose6 (H, 6), X (H, M, 3), x_obs (H, M, 2), w (H, M).

    SE(3) left perturbation (R <- exp(dw) R, t <- t + dt) with closed-form
    Jacobians dp/ddw = -[p - t]_x, dp/ddt = I; a step that is not finite
    leaves the pose unchanged.
    """
    fx, fy = K[0, 0], K[1, 1]
    cx, cy = K[0, 2], K[1, 2]
    R = rodrigues(pose6[:, :3])
    t = pose6[:, 3:]
    eye6 = damping * torch.eye(6, dtype=X.dtype, device=X.device)
    for _ in range(iters):
        p = _transform(R, t, X)                              # (H, M, 3)
        z = torch.where(torch.abs(p[..., 2]) < 1e-9,
                        torch.full_like(p[..., 2], 1e-9), p[..., 2])
        inv_z = 1.0 / z
        u = p[..., 0] * inv_z * fx + cx
        v = p[..., 1] * inv_z * fy + cy
        r = torch.stack([u, v], dim=-1) - x_obs              # (H, M, 2)
        du0 = fx * inv_z
        du2 = -fx * p[..., 0] * inv_z * inv_z
        dv1 = fy * inv_z
        dv2 = -fy * p[..., 1] * inv_z * inv_z
        q = p - t[:, None, :]                                # R X
        q0, q1, q2 = q[..., 0], q[..., 1], q[..., 2]
        zero = torch.zeros_like(du0)
        # du . [-[q]_x | I] and dv . [-[q]_x | I], written out.
        Ju = torch.stack([du2 * q1, du0 * q2 - du2 * q0, -du0 * q1,
                          du0, zero, du2], dim=-1)
        Jv = torch.stack([-dv1 * q2 + dv2 * q1, -dv2 * q0, dv1 * q0,
                          zero, dv1, dv2], dim=-1)
        J = torch.stack([Ju, Jv], dim=2) * w[..., None, None]  # (H, M, 2, 6)
        rw = r * w[..., None]
        G = torch.einsum("hmri,hmrj->hij", J, J)
        g = torch.einsum("hmri,hmr->hi", J, rw)
        step = solve_spd(G + eye6, g)
        ok = torch.isfinite(step).all(dim=-1)
        R_new = rodrigues(-step[:, :3]) @ R
        R = torch.where(ok[:, None, None], R_new, R)
        t = torch.where(ok[:, None], t - step[:, 3:], t)
    return torch.cat([rodrigues_inverse(R), t], dim=-1)


def pnp_ransac(points3d: torch.Tensor, points2d: torch.Tensor,
               valid: torch.Tensor, K: torch.Tensor, rvec0: torch.Tensor,
               tvec0: torch.Tensor, generator: torch.Generator = None,
               iterations: int = 500, reproj_threshold: float = 0.5,
               sample_size: int = 6, refine_iters: int = 10,
               uniforms: torch.Tensor = None) -> PnPResult:
    """Frame-to-frame pose from masked 3D-2D correspondences.

    points3d (N, 3) in the t0 left-camera frame, points2d (N, 2) in L(t1),
    valid (N,), K (3, 3), warm start rvec0/tvec0. Sampling draws from
    ``generator`` unless ``uniforms`` (iterations, N) is given.
    """
    N = points3d.shape[0]
    dev = points3d.device
    pose0 = torch.cat([rvec0, tvec0]).to(torch.float32)
    if uniforms is None:
        uniforms = torch.rand((iterations, N), generator=generator, device=dev)
    u = torch.where(valid[None, :], uniforms, torch.full_like(uniforms, -1.0))
    sample_idx = torch.topk(u, sample_size, dim=1).indices       # (H, k)
    sample_ok = valid[sample_idx].all(dim=1)

    starts = torch.where((torch.arange(iterations, device=dev) % 2 == 0)[:, None],
                         pose0[None, :], torch.zeros_like(pose0)[None, :])
    poses = _gn_refine(starts, points3d[sample_idx], points2d[sample_idx],
                       torch.ones((iterations, sample_size), device=dev), K,
                       refine_iters)                             # (H, 6)

    thr2 = reproj_threshold * reproj_threshold

    def score(pose6):
        proj = _project(rodrigues(pose6[:, :3]), pose6[:, 3:],
                        points3d.expand(pose6.shape[0], N, 3), K)
        err2 = ((proj - points2d) ** 2).sum(dim=-1)
        inl = (err2 < thr2) & valid
        return inl, inl.sum(dim=-1)

    inlier_masks, counts = score(poses)
    finite = torch.isfinite(poses).all(dim=1) & sample_ok
    counts = torch.where(finite, counts, torch.zeros_like(counts))
    # Index with a 1-element tensor: a 0-d index would be read on the host.
    best = torch.argmax(counts, dim=0, keepdim=True)
    best_pose = poses[best][0]
    best_inliers = inlier_masks[best][0]
    best_count = counts[best][0]

    polished = _gn_refine(best_pose[None], points3d[None], points2d[None],
                          best_inliers.to(torch.float32)[None], K,
                          refine_iters * 2)
    final_inliers, final_count = score(polished)
    use_polished = torch.isfinite(polished).all() & (final_count[0] >= best_count)
    return PnPResult(
        rvec=torch.where(use_polished, polished[0, :3], best_pose[:3]),
        tvec=torch.where(use_polished, polished[0, 3:], best_pose[3:]),
        inliers=torch.where(use_polished, final_inliers[0], best_inliers),
        num_inliers=torch.where(use_polished, final_count[0],
                                best_count).to(torch.int32),
        best_hypothesis=best[0])
