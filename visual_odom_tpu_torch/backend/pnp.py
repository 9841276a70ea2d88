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

The refinement runs in two entry points, each one kernel launch on CUDA
(``csrc/pnp_gn.cu``; its source note says why and what bounds it):
``refine_hypotheses`` refines every hypothesis of every sequence (a thread
each, gathering its own sample), ``refine_polish`` the best one of each
sequence on its inliers (a block each). For CPU tensors each takes the
plain twin, ``_refine_hypotheses_plain`` and ``_gn_refine``; there is no
fallback from one to the other. Each counts its kernel launches on itself
(``refine_hypotheses.launches``, ``refine_polish.launches``), and
``utils.cudagraph`` adds a graph's launches at each replay.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from visual_odom_tpu_torch.core.lie import rodrigues, rodrigues_inverse
from visual_odom_tpu_torch.core.linalg import solve_spd


class PnPResult(NamedTuple):
    rvec: torch.Tensor             # ([B,] 3) axis-angle, camera(t1) <- world(t0)
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


def _refine_hypotheses_plain(pose0, points3d, points2d, sample_idx, K,
                             iters: int, damping: float = 1e-3):
    """``refine_hypotheses``' plain twin: the (B * H, 6) poses of
    ``_gn_refine`` on every hypothesis' sample, weight 1, started from
    pose0[b] (even h) or the identity (odd h)."""
    B, H, k = sample_idx.shape
    dev = points3d.device
    even = (torch.arange(H, device=dev) % 2 == 0)[:, None]
    starts = torch.where(even, pose0[:, None, :],
                         torch.zeros_like(pose0)[:, None, :])     # (B, H, 6)
    idx = sample_idx[..., None]
    BH = B * H
    return _gn_refine(
        starts.reshape(BH, 6),
        torch.take_along_dim(points3d[:, None], idx, dim=2).reshape(BH, k, 3),
        torch.take_along_dim(points2d[:, None], idx, dim=2).reshape(BH, k, 2),
        torch.ones((BH, k), device=dev), K, iters, damping)


@functools.lru_cache(maxsize=None)
def _library():
    """The kernels' library, built and loaded once, with the C signatures
    of ``pnp_gn_hypotheses_launch`` and ``pnp_gn_polish_launch``."""
    from visual_odom_tpu_torch.ops import _nvcc

    lib = _nvcc.load("pnp_gn")
    lib.pnp_gn_hypotheses_launch.argtypes = (
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
        + [ctypes.c_float, ctypes.c_void_p])
    lib.pnp_gn_polish_launch.argtypes = (
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3
        + [ctypes.c_float, ctypes.c_void_p])
    for fn in (lib.pnp_gn_hypotheses_launch, lib.pnp_gn_polish_launch):
        fn.restype = ctypes.c_int
    return lib


def _check(t: torch.Tensor, name: str, dtype, shape, device):
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) or t.device != device:
        raise ValueError(f"{name}: expected {dtype} {tuple(shape)} on {device}, "
                         f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_launch(t: torch.Tensor, iters: int):
    """Operands on a card, and ``iters`` >= 0."""
    if iters < 0:
        raise ValueError(f"iters must be >= 0, got {iters}")
    if t.device.type != "cuda":
        raise ValueError(f"the PnP refinement kernels take CUDA tensors, got "
                         f"one on {t.device}")


def _refine_hypotheses_cuda(pose0, points3d, points2d, sample_idx, K,
                            iters: int, damping: float):
    """Launch ``pnp_gn_hypotheses_kernel`` on the current stream. Raises if
    the kernel does not take the inputs or the launch fails."""
    if sample_idx.dim() != 3 or points3d.dim() != 3:
        raise ValueError(f"sample_idx (B, H, k) and points3d (B, N, 3) "
                         f"expected, got {tuple(sample_idx.shape)} and "
                         f"{tuple(points3d.shape)}")
    B, H, k = sample_idx.shape
    N = points3d.shape[1]
    if min(B, H, k, N) < 1:
        raise ValueError(f"empty refinement: B {B}, H {H}, k {k}, N {N}")
    dev = points3d.device
    _check(pose0, "pose0", torch.float32, (B, 6), dev)
    _check(points3d, "points3d", torch.float32, (B, N, 3), dev)
    _check(points2d, "points2d", torch.float32, (B, N, 2), dev)
    _check(sample_idx, "sample_idx", torch.int64, (B, H, k), dev)
    _check(K, "K", torch.float32, (3, 3), dev)
    _check_launch(points3d, iters)
    out = torch.empty((B * H, 6), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):    # launch on the operands' device
        err = _library().pnp_gn_hypotheses_launch(
            pose0.data_ptr(), points3d.data_ptr(), points2d.data_ptr(),
            sample_idx.data_ptr(), K.data_ptr(), out.data_ptr(), B, H, N, k,
            iters, damping, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"pnp_gn_hypotheses_kernel launch failed: CUDA "
                           f"error {err}")
    refine_hypotheses.launches += 1
    return out


def _refine_polish_cuda(pose6, X, x_obs, w, K, iters: int, damping: float):
    """Launch ``pnp_gn_polish_kernel`` on the current stream. Raises if the
    kernel does not take the inputs or the launch fails."""
    if X.dim() != 3:
        raise ValueError(f"X: expected (P, M, 3), got {tuple(X.shape)}")
    P, M = X.shape[:2]
    if min(P, M) < 1:
        raise ValueError(f"empty refinement: P {P}, M {M}")
    dev = X.device
    _check(pose6, "pose6", torch.float32, (P, 6), dev)
    _check(X, "X", torch.float32, (P, M, 3), dev)
    _check(x_obs, "x_obs", torch.float32, (P, M, 2), dev)
    _check(w, "w", torch.float32, (P, M), dev)
    _check(K, "K", torch.float32, (3, 3), dev)
    _check_launch(X, iters)
    out = torch.empty((P, 6), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):    # launch on the operands' device
        err = _library().pnp_gn_polish_launch(
            pose6.data_ptr(), X.data_ptr(), x_obs.data_ptr(), w.data_ptr(),
            K.data_ptr(), out.data_ptr(), P, M, iters, damping,
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"pnp_gn_polish_kernel launch failed: CUDA error "
                           f"{err}")
    refine_polish.launches += 1
    return out


def refine_hypotheses(pose0, points3d, points2d, sample_idx, K, iters: int,
                      damping: float = 1e-3) -> torch.Tensor:
    """``iters`` damped GN steps on each of the B * H hypotheses: pose0
    (B, 6) warm starts, points3d (B, N, 3), points2d (B, N, 2), sample_idx
    (B, H, k) int64 indices into each sequence's N points. Returns (B * H,
    6) poses, hypothesis h of sequence b at row b * H + h, started from
    pose0[b] (even h) or the identity (odd h). One kernel launch on CUDA,
    the plain twin on the CPU."""
    if points3d.device.type == "cuda":
        return _refine_hypotheses_cuda(pose0, points3d, points2d, sample_idx,
                                       K, iters, damping)
    if points3d.device.type == "cpu":
        return _refine_hypotheses_plain(pose0, points3d, points2d, sample_idx,
                                        K, iters, damping)
    raise ValueError(f"no PnP refinement for device {points3d.device}")


def refine_polish(pose6, X, x_obs, w, K, iters: int,
                  damping: float = 1e-3) -> torch.Tensor:
    """``_gn_refine``: ``iters`` weighted damped GN steps on each of P poses
    (P, 6) over its own M points, X (P, M, 3), x_obs (P, M, 2), w (P, M).
    One kernel launch on CUDA, the plain twin on the CPU."""
    if X.device.type == "cuda":
        return _refine_polish_cuda(pose6, X, x_obs, w, K, iters, damping)
    if X.device.type == "cpu":
        return _gn_refine(pose6, X, x_obs, w, K, iters, damping)
    raise ValueError(f"no PnP refinement for device {X.device}")


refine_hypotheses.launches = 0
refine_polish.launches = 0


def pnp_ransac(points3d: torch.Tensor, points2d: torch.Tensor,
               valid: torch.Tensor, K: torch.Tensor, rvec0: torch.Tensor,
               tvec0: torch.Tensor, generator=None,
               iterations: int = 500, reproj_threshold: float = 0.5,
               sample_size: int = 6, refine_iters: int = 10,
               uniforms: torch.Tensor = None) -> PnPResult:
    """Frame-to-frame pose from masked 3D-2D correspondences.

    points3d (N, 3) in the t0 left-camera frame, points2d (N, 2) in L(t1),
    valid (N,), K (3, 3), warm start rvec0/tvec0. Sampling draws from the
    ``torch.Generator`` ``generator`` unless ``uniforms`` (iterations, N) is
    given.

    Batched (B sequences): points3d (B, N, 3), points2d (B, N, 2), valid
    (B, N), tvec0 (B, 3), rvec0 (3,) or (B, 3), ``generator`` a sequence of
    B generators (sequence b draws what an unbatched call with generator b
    draws) or ``uniforms`` (B, iterations, N); every field of the result
    gets a leading B. The B * iterations hypotheses are refined as one
    batch and each sequence picks its best on the device.
    """
    if points3d.dim() == 2:
        res = pnp_ransac(points3d[None], points2d[None], valid[None], K,
                         rvec0.reshape(1, 3), tvec0[None],
                         None if generator is None else (generator,),
                         iterations, reproj_threshold, sample_size,
                         refine_iters,
                         None if uniforms is None else uniforms[None])
        return PnPResult(*(x[0] for x in res))
    B, N = points3d.shape[:2]
    dev = points3d.device
    points3d, points2d = points3d.contiguous(), points2d.contiguous()
    pose0 = torch.cat([rvec0.expand(B, 3), tvec0], dim=-1).to(torch.float32)
    if uniforms is None:
        uniforms = torch.stack([torch.rand((iterations, N), generator=g,
                                           device=dev) for g in generator])
    u = torch.where(valid[:, None, :], uniforms, torch.full_like(uniforms, -1.0))
    sample_idx = torch.topk(u, sample_size, dim=-1).indices       # (B, H, k)
    sample_ok = torch.take_along_dim(valid[:, None, :], sample_idx,
                                     dim=2).all(dim=-1)

    poses = refine_hypotheses(pose0, points3d, points2d, sample_idx, K,
                              refine_iters).reshape(B, iterations, 6)

    thr2 = reproj_threshold * reproj_threshold

    def score(pose6):
        """Inlier masks (B, M, N) and counts (B, M) of (B, M, 6) poses."""
        M = pose6.shape[1]
        flat = pose6.reshape(B * M, 6)
        proj = _project(rodrigues(flat[:, :3]), flat[:, 3:],
                        points3d[:, None].expand(B, M, N, 3).reshape(
                            B * M, N, 3), K).reshape(B, M, N, 2)
        err2 = ((proj - points2d[:, None]) ** 2).sum(dim=-1)
        inl = (err2 < thr2) & valid[:, None, :]
        return inl, inl.sum(dim=-1)

    inlier_masks, counts = score(poses)
    finite = torch.isfinite(poses).all(dim=-1) & sample_ok
    counts = torch.where(finite, counts, torch.zeros_like(counts))
    # Pick with (B, 1) index tensors: a 0-d index would be read on the host.
    best = torch.argmax(counts, dim=1, keepdim=True)
    best_pose = torch.take_along_dim(poses, best[..., None], dim=1)[:, 0]
    best_inliers = torch.take_along_dim(inlier_masks, best[..., None],
                                        dim=1)[:, 0]
    best_count = torch.take_along_dim(counts, best, dim=1)[:, 0]

    polished = refine_polish(best_pose, points3d, points2d,
                             best_inliers.to(torch.float32), K,
                             refine_iters * 2)                    # (B, 6)
    final_inliers, final_count = score(polished[:, None])
    use_polished = (torch.isfinite(polished).all(dim=-1)
                    & (final_count[:, 0] >= best_count))
    up = use_polished[:, None]
    return PnPResult(
        rvec=torch.where(up, polished[:, :3], best_pose[:, :3]),
        tvec=torch.where(up, polished[:, 3:], best_pose[:, 3:]),
        inliers=torch.where(up, final_inliers[:, 0], best_inliers),
        num_inliers=torch.where(use_polished, final_count[:, 0],
                                best_count).to(torch.int32),
        best_hypothesis=best[:, 0])
