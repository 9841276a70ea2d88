"""A synthetic input of PnP-RANSAC's refinement, as the main path gives it.

``pnp_scene`` makes, from a seed, what ``backend.pnp``'s two refinement
entry points take: B sequences of n point slots, their observations after
a motion, each hypothesis' sample drawn as ``pnp_ransac`` draws it, the
warm start, and the polish's pose and weights. ``chip_smoke.py``'s PnP
phase and the card tests hold the CUDA kernels to their plain twins on it;
the CPU tests feed it to the plain twins.
"""

from __future__ import annotations

import numpy as np
import torch

from visual_odom_tpu_torch.core.lie import rodrigues


def pnp_scene(device, B: int, n: int, hyps: int, k: int, K, seed: int) -> dict:
    """B sequences of n slots (90 % valid, an invalid one at the step's safe
    point (0, 0, 10)) 5-60 m ahead, seen through the 3x3 camera ``K`` after
    a ~1.25 m motion with 0.3 px of noise and 15 % outliers; ``hyps``
    samples of ``k`` slots each, drawn as ``pnp_ransac`` draws them (top-k
    of uniforms over the valid slots); the warm start off by ~5 cm; the
    polish's pose off the motion by ~2 mrad and ~5 cm, weighted by the
    motion's inliers. Returns contiguous tensors on ``device``: pose0 (B, 6),
    X (B, n, 3), x (B, n, 2), K (3, 3), idx (B, hyps, k) int64, polish
    (B, 6), w (B, n) and valid (B, n) bool."""
    rng = np.random.default_rng(seed)
    K = np.asarray(K, dtype=np.float64)
    X = np.stack([rng.uniform(-20, 20, (B, n)), rng.uniform(-3, 3, (B, n)),
                  rng.uniform(5, 60, (B, n))], axis=-1)
    valid = rng.random((B, n)) < 0.9
    X[~valid] = (0.0, 0.0, 10.0)
    rvec = rng.normal(0.0, 0.01, (B, 3))
    tvec = np.stack([rng.normal(0.0, 0.05, B), rng.normal(0.0, 0.02, B),
                     -1.25 + rng.normal(0.0, 0.05, B)], axis=-1)
    p = (np.einsum("bij,bnj->bni", rodrigues(torch.from_numpy(rvec)).numpy(),
                   X) + tvec[:, None])
    exact = p[..., :2] / p[..., 2:] * K[0, 0] + K[:2, 2]
    x = exact + rng.normal(0.0, 0.3, exact.shape)
    out = rng.random((B, n)) < 0.15
    x[out] = rng.uniform((0.0, 0.0), 2 * K[:2, 2], (int(out.sum()), 2))
    inliers = (np.linalg.norm(x - exact, axis=-1) < 0.5) & valid
    u = torch.from_numpy(np.where(valid[:, None], rng.random((B, hyps, n)),
                                  -1.0))
    pose0 = np.concatenate([np.zeros((B, 3)),
                            tvec + rng.normal(0.0, 0.05, (B, 3))], axis=-1)
    polish = np.concatenate([rvec + rng.normal(0.0, 2e-3, (B, 3)),
                             tvec + rng.normal(0.0, 0.05, (B, 3))], axis=-1)

    def f32(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float32,
                               device=device)

    return dict(pose0=f32(pose0), X=f32(X), x=f32(x), K=f32(K),
                idx=torch.topk(u, k, dim=-1).indices.to(device),
                polish=f32(polish), w=f32(inliers),
                valid=torch.from_numpy(valid).to(device))
