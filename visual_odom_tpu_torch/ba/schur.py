"""Gauss-Newton bundle adjustment with Schur-complement landmark elimination.

Port of ``visual_odom_tpu/ba/schur.py``. The two-block structure

    [ Hpp  Hpl ] [ dp ]   [ bp ]
    [ Hpl' Hll ] [ dx ] = [ bl ]

- every Jacobian block comes from one ``torch.func.vmap`` of
  ``torch.func.jacfwd`` over the (W, L) observation grid (exact derivatives
  through ``core.lie.rodrigues``, as the JAX package takes them);
- Hll is (L, 3, 3) block-diagonal -> batched 3x3 inverse;
- the reduced camera system S = Hpp - Hpl Hll^-1 Hpl' is formed by einsums
  over the landmark axis;
- S is dense (6W, 6W) with W ~ 4..16 keyframes: a single small solve;
- the gauge is fixed by a large prior on pose 0 (the window's anchor).

The step is split where a landmark-sharded solve (``parallel.sharded_ba``)
meets its collective: ``schur_parts`` gives one shard's sums over its
landmarks, ``solve_reduced`` applies damping and the gauge prior once to the
summed system, and ``back_substitute`` updates the shard's landmarks.
``ba_gauss_newton_step`` is the three on one shard.

Everything stays on the problem's device: no step reads a value back to the
host (the non-finite guard is a ``torch.where``). On a card ``ba_solve``
replays one GN step from a CUDA graph per iteration
(``utils.cudagraph.GraphedLoop``), the counterpart of the JAX package's
``jit`` of a ``lax.scan`` over the iterations.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from visual_odom_tpu_torch.ba.problem import (BAProblem, intrinsics_of,
                                              project_stereo)
from visual_odom_tpu_torch.utils.cudagraph import GraphedLoop, use_graph

_GAUGE_PRIOR = 1e9


def _jacobian_blocks(problem: BAProblem, huber_delta: float = 0.0):
    """Per-observation Jacobians A (d r / d pose) and B (d r / d landmark).

    Returns (A (W, L, 3, 6), B (W, L, 3, 3), r (W, L, 3)) with masked rows
    zeroed (zero residual AND zero Jacobian = observation absent).

    ``huber_delta`` > 0 applies iteratively-reweighted least squares with
    the Huber loss at that pixel scale: each observation is scaled by
    sqrt(min(1, delta / |r|)), so outliers enter the normal equations with
    bounded influence instead of quadratic pull.
    """
    intr = intrinsics_of(problem)

    def obs_residual(pose6, X, target):
        return project_stereo(pose6, X, intr) - target

    def per_lm(pose6, X, target):
        A = torch.func.jacfwd(obs_residual, argnums=0)(pose6, X, target)
        B = torch.func.jacfwd(obs_residual, argnums=1)(pose6, X, target)
        return A, B, obs_residual(pose6, X, target)

    per_pose = torch.func.vmap(per_lm, in_dims=(None, 0, 0))
    A, B, r = torch.func.vmap(per_pose, in_dims=(0, None, 0))(
        problem.poses, problem.landmarks, problem.observations)
    m = problem.mask[..., None]
    r = torch.where(m, r, torch.zeros_like(r))
    A = torch.where(m[..., None], A, torch.zeros_like(A))
    B = torch.where(m[..., None], B, torch.zeros_like(B))
    if huber_delta > 0.0:
        nrm = torch.linalg.vector_norm(r, dim=-1, keepdim=True)   # (W, L, 1)
        w = torch.sqrt(torch.clamp(huber_delta / torch.clamp(nrm, min=1e-12),
                                   max=1.0))
        r = r * w
        A = A * w[..., None]
        B = B * w[..., None]
    return A, B, r


class SchurParts(NamedTuple):
    """The reduced camera system's terms that are sums over landmarks: a
    landmark shard's partial sums, or (after a ``psum`` over the shards,
    ``parallel.sharded_ba``) the whole problem's."""

    Hpp: torch.Tensor       # (W, 6, 6)
    bp: torch.Tensor        # (W, 6)
    S_red: torch.Tensor     # (W, W, 6, 6)  sum_l Hpl_l Hll_l^-1 Hpl_l'
    rhs_red: torch.Tensor   # (W, 6)        sum_l Hpl_l Hll_l^-1 bl_l


class LandmarkBlocks(NamedTuple):
    """Per-landmark blocks, local to the landmark's shard: what the
    back-substitution needs."""

    Hpl: torch.Tensor       # (W, L, 6, 3)
    Hll_inv: torch.Tensor   # (L, 3, 3), damped
    bl: torch.Tensor        # (L, 3)


def schur_parts(problem: BAProblem, damping: float = 1e-4,
                huber_delta: float = 0.0):
    """The GN step's landmark contractions over ``problem``'s landmarks.
    Returns (SchurParts, LandmarkBlocks)."""
    eye3 = torch.eye(3, dtype=problem.poses.dtype, device=problem.poses.device)
    A, B, r = _jacobian_blocks(problem, huber_delta=huber_delta)

    # Block accumulations (contractions over landmarks).
    Hpp = torch.einsum("wlri,wlrj->wij", A, A)        # (W, 6, 6)
    Hll = torch.einsum("wlri,wlrj->lij", B, B)        # (L, 3, 3)
    Hpl = torch.einsum("wlri,wlrj->wlij", A, B)       # (W, L, 6, 3)
    bp = torch.einsum("wlri,wlr->wi", A, r)           # (W, 6)
    bl = torch.einsum("wlri,wlr->li", B, r)           # (L, 3)

    # LM damping + batched 3x3 landmark-block inverse. The _ex forms skip
    # the error check, which would read the device's status on the host; a
    # singular system is caught by the non-finite guard.
    Hll_inv = torch.linalg.inv_ex(Hll + damping * eye3)[0]   # (L, 3, 3)

    # Schur complement: contraction over landmarks.
    HplWinv = torch.einsum("wlij,ljk->wlik", Hpl, Hll_inv)
    S_red = torch.einsum("wlik,vljk->wvij", HplWinv, Hpl)
    rhs_red = torch.einsum("wlik,lk->wi", HplWinv, bl)
    return (SchurParts(Hpp, bp, S_red, rhs_red),
            LandmarkBlocks(Hpl, Hll_inv, bl))


def solve_reduced(parts: SchurParts, poses: torch.Tensor,
                  damping: float = 1e-4, anchor=None,
                  anchor_w=None) -> torch.Tensor:
    """The pose update dp (W, 6) of the whole problem's reduced system:
    LM damping and the anchor priors are applied here, once, after the
    landmark sums."""
    W = poses.shape[0]
    eye6, eyeW = (torch.eye(k, dtype=poses.dtype, device=poses.device)
                  for k in (6, W))
    if anchor is None:
        anchor = poses
    if anchor_w is None:
        # Built on the device: a scalar written by index would be copied
        # from the host.
        anchor_w = eyeW[0] * _GAUGE_PRIOR
    # Block-diagonal Hpp with LM damping (an outer product with the
    # identity: exact), minus the reduction; then the per-pose anchor priors
    # (gauge by default), added in that order as the JAX package adds them.
    S = torch.einsum("wv,wij->wvij", eyeW, parts.Hpp + damping * eye6) \
        - parts.S_red
    S = S + torch.einsum("wv,w,ij->wvij", eyeW, anchor_w, eye6)
    rhs = parts.bp - parts.rhs_red
    rhs = rhs + anchor_w[:, None] * (poses - anchor)

    S_dense = S.permute(0, 2, 1, 3).reshape(W * 6, W * 6)
    return torch.linalg.solve_ex(S_dense, rhs.reshape(W * 6))[0].reshape(W, 6)


def back_substitute(blocks: LandmarkBlocks, dp: torch.Tensor) -> torch.Tensor:
    """The landmark update dx (L, 3) of these landmarks, given dp."""
    corr = torch.einsum("wlij,wi->lj", blocks.Hpl, dp)
    return torch.einsum("lij,lj->li", blocks.Hll_inv, blocks.bl - corr)


def ba_gauss_newton_step(problem: BAProblem, damping: float = 1e-4,
                         anchor=None, anchor_w=None,
                         huber_delta: float = 0.0) -> BAProblem:
    """One damped GN step. Returns the updated problem.

    anchor (W, 6) / anchor_w (W,) add per-pose quadratic priors
    0.5 * w_i * ||pose_i - anchor_i||^2, e.g. to pin a window's boundary
    keyframes to externally known estimates. Default (None) anchors pose 0
    to itself with a large weight, the classic gauge prior (dp_0 ~ 0).
    It is ``parallel.sharded_ba``'s step on one landmark shard.
    """
    parts, blocks = schur_parts(problem, damping, huber_delta)
    dp = solve_reduced(parts, problem.poses, damping, anchor, anchor_w)
    dx = back_substitute(blocks, dp)
    ok = torch.isfinite(dp).all() & torch.isfinite(dx).all()
    return problem._replace(
        poses=torch.where(ok, problem.poses - dp, problem.poses),
        landmarks=torch.where(ok, problem.landmarks - dx, problem.landmarks))


@functools.lru_cache(maxsize=8)
def _graphed_solve(damping: float, huber_delta: float, device: torch.device):
    """The GN step as a graphed fixed-trip loop, one per (damping,
    huber_delta, device) in a process: one capture per problem shape."""
    return GraphedLoop(functools.partial(ba_gauss_newton_step,
                                         damping=damping,
                                         huber_delta=huber_delta), device)


def ba_solve(problem: BAProblem, iterations: int = 10,
             damping: float = 1e-4, huber_delta: float = 0.0) -> BAProblem:
    """Fixed-iteration GN loop (extra steps are no-ops at the optimum).
    ``huber_delta`` > 0 = robust (Huber IRLS) solve. On a card each
    iteration is one replay of the GN step's CUDA graph, captured once per
    (W, L, intrinsics, damping, huber_delta), bit for bit the eager loop
    (``utils.cudagraph.use_graph`` picks by the problem's device)."""
    dev = problem.poses.device
    if use_graph(dev):
        return _graphed_solve(float(damping), float(huber_delta),
                              dev)(problem, iterations)
    for _ in range(iterations):
        problem = ba_gauss_newton_step(problem, damping=damping,
                                       huber_delta=huber_delta)
    return problem
