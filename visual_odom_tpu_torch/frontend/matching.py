"""Circular matching across the stereo image quad.

Port of ``visual_odom_tpu/frontend/matching.py``: the four LK legs
L(t0) -> R(t0) -> R(t1) -> L(t1) -> L(t0)_return (circularMatching,
reference src/feature.cpp:118-148) in one launch of the quad kernel, then
one fused validity reduction: the four LK statuses, the non-negative
coordinate checks (src/feature.cpp:96-99) and the Chebyshev round-trip
closure with the reference's integer truncation (src/visualOdometry.cpp:
44-61). Ages of every entering feature are incremented.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from visual_odom_tpu_torch.frontend.featureset import FeatureState
from visual_odom_tpu_torch.ops.lk import LKImage, LKParams
from visual_odom_tpu_torch.ops.lk_cuda import lk_circular_quad


class CircularMatchResult(NamedTuple):
    points_l0: torch.Tensor      # (N, 2) bucketed source points
    points_r0: torch.Tensor
    points_r1: torch.Tensor
    points_l1: torch.Tensor
    points_l0_return: torch.Tensor
    valid: torch.Tensor          # (N,) survived all checks
    ages: torch.Tensor           # (N,) incremented ages
    ids: torch.Tensor            # (N,) track ids (pass-through)
    next_id: torch.Tensor        # () allocation cursor (pass-through)


def circular_match(img_l0: LKImage, img_r0: LKImage, img_l1: LKImage,
                   img_r1: LKImage, bucketed: FeatureState,
                   params: LKParams = LKParams(),
                   circle_threshold: float = 0.0, seeding: bool = True,
                   seed_start_level: int = None) -> CircularMatchResult:
    """Track the bucketed features around the quad and filter.

    ``seeding`` starts each leg from the feature's previous flow/disparity
    (clamped to +-(cols/4, rows/4), so a corrupt carry degrades to a bad
    seed); coarse-level skipping (``seed_start_level``) applies only then.
    """
    pts_l0 = bucketed.points
    valid_in = bucketed.valid
    sl = seed_start_level if seeding else None
    if seeding:
        rows0, cols0 = img_l0.shapes[0]

        def clamp(v):
            # Per-axis scalar bounds: no host-to-device copy, so no sync.
            return torch.stack([v[:, 0].clamp(-cols0 / 4.0, cols0 / 4.0),
                                v[:, 1].clamp(-rows0 / 4.0, rows0 / 4.0)],
                               dim=1)

        flow = clamp(bucketed.flow)
        disp = clamp(bucketed.disp)
    else:
        flow = torch.zeros_like(pts_l0)
        disp = torch.zeros_like(pts_l0)

    pts_r0, pts_r1, pts_l1, pts_ret, legs_ok = lk_circular_quad(
        img_l0, img_r0, img_r1, img_l1, pts_l0, valid_in, params,
        flow=flow, disp=disp, start_level=sl)

    def nonneg(p):
        return (p[:, 0] >= 0) & (p[:, 1] >= 0)

    track_ok = (legs_ok & nonneg(pts_l0) & nonneg(pts_r0) & nonneg(pts_r1)
                & nonneg(pts_l1))
    # checkValidMatch declares `int offset`: the float distance truncates
    # before the `> threshold` comparison.
    offset = torch.maximum(torch.abs(pts_l0[:, 0] - pts_ret[:, 0]),
                           torch.abs(pts_l0[:, 1] - pts_ret[:, 1]))
    closure_ok = torch.floor(offset) <= circle_threshold
    return CircularMatchResult(
        points_l0=pts_l0, points_r0=pts_r0, points_r1=pts_r1,
        points_l1=pts_l1, points_l0_return=pts_ret,
        valid=valid_in & track_ok & closure_ok,
        ages=bucketed.ages + 1, ids=bucketed.ids, next_id=bucketed.next_id)


def commit_tracked_state(result: CircularMatchResult) -> FeatureState:
    """New persistent state: survivors at their L(t1) positions, carrying
    the measured flow (l1 - l0) and stereo offset (r1 - l1) as the next
    frame's motion priors."""
    v = result.valid[:, None]
    zero = torch.zeros_like(result.points_l1)
    return FeatureState(
        points=result.points_l1, ages=result.ages, valid=result.valid,
        ids=result.ids, next_id=result.next_id,
        flow=torch.where(v, result.points_l1 - result.points_l0, zero),
        disp=torch.where(v, result.points_r1 - result.points_l1, zero))


def skip_mode_match(img_l0, img_r0, img_l1, img_r1, bucketed: FeatureState,
                    params: LKParams, config):
    """Circular match under VOConfig's skip policy.

    "fixed": one quad at the safe level. "adaptive": the fast quad
    (lk_fast_skip_levels skipped) plus a 64-slot probe at the safe level;
    a frame whose probe disagrees (> lk_probe_px on > lk_probe_disagree_frac
    of comparable tracks, or fewer than 8 comparable) re-tracks at the safe
    level. The choice never reaches the host: the safe quad is launched
    every frame with mask ``valid & aliased`` (an all-invalid launch when
    the frame is not aliased, whose warps exit at once) and every output is
    picked with ``torch.where``.

    Returns (CircularMatchResult, fallback () bool).
    """
    sl_safe = (config.lk_levels - config.lk_seed_skip_levels
               if config.lk_seed_skip_levels else None)

    def match_at(feats, start_level):
        return circular_match(img_l0, img_r0, img_l1, img_r1, feats, params,
                              config.circle_threshold,
                              seeding=config.predictive_seeding,
                              seed_start_level=start_level)

    if not (config.lk_skip_mode == "adaptive"
            and config.predictive_seeding
            and config.lk_fast_skip_levels > config.lk_seed_skip_levels):
        return (match_at(bucketed, sl_safe),
                torch.zeros((), dtype=torch.bool, device=bucketed.valid.device))

    sl_fast = config.lk_levels - config.lk_fast_skip_levels
    match_fast = match_at(bucketed, sl_fast)
    P = bucketed.points.shape[0]
    idx = torch.arange(0, P, max(1, P // 64), device=bucketed.valid.device)[:64]
    probe_feats = FeatureState(*(a[idx] if a.dim() >= 1 else a
                                 for a in bucketed))
    probe = match_at(probe_feats, sl_safe)
    both = probe.valid & match_fast.valid[idx]
    d = torch.amax(torch.abs(probe.points_l1 - match_fast.points_l1[idx]),
                   dim=1)
    n_both = both.sum()
    n_bad = (both & (d > config.lk_probe_px)).sum()
    aliased = ((n_bad > config.lk_probe_disagree_frac
                * torch.clamp(n_both, min=1)) | (n_both < 8))
    match_safe = match_at(bucketed._replace(valid=bucketed.valid & aliased),
                          sl_safe)
    picked = CircularMatchResult(*(torch.where(aliased, s, f)
                                   for s, f in zip(match_safe, match_fast)))
    return picked, aliased
