"""Circular matching across the stereo image quad.

Port of ``visual_odom_tpu/frontend/matching.py``: the four LK legs
L(t0) -> R(t0) -> R(t1) -> L(t1) -> L(t0)_return (circularMatching,
reference src/feature.cpp:118-148) on one of two routes,
``VOConfig.lk_backend``: ``"pallas"``, one launch of the quad kernel, or
``"xla"``, four chained ``lk_track_pyramid`` legs of one level launch per
level (the names are the JAX package's; both compute the same bits). Then
one fused validity reduction: the four LK statuses, the non-negative
coordinate checks (src/feature.cpp:96-99) and the Chebyshev round-trip
closure with the reference's integer truncation (src/visualOdometry.cpp:
44-61). Ages of every entering feature are incremented. Every function
also takes a batched state (a leading B on every field, B sequences in
lockstep): the quads are then batched launches, and each sequence makes
its own adaptive choice.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from visual_odom_tpu_torch.config import LK_BACKENDS
from visual_odom_tpu_torch.frontend.featureset import FeatureState
from visual_odom_tpu_torch.ops.lk import LKImage, LKParams, lk_track_pyramid
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
                   circle_threshold: float = 0.0, backend: str = "pallas",
                   seeding: bool = True, seed_start_level: int = None,
                   slot_devices=None) -> CircularMatchResult:
    """Track the bucketed features around the quad and filter.

    ``backend`` picks the route: "pallas" runs the quad as one
    ``lk_quad_kernel`` launch, "xla" as four chained ``lk_track_pyramid``
    legs (``start_level + 1`` launches of ``lk_level_kernel`` each), seeded
    as the JAX package's "xla" branch seeds them. Both give the same bits.
    ``seeding`` starts each leg from the feature's previous flow/disparity
    (clamped to +-(cols/4, rows/4), so a corrupt carry degrades to a bad
    seed); coarse-level skipping (``seed_start_level``) applies only then.
    ``slot_devices`` splits each route's launches over a mesh row's
    "model" positions: the quad's slots (``lk_circular_quad``), or each
    leg's (``lk_track_pyramid``).
    """
    if backend not in LK_BACKENDS:
        raise ValueError(f"backend must be one of {LK_BACKENDS}, got "
                         f"{backend!r}")
    pts_l0 = bucketed.points
    valid_in = bucketed.valid
    sl = seed_start_level if seeding else None
    if seeding:
        rows0, cols0 = img_l0.shapes[0]

        def clamp(v):
            # Per-axis scalar bounds: no host-to-device copy, so no sync.
            return torch.stack([v[..., 0].clamp(-cols0 / 4.0, cols0 / 4.0),
                                v[..., 1].clamp(-rows0 / 4.0, rows0 / 4.0)],
                               dim=-1)

        flow = clamp(bucketed.flow)
        disp = clamp(bucketed.disp)
    else:
        flow = torch.zeros_like(pts_l0)
        disp = torch.zeros_like(pts_l0)

    if backend == "pallas":
        pts_r0, pts_r1, pts_l1, pts_ret, legs_ok = lk_circular_quad(
            img_l0, img_r0, img_r1, img_l1, pts_l0, valid_in, params,
            flow=flow, disp=disp, start_level=sl, slot_devices=slot_devices)
    else:
        def track(img_i, img_j, pts, init):
            return lk_track_pyramid(img_i, img_j, pts, valid_in, params,
                                    init_pts=init, start_level=sl,
                                    slot_devices=slot_devices)

        pts_r0, s0 = track(img_l0, img_r0, pts_l0, pts_l0 + disp)
        pts_r1, s1 = track(img_r0, img_r1, pts_r0, pts_r0 + flow)
        pts_l1, s2 = track(img_r1, img_l1, pts_r1, pts_r1 - disp)
        pts_ret, s3 = track(img_l1, img_l0, pts_l1, pts_l1 - flow)
        legs_ok = s0 & s1 & s2 & s3

    def nonneg(p):
        return (p[..., 0] >= 0) & (p[..., 1] >= 0)

    track_ok = (legs_ok & nonneg(pts_l0) & nonneg(pts_r0) & nonneg(pts_r1)
                & nonneg(pts_l1))
    # checkValidMatch declares `int offset`: the float distance truncates
    # before the `> threshold` comparison.
    offset = torch.maximum(torch.abs(pts_l0[..., 0] - pts_ret[..., 0]),
                           torch.abs(pts_l0[..., 1] - pts_ret[..., 1]))
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
    v = result.valid[..., None]
    zero = torch.zeros_like(result.points_l1)
    return FeatureState(
        points=result.points_l1, ages=result.ages, valid=result.valid,
        ids=result.ids, next_id=result.next_id,
        flow=torch.where(v, result.points_l1 - result.points_l0, zero),
        disp=torch.where(v, result.points_r1 - result.points_l1, zero))


def skip_mode_match(img_l0, img_r0, img_l1, img_r1, bucketed: FeatureState,
                    params: LKParams, config, slot_devices=None):
    """Circular match under VOConfig's skip policy.

    "fixed": one quad at the safe level. "adaptive": the fast quad
    (lk_fast_skip_levels skipped) plus a 64-slot probe at the safe level;
    a frame whose probe disagrees (> lk_probe_px on > lk_probe_disagree_frac
    of comparable tracks, or fewer than 8 comparable) re-tracks at the safe
    level. The choice never reaches the host: the safe quad is launched
    every frame with mask ``valid & aliased`` (an all-invalid launch when
    the frame is not aliased, whose warps exit at once) and every output is
    picked with ``torch.where``. The route is
    ``config.resolved_lk_backend()``: per frame 3 quad launches, or 32
    level launches (fast quad 4 legs x 2 levels, probe and safe quad 4 x 3
    each, at the default levels). In a batched state ``aliased`` is (B,):
    each sequence picks its own result, as the JAX package's vmapped
    ``lax.cond`` (a select) does. ``slot_devices`` splits every LK
    launch over a mesh row's "model" positions
    (``circular_match``).

    Returns (CircularMatchResult, fallback () bool, or (B,) batched).
    """
    sl_safe = (config.lk_levels - config.lk_seed_skip_levels
               if config.lk_seed_skip_levels else None)

    def match_at(feats, start_level):
        return circular_match(img_l0, img_r0, img_l1, img_r1, feats, params,
                              config.circle_threshold,
                              backend=config.resolved_lk_backend(),
                              seeding=config.predictive_seeding,
                              seed_start_level=start_level,
                              slot_devices=slot_devices)

    if not (config.lk_skip_mode == "adaptive"
            and config.predictive_seeding
            and config.lk_fast_skip_levels > config.lk_seed_skip_levels):
        return (match_at(bucketed, sl_safe),
                torch.zeros(bucketed.next_id.shape, dtype=torch.bool,
                            device=bucketed.valid.device))

    sl_fast = config.lk_levels - config.lk_fast_skip_levels
    match_fast = match_at(bucketed, sl_fast)
    P = bucketed.capacity
    idx = torch.arange(0, P, max(1, P // 64), device=bucketed.valid.device)[:64]
    probe = match_at(bucketed.take(idx), sl_safe)
    both = probe.valid & match_fast.valid[..., idx]
    d = torch.amax(torch.abs(probe.points_l1
                             - match_fast.points_l1[..., idx, :]), dim=-1)
    n_both = both.sum(dim=-1)
    n_bad = (both & (d > config.lk_probe_px)).sum(dim=-1)
    aliased = ((n_bad > config.lk_probe_disagree_frac
                * torch.clamp(n_both, min=1)) | (n_both < 8))
    match_safe = match_at(
        bucketed._replace(valid=bucketed.valid & aliased[..., None]), sl_safe)

    def pick(s, f):
        a = aliased.reshape(aliased.shape + (1,) * (s.dim() - aliased.dim()))
        return torch.where(a, s, f)

    picked = CircularMatchResult(*(pick(s, f)
                                   for s, f in zip(match_safe, match_fast)))
    return picked, aliased
