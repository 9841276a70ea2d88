"""Circular matching across the stereo image quad, under the adaptive skip.

Frozen copy of ``visual_odom_tpu_torch/frontend/matching.py`` at commit
245329126dfa (``circular_match``, ``commit_tracked_state``,
``skip_mode_match``), kept so that a change to the program cannot move the
yardstick. Both of the program's LK routes compute one function; this
copy computes it with the plain quad alone (``reference.lk``).
``skip_mode_match`` is split in two (``skip_mode_front``,
``skip_mode_back``) so that a step in which no sequence is aliased can
leave out the safe quad, whose every slot is then masked and whose result
is not picked: the same outputs in a third less of the reference's time.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from vobench.reference.featureset import FeatureState
from vobench.reference.lk import LKImage, LKParams, lk_circular_quad


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
                   seed_start_level: int = None,
                   recorder=None) -> CircularMatchResult:
    """Track the bucketed features around the quad and filter: the four
    LK statuses, non-negative coordinates and the Chebyshev round-trip
    closure with the reference's integer truncation. ``seeding`` starts
    each leg from the feature's previous flow/disparity, clamped to
    +-(cols/4, rows/4); ``seed_start_level`` applies only then."""
    pts_l0 = bucketed.points
    valid_in = bucketed.valid
    sl = seed_start_level if seeding else None
    if seeding:
        rows0, cols0 = img_l0.shapes[0]

        def clamp(v):
            return torch.stack([v[..., 0].clamp(-cols0 / 4.0, cols0 / 4.0),
                                v[..., 1].clamp(-rows0 / 4.0, rows0 / 4.0)],
                               dim=-1)

        flow = clamp(bucketed.flow)
        disp = clamp(bucketed.disp)
    else:
        flow = torch.zeros_like(pts_l0)
        disp = torch.zeros_like(pts_l0)
    if sl is None:
        sl = params.levels

    pts_r0, pts_r1, pts_l1, pts_ret, legs_ok = lk_circular_quad(
        img_l0, img_r0, img_r1, img_l1, pts_l0, valid_in, params,
        flow=flow, disp=disp, start_level=sl, recorder=recorder)

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
    """Survivors at their L(t1) positions, carrying the measured flow
    (l1 - l0) and stereo offset (r1 - l1) as the next frame's priors."""
    v = result.valid[..., None]
    zero = torch.zeros_like(result.points_l1)
    return FeatureState(
        points=result.points_l1, ages=result.ages, valid=result.valid,
        ids=result.ids, next_id=result.next_id,
        flow=torch.where(v, result.points_l1 - result.points_l0, zero),
        disp=torch.where(v, result.points_r1 - result.points_l1, zero))


def skip_mode_front(img_l0, img_r0, img_l1, img_r1, bucketed: FeatureState,
                    params: LKParams, config, recorder=None):
    """The skip policy's first half. "fixed": the one quad at the safe
    level, and None. "adaptive": the fast quad (lk_fast_skip_levels
    skipped) and ``aliased``: whether the 64-slot probe at the safe level
    disagrees (> lk_probe_px on > lk_probe_disagree_frac of comparable
    tracks, or fewer than 8 comparable), per sequence."""
    sl_safe = _safe_level(config)
    if not _adaptive(config):
        return _match(img_l0, img_r0, img_l1, img_r1, bucketed, params,
                      config, sl_safe, recorder), None
    sl_fast = config.lk_levels - config.lk_fast_skip_levels
    sl_probe = params.levels if sl_safe is None else sl_safe
    P = bucketed.capacity
    idx = torch.arange(0, P, max(1, P // 64), device=bucketed.valid.device)[:64]
    # the fast quad and the probe as one quad: the probe's slots follow
    # the fast quad's and start at the safe level
    probe_in = bucketed.take(idx)
    both_in = FeatureState(*(torch.cat([x, y], dim=1) if x.dim() > 1 else x
                             for x, y in zip(bucketed, probe_in)))
    levels = torch.where(torch.arange(P + idx.shape[0], device=idx.device) < P,
                         sl_fast, sl_probe)
    top = max(sl_fast, sl_probe)

    def split(images, pts, valid, out, iters, _):
        for a, b, sl in ((0, P, sl_fast), (P, None, sl_probe)):
            recorder(images, pts[:, a:b], valid[:, a:b], out[:, :, a:b],
                     iters[:, :, top - sl:, a:b], sl)

    both_out = _match(img_l0, img_r0, img_l1, img_r1, both_in, params, config,
                      (levels, top), split if recorder is not None else None)
    match_fast = _slots(both_out, 0, P)
    probe = _slots(both_out, P, None)
    both = probe.valid & match_fast.valid[..., idx]
    d = torch.amax(torch.abs(probe.points_l1
                             - match_fast.points_l1[..., idx, :]), dim=-1)
    n_both = both.sum(dim=-1)
    n_bad = (both & (d > config.lk_probe_px)).sum(dim=-1)
    aliased = ((n_bad > config.lk_probe_disagree_frac
                * torch.clamp(n_both, min=1)) | (n_both < 8))
    return match_fast, aliased


def skip_mode_back(img_l0, img_r0, img_l1, img_r1, bucketed: FeatureState,
                   params: LKParams, config, match, aliased, safe: bool,
                   recorder=None):
    """The skip policy's second half: each aliased sequence re-tracked at
    the safe level (the safe quad on ``valid & aliased``), chosen with
    ``torch.where``. ``safe`` False skips the safe quad, which the caller
    may do only where no sequence is aliased: every sequence then keeps
    its fast match, as the quad's all-invalid launch would leave it (its
    work, none, is still handed to ``recorder``). Returns
    (CircularMatchResult, fallback)."""
    if aliased is None:
        return match, torch.zeros(bucketed.next_id.shape, dtype=torch.bool,
                                  device=bucketed.valid.device)
    sl_safe = _safe_level(config)
    if not safe:
        if recorder is not None:
            pts = bucketed.points                       # (B, n, 2)
            B, n = pts.shape[:2]
            sl = params.levels if sl_safe is None else sl_safe
            recorder((img_l0, img_r0, img_r1, img_l1), pts,
                     torch.zeros((B, n), dtype=torch.bool, device=pts.device),
                     torch.zeros((4, B, n, 2), device=pts.device),
                     torch.zeros((B, 4, sl + 1, n), dtype=torch.int32,
                                 device=pts.device), sl)
        return match, aliased
    match_safe = _match(img_l0, img_r0, img_l1, img_r1,
                        bucketed._replace(valid=bucketed.valid
                                          & aliased[..., None]),
                        params, config, sl_safe, recorder)

    def pick(s, f):
        a = aliased.reshape(aliased.shape + (1,) * (s.dim() - aliased.dim()))
        return torch.where(a, s, f)

    picked = CircularMatchResult(*(pick(s, f)
                                   for s, f in zip(match_safe, match)))
    return picked, aliased


def _slots(result: CircularMatchResult, a, b) -> CircularMatchResult:
    """Slots a..b of every sequence; the cursor passes through."""
    return CircularMatchResult(*(x[:, a:b] if x.dim() > 1 else x
                                 for x in result))


def _safe_level(config):
    return (config.lk_levels - config.lk_seed_skip_levels
            if config.lk_seed_skip_levels else None)


def _adaptive(config) -> bool:
    return (config.lk_skip_mode == "adaptive" and config.predictive_seeding
            and config.lk_fast_skip_levels > config.lk_seed_skip_levels)


def _match(img_l0, img_r0, img_l1, img_r1, feats, params, config,
           start_level, recorder):
    return circular_match(img_l0, img_r0, img_l1, img_r1, feats, params,
                          config.circle_threshold,
                          seeding=config.predictive_seeding,
                          seed_start_level=start_level, recorder=recorder)
