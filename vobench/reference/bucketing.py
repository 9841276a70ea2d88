"""Fused corner detection + spatial bucketing.

Frozen copy of ``visual_odom_tpu_torch/frontend/bucketing.py`` at commit 245329126dfa,
with its imports pointed at this package: the benchmark's yardstick, which
a change to the program must not move. The text below is the original's.

Port of ``visual_odom_tpu/frontend/bucketing.py:detect_and_bucket``, with
the FAST or the Shi-Tomasi detector as ``config.detector`` picks (both give
a dense map with score > 0 exactly at corners). Reference behaviour:
appendNewFeatures below 2000 live features (src/visualOdometry.cpp:95-101)
and bucketingFeatures with a per-cell cap and age cap 10
(src/feature.cpp:206-253, src/bucket.cpp:14-45).

Output slots [i*K, (i+1)*K) hold grid cell i: its K oldest tracked
features first (scatter-max of the key (age, -slot)), then its strongest
fresh corners (K max/argmax rounds, ties to the first index). Fresh corners
inherit a neighbour motion prior: tracked flows and disparities averaged
per cell and spread 4 rings into empty cells.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from vobench.reference.config import VOConfig
from vobench.reference.featureset import FeatureState
from vobench.reference.fast import (fast_score_map,
                                           shi_tomasi_corner_map)


def _cell_priors(fcell, participating, flow, disp, gh: int, gw: int):
    """Per-cell mean flow/disp of the participating tracked features, with
    holes filled from 3x3 neighbourhoods, 4 rings deep, per sequence of a
    (B, N) batch. Returns ((B, G, 2) flow, (B, G, 2) disp)."""
    B = fcell.shape[0]
    G = gh * gw
    w = participating.to(torch.float32)[..., None]
    # One-hot matmul instead of a scatter-add: deterministic sums.
    onehot = fcell[:, None, :] == torch.arange(G, device=fcell.device)[:, None]
    sums = torch.bmm(onehot.to(torch.float32),
                     torch.cat([w, flow * w, disp * w], dim=-1))  # (B, G, 5)
    cnt = sums[..., 0]
    denom = torch.clamp(cnt, min=1.0)[..., None]
    cell_flow = (sums[..., 1:3] / denom).reshape(B, gh, gw, 2)
    cell_disp = (sums[..., 3:5] / denom).reshape(B, gh, gw, 2)
    have = (cnt > 0).reshape(B, gh, gw)
    box = torch.ones((5, 1, 3, 3), dtype=torch.float32, device=fcell.device)
    for _ in range(4):
        hf = have.to(torch.float32)
        planes = torch.stack([hf, cell_flow[..., 0] * hf, cell_flow[..., 1] * hf,
                              cell_disp[..., 0] * hf, cell_disp[..., 1] * hf],
                             dim=1)
        nsum = F.conv2d(planes, box, padding=1, groups=5)    # (B, 5, gh, gw)
        ncnt = nsum[:, 0]
        fill = (~have) & (ncnt > 0)
        nd = torch.clamp(ncnt, min=1.0)[..., None]
        cell_flow = torch.where(fill[..., None],
                                nsum[:, 1:3].permute(0, 2, 3, 1) / nd, cell_flow)
        cell_disp = torch.where(fill[..., None],
                                nsum[:, 3:5].permute(0, 2, 3, 1) / nd, cell_disp)
        have = have | fill
    return cell_flow.reshape(B, G, 2), cell_disp.reshape(B, G, 2)


def detect_and_bucket(image_l0: torch.Tensor, state: FeatureState,
                      config: VOConfig) -> FeatureState:
    """K bucketed features per grid cell, from tracked state + fresh
    corners of ``config.detector``.

    image_l0: (H, W) left image at t0 (float32 0..255); state positions are
    in its coordinates. Returns a FeatureState of capacity
    config.padded_features where slot i*K + k is cell i's k-th winner.
    With a (B, H, W) image and a batched state each sequence is bucketed
    on its own (the single image is the B = 1 case).
    """
    if image_l0.dim() == 2:
        out = detect_and_bucket(image_l0[None],
                                FeatureState(*(a[None] for a in state)), config)
        return FeatureState(*(a[0] for a in out))
    dev = image_l0.device
    B = image_l0.shape[0]
    bs = config.bucket_size
    gh, gw = config.grid_h, config.grid_w
    G = gh * gw
    K = config.features_per_bucket
    P = config.padded_features
    N = state.capacity

    # ---- best K fresh corners per cell ------------------------------------
    if config.detector == "shi-tomasi":
        score = shi_tomasi_corner_map(
            image_l0, quality_level=config.shi_tomasi_quality,
            min_distance=config.shi_tomasi_min_distance)
    else:
        score = fast_score_map(image_l0, threshold=config.fast_threshold,
                               nonmax=config.fast_nonmax)
    cells = (score[:, :gh * bs, :gw * bs].reshape(B, gh, bs, gw, bs)
             .permute(0, 1, 3, 2, 4).reshape(B, G, bs * bs))
    scores_k, offs_k = [], []
    remaining = cells
    for _ in range(K):
        s_best = remaining.amax(dim=-1)
        o_best = remaining.argmax(dim=-1)
        scores_k.append(s_best)
        offs_k.append(o_best)
        if K > 1:
            remaining = remaining.scatter(-1, o_best[..., None], float("-inf"))
    corner_score = torch.stack(scores_k, dim=-1)                 # (B, G, K)
    corner_off = torch.stack(offs_k, dim=-1)
    cell_ids = torch.arange(G, dtype=torch.int32, device=dev)
    cy = cell_ids // gw
    cx = cell_ids % gw
    corner_x = (cx[:, None] * bs + corner_off % bs).to(torch.float32)
    corner_y = (cy[:, None] * bs + corner_off // bs).to(torch.float32)
    corner_pts = torch.stack([corner_x, corner_y], dim=-1)       # (B, G, K, 2)
    replenish = state.count() < config.replenish_below           # (B,)
    corner_ok = (corner_score > 0) & replenish[:, None, None]

    # ---- best K tracked features per cell (K scatter-max rounds) ----------
    # Row b of the (B, G) scatter target holds sequence b's cells, so the
    # sequences never share a cell.
    fcx = torch.clamp((state.points[..., 0] / bs).to(torch.int64), 0, gw - 1)
    fcy = torch.clamp((state.points[..., 1] / bs).to(torch.int64), 0, gh - 1)
    fcell = fcy * gw + fcx                                       # (B, N)
    participating = state.valid & (state.ages < config.age_threshold)
    slot = torch.arange(N, dtype=torch.int32, device=dev)
    key = torch.where(participating, state.ages * N + (N - 1 - slot),
                      torch.full_like(slot, -1))
    tracked_slots, tracked_oks = [], []
    for k in range(K):
        cell_best = torch.full((B, G), -1, dtype=torch.int32, device=dev
                               ).scatter_reduce(1, fcell, key, reduce="amax")
        ok = cell_best >= 0
        tracked_slots.append((N - 1 - torch.clamp(cell_best, min=0) % N).long())
        tracked_oks.append(ok)
        if k + 1 < K:
            won = ok.gather(1, fcell) & (key == cell_best.gather(1, fcell))
            key = torch.where(won, torch.full_like(key, -1), key)
    t_slot = torch.stack(tracked_slots, dim=-1)                  # (B, G, K)
    has_tracked = torch.stack(tracked_oks, dim=-1)

    def tracked(a):
        """Field ``a`` (B, N[, 2]) at the winning slots -> (B, G, K[, 2])."""
        idx = t_slot.reshape(B, G * K)
        if a.dim() == 3:
            idx = idx[..., None]
        return torch.take_along_dim(a, idx, dim=1).reshape(
            (B, G, K) + a.shape[2:])

    # ---- combine: tracked features first, corners fill the remainder ------
    n_tracked = has_tracked.sum(dim=-1, dtype=torch.int32)[..., None]
    j = torch.arange(K, dtype=torch.int32, device=dev)
    take_tracked = j < n_tracked                                 # (B, G, K)
    c_idx = torch.clamp(j - n_tracked, 0, K - 1).long()
    c_pts = torch.take_along_dim(corner_pts, c_idx[..., None], dim=2)
    c_ok = torch.take_along_dim(corner_ok, c_idx, dim=2) & (j >= n_tracked)

    tt = take_tracked[..., None]
    out_pts = torch.where(tt, tracked(state.points), c_pts)
    out_ages = torch.where(take_tracked, tracked(state.ages),
                           torch.zeros_like(t_slot, dtype=torch.int32))
    out_valid = take_tracked | c_ok
    cell_flow, cell_disp = _cell_priors(fcell, participating, state.flow,
                                        state.disp, gh, gw)
    out_flow = torch.where(tt, tracked(state.flow), cell_flow[:, :, None, :])
    out_disp = torch.where(tt, tracked(state.disp), cell_disp[:, :, None, :])
    fresh_ids = state.next_id[:, None, None] + cell_ids[:, None] * K + j
    out_ids = torch.where(take_tracked, tracked(state.ids),
                          torch.where(c_ok, fresh_ids,
                                      torch.full_like(fresh_ids, -1)))

    GK = G * K
    pad = P - GK
    return FeatureState(
        points=F.pad(out_pts.reshape(B, GK, 2), (0, 0, 0, pad)),
        ages=F.pad(out_ages.reshape(B, GK), (0, pad)),
        valid=F.pad(out_valid.reshape(B, GK), (0, pad)),
        ids=F.pad(out_ids.reshape(B, GK), (0, pad), value=-1),
        next_id=state.next_id + GK,
        flow=F.pad(out_flow.reshape(B, GK, 2), (0, 0, 0, pad)),
        disp=F.pad(out_disp.reshape(B, GK, 2), (0, 0, 0, pad)),
    )
