"""Fused FAST detection + spatial bucketing.

Port of ``visual_odom_tpu/frontend/bucketing.py:detect_and_bucket`` (FAST
branch). Reference behaviour: appendNewFeatures below 2000 live features
(src/visualOdometry.cpp:95-101) and bucketingFeatures with a per-cell cap
and age cap 10 (src/feature.cpp:206-253, src/bucket.cpp:14-45).

Output slots [i*K, (i+1)*K) hold grid cell i: its K oldest tracked
features first (scatter-max of the key (age, -slot)), then its strongest
fresh corners (K max/argmax rounds, ties to the first index). Fresh corners
inherit a neighbour motion prior: tracked flows and disparities averaged
per cell and spread 4 rings into empty cells.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from visual_odom_tpu_torch.config import VOConfig
from visual_odom_tpu_torch.frontend.featureset import FeatureState
from visual_odom_tpu_torch.ops.fast import fast_score_map


def _cell_priors(fcell, participating, flow, disp, gh: int, gw: int):
    """Per-cell mean flow/disp of the participating tracked features, with
    holes filled from 3x3 neighbourhoods, 4 rings deep. Returns
    ((G, 2) flow, (G, 2) disp)."""
    G = gh * gw
    w = participating.to(torch.float32)
    # One-hot matmul instead of a scatter-add: deterministic sums.
    onehot = (fcell[None, :] == torch.arange(G, device=fcell.device)[:, None])
    sums = onehot.to(torch.float32) @ torch.cat(
        [w[:, None], flow * w[:, None], disp * w[:, None]], dim=1)  # (G, 5)
    cnt = sums[:, 0]
    denom = torch.clamp(cnt, min=1.0)[:, None]
    cell_flow = (sums[:, 1:3] / denom).reshape(gh, gw, 2)
    cell_disp = (sums[:, 3:5] / denom).reshape(gh, gw, 2)
    have = (cnt > 0).reshape(gh, gw)
    box = torch.ones((5, 1, 3, 3), dtype=torch.float32, device=fcell.device)
    for _ in range(4):
        hf = have.to(torch.float32)
        planes = torch.stack([hf, cell_flow[..., 0] * hf, cell_flow[..., 1] * hf,
                              cell_disp[..., 0] * hf, cell_disp[..., 1] * hf])
        nsum = F.conv2d(planes[None], box, padding=1, groups=5)[0]
        ncnt = nsum[0]
        fill = (~have) & (ncnt > 0)
        nd = torch.clamp(ncnt, min=1.0)[..., None]
        cell_flow = torch.where(fill[..., None],
                                nsum[1:3].permute(1, 2, 0) / nd, cell_flow)
        cell_disp = torch.where(fill[..., None],
                                nsum[3:5].permute(1, 2, 0) / nd, cell_disp)
        have = have | fill
    return cell_flow.reshape(G, 2), cell_disp.reshape(G, 2)


def detect_and_bucket(image_l0: torch.Tensor, state: FeatureState,
                      config: VOConfig) -> FeatureState:
    """K bucketed features per grid cell, from tracked state + fresh FAST.

    image_l0: (H, W) left image at t0 (float32 0..255); state positions are
    in its coordinates. Returns a FeatureState of capacity
    config.padded_features where slot i*K + k is cell i's k-th winner.
    """
    if config.detector != "fast":
        raise NotImplementedError(
            f"detector {config.detector!r} is not ported; only 'fast' is")
    dev = image_l0.device
    bs = config.bucket_size
    gh, gw = config.grid_h, config.grid_w
    G = gh * gw
    K = config.features_per_bucket
    P = config.padded_features
    N = state.capacity

    # ---- best K fresh corners per cell ------------------------------------
    score = fast_score_map(image_l0, threshold=config.fast_threshold,
                           nonmax=config.fast_nonmax)
    cells = (score[:gh * bs, :gw * bs].reshape(gh, bs, gw, bs)
             .permute(0, 2, 1, 3).reshape(G, bs * bs))
    scores_k, offs_k = [], []
    remaining = cells
    for _ in range(K):
        s_best = remaining.amax(dim=1)
        o_best = remaining.argmax(dim=1)
        scores_k.append(s_best)
        offs_k.append(o_best)
        if K > 1:
            remaining = remaining.scatter(1, o_best[:, None], float("-inf"))
    corner_score = torch.stack(scores_k, dim=1)                  # (G, K)
    corner_off = torch.stack(offs_k, dim=1)
    cell_ids = torch.arange(G, dtype=torch.int32, device=dev)
    cy = cell_ids // gw
    cx = cell_ids % gw
    corner_x = (cx[:, None] * bs + corner_off % bs).to(torch.float32)
    corner_y = (cy[:, None] * bs + corner_off // bs).to(torch.float32)
    corner_pts = torch.stack([corner_x, corner_y], dim=-1)       # (G, K, 2)
    replenish = state.count() < config.replenish_below
    corner_ok = (corner_score > 0) & replenish

    # ---- best K tracked features per cell (K scatter-max rounds) ----------
    fcx = torch.clamp((state.points[:, 0] / bs).to(torch.int64), 0, gw - 1)
    fcy = torch.clamp((state.points[:, 1] / bs).to(torch.int64), 0, gh - 1)
    fcell = fcy * gw + fcx
    participating = state.valid & (state.ages < config.age_threshold)
    slot = torch.arange(N, dtype=torch.int32, device=dev)
    key = torch.where(participating, state.ages * N + (N - 1 - slot),
                      torch.full_like(slot, -1))
    tracked_slots, tracked_oks = [], []
    for k in range(K):
        cell_best = torch.full((G,), -1, dtype=torch.int32, device=dev
                               ).scatter_reduce(0, fcell, key, reduce="amax")
        ok = cell_best >= 0
        tracked_slots.append((N - 1 - torch.clamp(cell_best, min=0) % N).long())
        tracked_oks.append(ok)
        if k + 1 < K:
            won = ok[fcell] & (key == cell_best[fcell])
            key = torch.where(won, torch.full_like(key, -1), key)
    t_slot = torch.stack(tracked_slots, dim=1)                   # (G, K)
    has_tracked = torch.stack(tracked_oks, dim=1)

    # ---- combine: tracked features first, corners fill the remainder ------
    n_tracked = has_tracked.sum(dim=1, dtype=torch.int32)[:, None]
    j = torch.arange(K, dtype=torch.int32, device=dev)[None, :]
    take_tracked = j < n_tracked                                 # (G, K)
    c_idx = torch.clamp(j - n_tracked, 0, K - 1).long()
    c_pts = torch.take_along_dim(corner_pts, c_idx[..., None], dim=1)
    c_ok = torch.take_along_dim(corner_ok, c_idx, dim=1) & (j >= n_tracked)

    tt = take_tracked[..., None]
    out_pts = torch.where(tt, state.points[t_slot], c_pts)
    out_ages = torch.where(take_tracked, state.ages[t_slot],
                           torch.zeros_like(t_slot, dtype=torch.int32))
    out_valid = take_tracked | c_ok
    cell_flow, cell_disp = _cell_priors(fcell, participating, state.flow,
                                        state.disp, gh, gw)
    out_flow = torch.where(tt, state.flow[t_slot], cell_flow[:, None, :])
    out_disp = torch.where(tt, state.disp[t_slot], cell_disp[:, None, :])
    fresh_ids = state.next_id + cell_ids[:, None] * K + j
    out_ids = torch.where(take_tracked, state.ids[t_slot],
                          torch.where(c_ok, fresh_ids,
                                      torch.full_like(fresh_ids, -1)))

    GK = G * K
    pad = P - GK
    return FeatureState(
        points=F.pad(out_pts.reshape(GK, 2), (0, 0, 0, pad)),
        ages=F.pad(out_ages.reshape(GK), (0, pad)),
        valid=F.pad(out_valid.reshape(GK), (0, pad)),
        ids=F.pad(out_ids.reshape(GK), (0, pad), value=-1),
        next_id=state.next_id + GK,
        flow=F.pad(out_flow.reshape(GK, 2), (0, 0, 0, pad)),
        disp=F.pad(out_disp.reshape(GK, 2), (0, 0, 0, pad)),
    )
