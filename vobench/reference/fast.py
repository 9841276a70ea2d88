"""FAST-9/16 corner detection and the Shi-Tomasi detector, as dense score

Frozen copy of ``visual_odom_tpu_torch/ops/fast.py`` at commit 245329126dfa,
with its imports pointed at this package: the benchmark's yardstick, which
a change to the program must not move. The text below is the original's.
maps.

Port of ``visual_odom_tpu/ops/fast.py`` (``fast_score_map``,
``fast_corners``, ``shi_tomasi_score_map``, ``shi_tomasi_corner_map``,
``good_features_to_track``). ``fast_score_map`` is the equivalent of
cv::FAST(threshold=20, nonmaxSuppression=true) (reference
src/feature.cpp:39-47). A pixel is a corner iff >= 9 contiguous pixels of
its 16-pixel Bresenham circle are all brighter than p + t or all darker
than p - t; the score is OpenCV's cornerScore (the largest threshold at
which the pixel is still a corner, minus 1). The 3-pixel border is zero and
NMS keeps pixels strictly greater than all 8 neighbours. Every value is an
integer in float32, so the map equals the JAX package's exactly.

The Shi-Tomasi response is cv::goodFeaturesToTrack's (reference
src/feature.cpp:49-62): Sobel 3 derivatives, a 3x3 box of their products
and the smaller eigenvalue of the structure tensor over 2; its corner map
keeps the same contract as FAST's (score > 0 exactly at corners), so the
bucketing takes either. Every function takes (H, W) or (B, H, W) images.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from vobench.reference.pyramid import _sep_filter2

# Bresenham circle of radius 3, OpenCV pixel order (clockwise from top),
# as (dy, dx).
_CIRCLE = (
    (-3, 0), (-3, 1), (-2, 2), (-1, 3),
    (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3),
    (0, -3), (-1, -3), (-2, -2), (-3, -1),
)
_ARC = 9
_BORDER = 3


def _shifted(padded: torch.Tensor, H: int, W: int, dy: int,
             dx: int) -> torch.Tensor:
    """out[..., y, x] = img[..., y + dy, x + dx] from an edge-padded (by
    _BORDER) img."""
    return padded[..., _BORDER + dy:_BORDER + dy + H,
                  _BORDER + dx:_BORDER + dx + W]


def _edge_pad(x: torch.Tensor) -> torch.Tensor:
    h, w = x.shape[-2:]
    p = F.pad(x.reshape(-1, 1, h, w), (_BORDER,) * 4, mode="replicate")
    return p.reshape(x.shape[:-2] + p.shape[-2:])


def fast_score_map(img: torch.Tensor, threshold: int = 20,
                   nonmax: bool = True) -> torch.Tensor:
    """(H, W) float32 map of an (H, W) image, or (B, H, W) of a batch;
    score > 0 exactly at detected corners."""
    x = img.to(torch.float32)
    H, W = x.shape[-2:]
    xp = _edge_pad(x)
    d = torch.stack([_shifted(xp, H, W, dy, dx) for dy, dx in _CIRCLE]) - x
    d_wrap = torch.cat([d, d[:_ARC - 1]], dim=0)        # (24, H, W)
    win = d_wrap.unfold(0, _ARC, 1)                     # (16, H, W, 9)
    v_bright = win.amin(dim=-1).amax(dim=0)             # max over starts
    v_dark = (-win).amin(dim=-1).amax(dim=0)
    t = float(threshold)
    is_corner = (v_bright > t) | (v_dark > t)
    score = torch.where(is_corner, torch.maximum(v_bright, v_dark) - 1.0,
                        torch.zeros_like(x))
    inner = torch.zeros_like(score)
    inner[..., _BORDER:H - _BORDER, _BORDER:W - _BORDER] = 1.0
    score = score * inner

    if nonmax:
        sp = _edge_pad(score)
        nbr = torch.stack([_shifted(sp, H, W, dy, dx)
                           for dy in (-1, 0, 1) for dx in (-1, 0, 1)
                           if (dy, dx) != (0, 0)]).amax(dim=0)
        score = torch.where(score > nbr, score, torch.zeros_like(score))
    return score


def _top_corners(score: torch.Tensor, max_corners: int):
    """(points (..., K, 2) xy, scores (..., K), valid (..., K)) of the K
    highest entries of (..., H, W) maps, score-descending."""
    H, W = score.shape[-2:]
    flat = score.reshape(score.shape[:-2] + (H * W,))
    top_scores, top_idx = torch.topk(flat, min(max_corners, H * W), dim=-1)
    pts = torch.stack([(top_idx % W).to(torch.float32),
                       (top_idx // W).to(torch.float32)], dim=-1)
    return pts, top_scores, top_scores > 0


def fast_corners(img: torch.Tensor, threshold: int = 20, nonmax: bool = True,
                 max_corners: int = 4096):
    """Sparse FAST corner list of fixed capacity, score-descending:
    (points (K, 2) float32 xy, scores (K,), valid (K,) bool). Among equal
    scores the order is the top-k's, which on CUDA need not be the lowest
    index first: compare the lists as sets."""
    return _top_corners(fast_score_map(img, threshold=threshold,
                                       nonmax=nonmax), max_corners)


_SOBEL_SMOOTH = np.array([1.0, 2.0, 1.0], dtype=np.float32)
_SOBEL_DIFF = np.array([-1.0, 0.0, 1.0], dtype=np.float32)


def shi_tomasi_score_map(img: torch.Tensor, block_size: int = 3) -> torch.Tensor:
    """Min-eigenvalue (Shi-Tomasi) response, cv::cornerMinEigenVal with
    blockSize 3 and Sobel aperture 3 (OpenCV halves the eigenvalue)."""
    x = img.to(torch.float32)
    ix = _sep_filter2(x, _SOBEL_SMOOTH, _SOBEL_DIFF)
    iy = _sep_filter2(x, _SOBEL_DIFF, _SOBEL_SMOOTH)
    box = np.ones(block_size, dtype=np.float32)
    jxx = _sep_filter2(ix * ix, box, box)
    jyy = _sep_filter2(iy * iy, box, box)
    jxy = _sep_filter2(ix * iy, box, box)
    tr = 0.5 * (jxx + jyy)
    det_root = torch.sqrt(torch.clamp(0.25 * (jxx - jyy) ** 2 + jxy * jxy,
                                      min=0.0))
    return tr - det_root


def shi_tomasi_corner_map(img: torch.Tensor, quality_level: float = 0.01,
                          min_distance: float = 5.0) -> torch.Tensor:
    """Dense corner map with goodFeaturesToTrack semantics (maxCorners
    5000, qualityLevel 0.01, minDistance 5 in the reference): score > 0
    exactly at accepted corners. Min-distance suppression is a (2r+1)^2
    square-window maximum with ``score >= pooled``, so every member of an
    exactly tied plateau inside one window survives; the quality gate is
    relative to each image's own maximum."""
    score = shi_tomasi_score_map(img)
    r = int(min_distance)
    H, W = score.shape[-2:]
    # max pooling pads with -inf, as the JAX package's reduce_window does
    pooled = F.max_pool2d(score.reshape((-1, 1, H, W)), 2 * r + 1, stride=1,
                          padding=r).reshape(score.shape)
    peak_max = score.amax(dim=(-2, -1), keepdim=True)
    is_peak = (score >= pooled) & (score > quality_level * peak_max)
    return torch.where(is_peak, score, torch.zeros_like(score))


def good_features_to_track(img: torch.Tensor, max_corners: int = 5000,
                           quality_level: float = 0.01,
                           min_distance: float = 5.0):
    """cv::goodFeaturesToTrack's behaviour (reference src/feature.cpp:
    49-62), min-distance by the square-window maximum: (points (K, 2) xy,
    scores (K,), valid (K,)), score-descending; ties as in
    ``fast_corners``."""
    return _top_corners(shi_tomasi_corner_map(img, quality_level,
                                              min_distance), max_corners)
