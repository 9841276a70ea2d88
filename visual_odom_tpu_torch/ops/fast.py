"""FAST-9/16 corner detection as a dense score map.

Port of ``visual_odom_tpu/ops/fast.py:fast_score_map``: the equivalent of
cv::FAST(threshold=20, nonmaxSuppression=true) (reference
src/feature.cpp:39-47). A pixel is a corner iff >= 9 contiguous pixels of
its 16-pixel Bresenham circle are all brighter than p + t or all darker
than p - t; the score is OpenCV's cornerScore (the largest threshold at
which the pixel is still a corner, minus 1). The 3-pixel border is zero and
NMS keeps pixels strictly greater than all 8 neighbours. Every value is an
integer in float32, so the map equals the JAX package's exactly.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

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
