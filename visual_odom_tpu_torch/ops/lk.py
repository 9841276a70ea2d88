"""LK parameters and per-image pyramid preparation.

Port of ``visual_odom_tpu/ops/lk.py`` (``LKParams``, ``LKImage``,
``prepare_lk_image``). Parameters mirror the reference: 21x21 window, 3
pyramid levels, <= 30 iterations, eps 0.01, minEigThreshold 0.001
(reference src/feature.cpp:127-139).

Each level plane is padded by ``pad = window + 3`` pixels of REFLECT_101
border on every side, then zero-extended to the aligned extent of
``ops.pyramid.aligned_extent``: the same layout as the JAX package's planes,
so tests can hand those planes to the port as they are. ``LKImage`` holds no
derivative planes: the LK kernel (``ops.lk_cuda``) derives Scharr gradients
from the image itself.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from visual_odom_tpu_torch.ops.pyramid import aligned_extent, padded_pyr_down


class LKParams(NamedTuple):
    window: int = 21
    levels: int = 3
    max_iters: int = 30
    eps: float = 0.01
    min_eig_threshold: float = 0.001


class LKImage(NamedTuple):
    """Padded pyramid of one grayscale image, shared by every LK leg that
    reads the image."""

    pyramid: tuple   # level -> (aligned rows, aligned cols) float32 plane
    shapes: tuple    # level -> (H_l, W_l) unpadded
    pad: int


def _pad_reflect(img: torch.Tensor, pad: int) -> torch.Tensor:
    """REFLECT_101 pad by ``pad``, then the zero alignment tail."""
    h, w = img.shape
    p = F.pad(img[None, None], (pad, pad, pad, pad), mode="reflect")[0, 0]
    return F.pad(p, (0, aligned_extent(w, pad, 1) - (w + 2 * pad),
                     0, aligned_extent(h, pad, 0) - (h + 2 * pad)))


def prepare_lk_image(img: torch.Tensor,
                     params: LKParams = LKParams()) -> LKImage:
    """Build the padded pyramid (levels 0..params.levels) of one image."""
    pad = params.window + 3
    h, w = img.shape
    p = _pad_reflect(img.to(torch.float32), pad)
    planes, shapes = [], []
    for level in range(params.levels + 1):
        planes.append(p)
        shapes.append((h, w))
        if level < params.levels:
            p = padded_pyr_down(p, h, w, pad)
            h, w = -(-h // 2), -(-w // 2)
    return LKImage(tuple(planes), tuple(shapes), pad)
