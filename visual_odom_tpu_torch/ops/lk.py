"""LK parameters, per-image pyramid preparation and the per-leg tracker.

Port of ``visual_odom_tpu/ops/lk.py`` (``LKParams``, ``LKImage``,
``prepare_lk_image``, ``lk_track_pyramid``, ``lk_track``). Parameters
mirror the reference: 21x21 window, 3 pyramid levels, <= 30 iterations,
eps 0.01, minEigThreshold 0.001 (reference src/feature.cpp:127-139).

Each level plane is padded by ``pad = window + 3`` pixels of REFLECT_101
border on every side, then zero-extended to the aligned extent of
``ops.pyramid.aligned_extent``: the same layout as the JAX package's planes,
so tests can hand those planes to the port as they are. ``LKImage`` holds no
derivative planes: the LK kernels (``ops.lk_cuda``) derive Scharr gradients
from the image itself.

``lk_track_pyramid`` is one leg, level by level: the glue of the JAX
package's ``lk_track_pyramid_pallas`` around one launch of the level kernel
per level (``ops.lk_cuda.lk_level_cuda`` for CUDA tensors, its plain
version for CPU tensors). ``ops.lk_cuda`` imports ``LKImage`` and
``LKParams`` from here, so this module imports ``ops.lk_cuda`` inside
``lk_track_pyramid``, not at the top. ``lk_track_pyramid.launches`` and
``.batched_launches`` count the level kernel's launches.
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

    pyramid: tuple   # level -> ([B,] aligned rows, aligned cols) float32 plane
    shapes: tuple    # level -> (H_l, W_l) unpadded
    pad: int


def _pad_reflect(img: torch.Tensor, pad: int) -> torch.Tensor:
    """REFLECT_101 pad of the last two dims by ``pad``, then the zero
    alignment tail."""
    h, w = img.shape[-2:]
    p = F.pad(img.reshape(-1, 1, h, w), (pad, pad, pad, pad), mode="reflect")
    p = F.pad(p, (0, aligned_extent(w, pad, 1) - (w + 2 * pad),
                  0, aligned_extent(h, pad, 0) - (h + 2 * pad)))
    return p.reshape(img.shape[:-2] + p.shape[-2:])


def prepare_lk_image(img: torch.Tensor,
                     params: LKParams = LKParams()) -> LKImage:
    """Build the padded pyramid (levels 0..params.levels) of one (H, W)
    image, or of a (B, H, W) batch: every plane then has the leading B."""
    pad = params.window + 3
    h, w = img.shape[-2:]
    p = _pad_reflect(img.to(torch.float32), pad)
    planes, shapes = [], []
    for level in range(params.levels + 1):
        planes.append(p)
        shapes.append((h, w))
        if level < params.levels:
            p = padded_pyr_down(p, h, w, pad)
            h, w = -(-h // 2), -(-w // 2)
    return LKImage(tuple(planes), tuple(shapes), pad)


def lk_track_pyramid(image_I: LKImage, image_J: LKImage, pts: torch.Tensor,
                     valid: torch.Tensor, params: LKParams = LKParams(),
                     init_pts: torch.Tensor = None, start_level: int = None,
                     slot_devices=None):
    """Track features from image I to image J, one level launch per level.

    pts: (n, 2) float32 source positions (x, y) at full resolution; valid:
    (n,) bool, inactive slots pass ``pts`` through with status False;
    init_pts: optional (n, 2) start estimates (OpenCV's
    OPTFLOW_USE_INITIAL_FLOW), default ``pts``; start_level: the level the
    coarse-to-fine refinement starts at, default ``params.levels``.
    With a leading batch dim on the images' planes and on every feature
    tensor it is ``vmap(lk_track_pyramid)``, one launch per level for all
    B sequences. Returns (pts1 (n, 2) float32, status (n,) bool).
    ``slot_devices`` (a mesh row's "model" positions, as
    ``ops.lk_cuda.lk_circular_quad`` takes them) splits the slots over
    them, each slice tracked through every level on its position: bit
    for bit the unsplit leg (``ops.lk_cuda.split_slots``).
    """
    from visual_odom_tpu_torch.ops import lk_cuda
    from visual_odom_tpu_torch.utils.cudagraph import kernel

    if lk_cuda.wants_split(slot_devices):
        if init_pts is None:
            init_pts = pts
        return lk_cuda.split_slots(
            lambda ims, p, v, i: lk_track_pyramid(
                *ims, p, v, params, init_pts=i, start_level=start_level),
            (image_I, image_J), (pts, valid, init_pts), 1, slot_devices)

    if pts.device.type == "cuda":
        track = lk_cuda.lk_level_cuda
        # converted once here, not once per level by the wrapper
        mask = valid.to(torch.int32)
    elif pts.device.type == "cpu":
        track = (lk_cuda.lk_level_plain_batched if pts.dim() == 3
                 else lk_cuda.lk_level_plain)
        mask = valid
    else:
        raise ValueError(f"no LK implementation for device {pts.device}")
    sl = params.levels if start_level is None else start_level
    half = (params.window - 1) * 0.5
    rows0, cols0 = image_I.shapes[0]
    # Invalid slots sit at the image centre (cheap in-bounds gathers); their
    # results are masked out below. Filled in place: no host-to-device copy.
    center = torch.empty_like(pts)
    center[..., 0] = cols0 * 0.5
    center[..., 1] = rows0 * 0.5
    keep = valid[..., None]
    safe = torch.where(keep, pts, center)
    init = safe if init_pts is None else torch.where(keep, init_pts, center)
    nxt = init / 2.0 ** sl
    for level in range(sl, -1, -1):
        rows, cols = image_I.shapes[level]
        prev = safe / 2.0 ** level - half
        if level != sl:
            nxt = nxt * 2.0
        out, ok = kernel(track, image_I.pyramid[level],
                         image_J.pyramid[level], rows, cols, image_I.pad,
                         prev, nxt - half, mask, params, level == 0)[:2]
        nxt = out + half
    return torch.where(keep, nxt, pts), ok & valid


lk_track_pyramid.launches = 0
lk_track_pyramid.batched_launches = 0


def lk_track(img_I: torch.Tensor, img_J: torch.Tensor, pts: torch.Tensor,
             params: LKParams = LKParams()):
    """One-shot tracking of ``pts`` from img_I to img_J (featureTracking,
    reference src/feature.cpp:64-74): both pyramids are prepared on the
    device of ``pts``. The pipeline prepares each image once and calls
    ``lk_track_pyramid`` instead."""
    li = prepare_lk_image(torch.as_tensor(img_I, device=pts.device), params)
    lj = prepare_lk_image(torch.as_tensor(img_J, device=pts.device), params)
    valid = torch.ones(pts.shape[:-1], dtype=torch.bool, device=pts.device)
    return lk_track_pyramid(li, lj, pts, valid, params)
