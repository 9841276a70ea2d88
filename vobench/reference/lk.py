"""Plain pyramidal LK: the padded pyramid and the circular quad.

Frozen copy of ``visual_odom_tpu_torch/ops/lk.py`` (``LKParams``,
``LKImage``, ``prepare_lk_image``) and of the plain quad in
``visual_odom_tpu_torch/ops/lk_cuda.py`` (``_template``, ``_solve``,
``lk_quad_plain``) at commit 245329126dfa, kept here so that a change to
the program's kernels or their plain twins cannot move the yardstick.

Departures from the copied plain quad, none of which changes what it
computes:

- The B sequences of a batched call are one flat set of features, each
  gathering from its own sequence's planes (the copy looped over B).
- The update loop always runs ``max_iters`` rounds: a feature that has
  stopped is left untouched by the masks, so the rounds after the last
  feature stops change nothing. Without the copy's early exit (a host read
  of ``active.any()`` every round) the step has no host sync and can be
  captured as one CUDA graph.
- x and y pass through each elementwise operation as one (m, 2) tensor,
  and a quad may give each slot its own start level, so that two quads
  over the same images (the fast quad and the probe) run as one: the
  same arithmetic per feature in fewer, larger operations.

``lk_circular_quad`` may be handed a ``recorder``: it is called once per
quad with (images, pts, valid, out, iters, start_level), which the LK work
count reads.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from vobench.reference.pyramid import aligned_extent, padded_pyr_down

# Scharr taps (3,10,3)/16 x (-1,0,1)/2.
_SM0, _SM1, _SM2 = 3.0 / 16.0, 10.0 / 16.0, 3.0 / 16.0
_DF0, _DF2 = -0.5, 0.5
_D_EPS = 1.19209e-07 * (1024.0 ** 2)

#: (seed source, sign) per leg of the quad; leg k tracks image k -> k+1 of
#: (L0, R0, R1, L1) cyclically.
QUAD_SEEDS = (("disp", 1.0), ("flow", 1.0), ("disp", -1.0), ("flow", -1.0))


class LKParams(NamedTuple):
    window: int = 21
    levels: int = 3
    max_iters: int = 30
    eps: float = 0.01
    min_eig_threshold: float = 0.001


class LKImage(NamedTuple):
    """Padded pyramid of one grayscale image (or a (B, H, W) batch)."""

    pyramid: tuple   # level -> ([B,] aligned rows, aligned cols) float32
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
    """The padded pyramid (levels 0..params.levels) of an (H, W) image or
    a (B, H, W) batch."""
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


def _to_int(f: torch.Tensor) -> torch.Tensor:
    """floor()ed float -> int64, clamped so runaway estimates stay far out
    of bounds instead of wrapping."""
    return f.clamp(-1.0e9, 1.0e9).to(torch.int64)


def _gather_block(plane: torch.Tensor, seq: torch.Tensor, y0: torch.Tensor,
                  x0: torch.Tensor, size: int) -> torch.Tensor:
    """(m, size, size) windows with top-left corners (y0, x0) of the planes
    (B, Hp, Wp) of each feature's sequence ``seq``."""
    r = torch.arange(size, device=plane.device)
    rows = (y0[:, None] + r)[:, :, None]
    cols = (x0[:, None] + r)[:, None, :]
    return plane[seq[:, None, None], rows, cols]


def _bilinear(wnd: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
              win: int) -> torch.Tensor:
    """(m, win+1, win+1) windows -> (m, win, win) patches, OpenCV weights."""
    a = a[:, None, None]
    b = b[:, None, None]
    w00 = (1.0 - a) * (1.0 - b)
    w01 = a * (1.0 - b)
    w10 = (1.0 - a) * b
    w11 = a * b
    w1 = win + 1
    return (w00 * wnd[:, :win, :win] + w01 * wnd[:, :win, 1:w1]
            + w10 * wnd[:, 1:w1, :win] + w11 * wnd[:, 1:w1, 1:w1])


def _pair(x_val, y_val, like: torch.Tensor) -> torch.Tensor:
    """A (2,) tensor (x_val, y_val) of ``like``'s dtype and device, made
    without a host-to-device copy (so it may be made inside a capture)."""
    first = torch.arange(2, device=like.device) == 0
    return torch.where(first, x_val, y_val).to(like.dtype)


def _template(plane, seq, rows, cols, pad, p, params: LKParams):
    """Per-feature template setup at one level, at template corners ``p``
    (m, 2) = (x, y): superblock gather, in-block Scharr, bilinear patches
    and the spectral gate."""
    win = params.window
    w1 = win + 1
    Hp, Wp = rows + 2 * pad, cols + 2 * pad
    f = torch.floor(p)
    ab = p - f
    a = ab[:, 0]
    b = ab[:, 1]
    i = _to_int(f)
    templ_ok = ((i >= -win) & (i < _pair(cols, rows, i))).all(-1)
    s = torch.minimum((i + pad).clamp(min=1),
                      _pair(Wp - w1 - 1, Hp - w1 - 1, i))
    blk = _gather_block(plane, seq, s[:, 1] - 1, s[:, 0] - 1, w1 + 2)
    wI = blk[:, 1:1 + w1, 1:1 + w1]
    smr = (blk[:, 0:w1, :] * _SM0 + blk[:, 1:w1 + 1, :] * _SM1
           + blk[:, 2:w1 + 2, :] * _SM2)
    wIx = smr[:, :, 0:w1] * _DF0 + smr[:, :, 2:w1 + 2] * _DF2
    dfr = blk[:, 0:w1, :] * _DF0 + blk[:, 2:w1 + 2, :] * _DF2
    wIy = (dfr[:, :, 0:w1] * _SM0 + dfr[:, :, 1:w1 + 1] * _SM1
           + dfr[:, :, 2:w1 + 2] * _SM2)
    templ = _bilinear(wI, a, b, win)
    gx = _bilinear(wIx, a, b, win)
    gy = _bilinear(wIy, a, b, win)
    A11 = (gx * gx).sum((1, 2))
    A12 = (gx * gy).sum((1, 2))
    A22 = (gy * gy).sum((1, 2))
    D = A11 * A22 - A12 * A12
    dd = A11 - A22
    min_eig = (A22 + A11 - torch.sqrt(dd * dd + 4.0 * A12 * A12)) / (
        2.0 * float(win * win) * 1024.0)
    level_ok = templ_ok & (min_eig >= params.min_eig_threshold) & (D >= _D_EPS)
    inv_D = 1.0 / torch.where(D == 0.0, torch.ones_like(D), D)
    return templ, gx, gy, A11, A12, A22, inv_D, level_ok


def _solve(J, seq, rows, cols, pad, setup, xy, finest: bool,
           params: LKParams):
    """The masked iteration loop of one level from ``xy`` (m, 2),
    ``max_iters`` rounds. Returns the refined (m, 2) positions, the level-0
    bounds status and each feature's update count. x and y go through each
    elementwise operation together, with the copy's arithmetic."""
    templ, gx, gy, A11, A12, A22, inv_D, level_ok = setup
    win = params.window
    w1 = win + 1
    Hp, Wp = rows + 2 * pad, cols + 2 * pad
    eps2 = params.eps * params.eps
    like = torch.empty(0, dtype=torch.int64, device=xy.device)
    hi = _pair(cols, rows, like)
    top = _pair(Wp - w1, Hp - w1, like)
    pd = torch.zeros_like(xy)
    ji = torch.zeros(xy.shape[:1], dtype=torch.int32, device=xy.device)
    ok0 = torch.ones_like(level_ok)
    active = level_ok.clone()
    for _ in range(max(params.max_iters, 1)):
        jf = torch.floor(xy)
        ab = xy - jf
        j = _to_int(jf)
        in_b = ((j >= -win) & (j < hi)).all(-1)
        t = torch.minimum((j + pad).clamp(min=0), top)
        diff = _bilinear(_gather_block(J, seq, t[:, 1], t[:, 0], w1),
                         ab[:, 0], ab[:, 1], win) - templ
        b1 = (diff * gx).sum((1, 2))
        b2 = (diff * gy).sum((1, 2))
        d = torch.stack([(A12 * b2 - A22 * b1) * inv_D,
                         (A12 * b1 - A11 * b2) * inv_D], dim=1)
        nn = xy + d
        d2 = d * d
        converged = d2[:, 0] + d2[:, 1] <= eps2
        flip = (ji > 0) & (torch.abs(d + pd) < 0.01).all(-1)
        nn = torch.where(flip[:, None], nn - d * 0.5, nn)
        stop = converged | flip | ~in_b
        live = active
        if finest:
            ok0 = ok0 & (in_b | ~live)
        move = in_b & live
        xy = torch.where(move[:, None], nn, xy)
        pd = torch.where(live[:, None], d, pd)
        ji = torch.where(live, ji + 1, ji)
        active = live & ~stop & (ji < params.max_iters)
    return xy, ok0, ji


def lk_quad_plain(planes, shapes, pad: int, pts: torch.Tensor,
                  valid: torch.Tensor, flow: torch.Tensor, disp: torch.Tensor,
                  params: LKParams, start_level):
    """The circular quad L0 -> R0 -> R1 -> L1 -> L0 of every feature of B
    sequences: planes[image][level] (B, Hp, Wp) for images (L0, R0, R1,
    L1), pts / flow / disp (B, n, 2), valid (B, n). ``start_level`` is an
    int or, per slot, a pair ((n,) int64 tensor, its largest value): a
    slot joins the coarse-to-fine refinement at its own level, with the
    arithmetic it would have alone.

    Returns (out (4, B, n, 2) per-leg positions, status (B, n) bool, iters
    (B, 4, L + 1, n) int32 updates per leg and level, L the highest start
    level, from level L down; a slot has none above its start level)."""
    B, n = valid.shape
    win = params.window
    half = (win - 1) * 0.5
    if isinstance(start_level, int):
        SL, slf = start_level, None
    else:
        slf, SL = start_level
        slf = slf.repeat(B)
    rows0, cols0 = shapes[0]
    seq = torch.arange(B, device=pts.device).repeat_interleave(n)
    c, flow, disp = (x.reshape(B * n, 2) for x in (pts, flow, disp))
    vf = valid.reshape(B * n)
    keep = vf[:, None]
    seeds = {"flow": flow, "disp": disp}
    center = _pair(cols0 * 0.5, rows0 * 0.5, c)
    scale0 = (2.0 ** SL if slf is None else
              torch.pow(2.0, slf.to(torch.float32))[:, None])
    status = vf.clone()
    outs, iters = [], []
    for leg, (src, sgn) in enumerate(QUAD_SEEDS):
        I_planes, J_planes = planes[leg], planes[(leg + 1) % 4]
        safe = torch.where(keep, c, center)
        nxt = (safe + sgn * seeds[src]) / scale0
        ok_leg = None
        leg_iters = []
        for level in range(SL, -1, -1):
            rows, cols = shapes[level]
            scale = 2.0 ** level
            if slf is not None:
                nxt = torch.where((slf > level)[:, None], nxt * 2.0, nxt)
            elif level != SL:
                nxt = nxt * 2.0
            init = nxt - half
            setup = _template(I_planes[level], seq, rows, cols, pad,
                              safe / scale - half, params)
            level_ok = setup[7] & vf
            if slf is not None:
                level_ok = level_ok & (slf >= level)
            setup = setup[:7] + (level_ok,)
            r, ok0, ji = _solve(J_planes[level], seq, rows, cols, pad, setup,
                                init, level == 0, params)
            moved = torch.where(level_ok[:, None], r, init) + half
            nxt = (moved if slf is None else
                   torch.where((slf >= level)[:, None], moved, nxt))
            leg_iters.append(ji.reshape(B, n))
            if level == 0:
                ok_leg = level_ok & ok0
        c = torch.where(keep, nxt, c)
        status = status & ok_leg
        outs.append(c.reshape(B, n, 2))
        iters.append(torch.stack(leg_iters, dim=1))
    return (torch.stack(outs), status.reshape(B, n),
            torch.stack(iters, dim=1))


def lk_circular_quad(img_l0: LKImage, img_r0: LKImage, img_r1: LKImage,
                     img_l1: LKImage, pts: torch.Tensor, valid: torch.Tensor,
                     params: LKParams, flow: torch.Tensor,
                     disp: torch.Tensor, start_level, recorder=None):
    """The whole circular quad of ``lk_quad_plain`` on (B, n) features.
    Returns (pts_r0, pts_r1, pts_l1, pts_l0_return, status); invalid slots
    pass ``pts`` through."""
    images = (img_l0, img_r0, img_r1, img_l1)
    planes = [im.pyramid for im in images]
    out, status, iters = lk_quad_plain(planes, img_l0.shapes, img_l0.pad,
                                       pts, valid, flow, disp, params,
                                       start_level)
    if recorder is not None:
        recorder(images, pts, valid, out, iters, start_level)
    return out[0], out[1], out[2], out[3], status
