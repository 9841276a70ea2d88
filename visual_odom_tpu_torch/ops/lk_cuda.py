"""The circular LK quad: a CUDA kernel for Hopper and its plain PyTorch twin.

Counterpart of ``visual_odom_tpu/ops/lk_pallas.py``. The JAX package runs
the quad L0 -> R0 -> R1 -> L1 -> L0 (reference src/feature.cpp:136-139) as
two launches of the Pallas TPU kernel ``_legs_kernel``, each a chain of two
legs. Here the four legs are one chain in one launch of ``lk_quad_kernel``
(``csrc/lk_legs.cu``): a feature's legs run one after another inside its
warp, chain B starting where chain A ended, which is exactly
``where(valid, r1, pts)`` for every slot the kernel computes.

Per feature, each leg is seeded at chain + sign * (disp | flow) (legs 1-4:
+disp, +flow, -disp, -flow), divided by 2**start_level, and refined
coarse-to-fine from ``start_level`` down to 0. Each level derives Scharr
gradients from a 24x24 superblock of I, takes fp32 bilinear template and
gradient patches at floor(prevPt), gates on the min eigenvalue and the
determinant of G, and runs up to ``max_iters`` damped updates. A leg's
status fails only at level 0. Invalid slots pass their input through with
status False.

Routing: ``lk_circular_quad`` launches the kernel for CUDA tensors and uses
``lk_quad_plain`` (vectorised over features, a bounded masked loop) only for
CPU tensors; there is no fallback from one to the other. The kernel's
source note says what bounds it on the H100 and what the design does about
it. ``lk_circular_quad.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from visual_odom_tpu_torch.ops.lk import LKImage, LKParams

# Scharr taps (3,10,3)/16 x (-1,0,1)/2, as the JAX package's pyramid module.
_SM0, _SM1, _SM2 = 3.0 / 16.0, 10.0 / 16.0, 3.0 / 16.0
_DF0, _DF2 = -0.5, 0.5
_D_EPS = 1.19209e-07 * (1024.0 ** 2)
_KERNEL_WINDOW = 21
_KERNEL_MAX_LEVELS = 4

#: (seed source, sign) per leg of the quad; leg k tracks image k -> k+1 of
#: (L0, R0, R1, L1) cyclically.
QUAD_SEEDS = (("disp", 1.0), ("flow", 1.0), ("disp", -1.0), ("flow", -1.0))


# ---------------------------------------------------------------------------
# Plain PyTorch version
# ---------------------------------------------------------------------------


def _to_int(f: torch.Tensor) -> torch.Tensor:
    """floor()ed float -> int64, clamped so runaway estimates stay far out
    of bounds instead of wrapping (the kernel clamps the same way)."""
    return f.clamp(-1.0e9, 1.0e9).to(torch.int64)


def _gather_block(plane: torch.Tensor, y0: torch.Tensor, x0: torch.Tensor,
                  size: int) -> torch.Tensor:
    """(n, size, size) windows of ``plane`` with top-left corners (y0, x0)."""
    r = torch.arange(size, device=plane.device)
    rows = (y0[:, None] + r)[:, :, None]
    cols = (x0[:, None] + r)[:, None, :]
    return plane[rows, cols]


def _bilinear(wnd: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
              win: int) -> torch.Tensor:
    """(n, win+1, win+1) windows -> (n, win, win) patches, OpenCV weights."""
    a = a[:, None, None]
    b = b[:, None, None]
    w00 = (1.0 - a) * (1.0 - b)
    w01 = a * (1.0 - b)
    w10 = (1.0 - a) * b
    w11 = a * b
    w1 = win + 1
    return (w00 * wnd[:, :win, :win] + w01 * wnd[:, :win, 1:w1]
            + w10 * wnd[:, 1:w1, :win] + w11 * wnd[:, 1:w1, 1:w1])


def _template(plane, rows, cols, pad, px, py, params: LKParams):
    """Per-feature template setup at one level: superblock gather, in-block
    Scharr, bilinear patches and the spectral gate."""
    win = params.window
    w1 = win + 1
    Hp, Wp = rows + 2 * pad, cols + 2 * pad
    fx = torch.floor(px)
    fy = torch.floor(py)
    a = px - fx
    b = py - fy
    ix = _to_int(fx)
    iy = _to_int(fy)
    templ_ok = (ix >= -win) & (ix < cols) & (iy >= -win) & (iy < rows)
    sy = (iy + pad).clamp(1, Hp - w1 - 1)
    sx = (ix + pad).clamp(1, Wp - w1 - 1)
    blk = _gather_block(plane, sy - 1, sx - 1, w1 + 2)
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


def _solve(J, rows, cols, pad, setup, x, y, finest: bool, params: LKParams):
    """Bounded masked iteration loop of one level. Returns the refined
    (x, y), the level-0 bounds status and each feature's update count."""
    templ, gx, gy, A11, A12, A22, inv_D, level_ok = setup
    win = params.window
    w1 = win + 1
    Hp, Wp = rows + 2 * pad, cols + 2 * pad
    eps2 = params.eps * params.eps
    pdx = torch.zeros_like(x)
    pdy = torch.zeros_like(y)
    ji = torch.zeros(x.shape, dtype=torch.int32, device=x.device)
    ok0 = torch.ones_like(level_ok)
    active = level_ok.clone()
    for _ in range(max(params.max_iters, 1)):
        if not bool(active.any()):
            break
        jfx = torch.floor(x)
        jfy = torch.floor(y)
        aa = x - jfx
        bb = y - jfy
        jx = _to_int(jfx)
        jy = _to_int(jfy)
        in_b = (jx >= -win) & (jx < cols) & (jy >= -win) & (jy < rows)
        ty = (jy + pad).clamp(0, Hp - w1)
        tx = (jx + pad).clamp(0, Wp - w1)
        diff = _bilinear(_gather_block(J, ty, tx, w1), aa, bb, win) - templ
        b1 = (diff * gx).sum((1, 2))
        b2 = (diff * gy).sum((1, 2))
        dx = (A12 * b2 - A22 * b1) * inv_D
        dy = (A12 * b1 - A11 * b2) * inv_D
        nnx = x + dx
        nny = y + dy
        converged = dx * dx + dy * dy <= eps2
        flip = (ji > 0) & (torch.abs(dx + pdx) < 0.01) & (torch.abs(dy + pdy) < 0.01)
        nnx = torch.where(flip, nnx - dx * 0.5, nnx)
        nny = torch.where(flip, nny - dy * 0.5, nny)
        stop = converged | flip | ~in_b
        live = active
        if finest:
            ok0 = ok0 & (in_b | ~live)
        move = in_b & live
        x = torch.where(move, nnx, x)
        y = torch.where(move, nny, y)
        pdx = torch.where(live, dx, pdx)
        pdy = torch.where(live, dy, pdy)
        ji = torch.where(live, ji + 1, ji)
        active = live & ~stop & (ji < params.max_iters)
    return x, y, ok0, ji


def lk_quad_plain(planes, shapes, pad: int, pts: torch.Tensor,
                  valid: torch.Tensor, flow: torch.Tensor, disp: torch.Tensor,
                  params: LKParams, start_level: int):
    """Plain PyTorch version of the kernel: the same chain function,
    vectorised over features.

    planes: planes[image][level] for images (L0, R0, R1, L1).
    Returns (out (4, n, 2) per-leg positions, status (n,) bool,
    iters (4, start_level + 1, n) int32 updates per leg and level, counted
    only for the kernel's work estimate).
    """
    win = params.window
    half = (win - 1) * 0.5
    SL = start_level
    rows0, cols0 = shapes[0]
    seeds = {"disp": disp, "flow": flow}
    cx = pts[:, 0]
    cy = pts[:, 1]
    status = valid.clone()
    outs, iters = [], []
    for leg, (src, sgn) in enumerate(QUAD_SEEDS):
        I_planes, J_planes = planes[leg], planes[(leg + 1) % 4]
        safe_x = torch.where(valid, cx, torch.full_like(cx, cols0 * 0.5))
        safe_y = torch.where(valid, cy, torch.full_like(cy, rows0 * 0.5))
        seed = seeds[src]
        nx = (safe_x + sgn * seed[:, 0]) / (2.0 ** SL)
        ny = (safe_y + sgn * seed[:, 1]) / (2.0 ** SL)
        ok_leg = None
        leg_iters = []
        for level in range(SL, -1, -1):
            rows, cols = shapes[level]
            scale = 2.0 ** level
            if level != SL:
                nx = nx * 2.0
                ny = ny * 2.0
            initx = nx - half
            inity = ny - half
            setup = _template(I_planes[level], rows, cols, pad,
                              safe_x / scale - half, safe_y / scale - half,
                              params)
            level_ok = setup[7] & valid
            setup = setup[:7] + (level_ok,)
            rx, ry, ok0, ji = _solve(J_planes[level], rows, cols, pad, setup,
                                     initx, inity, level == 0, params)
            nx = torch.where(level_ok, rx, initx) + half
            ny = torch.where(level_ok, ry, inity) + half
            leg_iters.append(ji)
            if level == 0:
                ok_leg = level_ok & ok0
        cx = torch.where(valid, nx, cx)
        cy = torch.where(valid, ny, cy)
        status = status & ok_leg
        outs.append(torch.stack([cx, cy], dim=1))
        iters.append(torch.stack(leg_iters))
    return torch.stack(outs), status, torch.stack(iters)


# ---------------------------------------------------------------------------
# CUDA kernel wrapper
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _library():
    """``lk_quad_launch`` with its C signature, built and loaded once."""
    from visual_odom_tpu_torch.ops import _nvcc

    lib = _nvcc.load("lk_legs")
    fn = lib.lk_quad_launch
    fn.argtypes = ([ctypes.c_void_p] * 8
                   + [ctypes.c_int] * 4 + [ctypes.c_float] * 2
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check(t: torch.Tensor, name: str, dtype, shape, device):
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) or t.device != device:
        raise ValueError(f"{name}: expected {dtype} {tuple(shape)} on {device}, "
                         f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def lk_quad_cuda(planes, shapes, pad: int, pts: torch.Tensor,
                 valid: torch.Tensor, flow: torch.Tensor, disp: torch.Tensor,
                 params: LKParams, start_level: int):
    """Launch ``lk_quad_kernel`` on the current stream. Same contract as
    ``lk_quad_plain`` minus the iteration counts. Raises if the kernel does
    not take the inputs or the launch fails."""
    dev = pts.device
    n = pts.shape[0]
    if params.window != _KERNEL_WINDOW:
        raise ValueError(f"the CUDA LK kernel is built for window "
                         f"{_KERNEL_WINDOW}, got {params.window}")
    if not 0 <= start_level < _KERNEL_MAX_LEVELS or n == 0:
        raise ValueError(f"unsupported start_level {start_level} / n {n}")
    _check(pts, "pts", torch.float32, (n, 2), dev)
    _check(flow, "flow", torch.float32, (n, 2), dev)
    _check(disp, "disp", torch.float32, (n, 2), dev)
    valid_i = valid.to(torch.int32).contiguous()
    _check(valid_i, "valid", torch.int32, (n,), dev)
    ptrs, dims = [], []
    for im in range(4):
        for lv in range(start_level + 1):
            p = planes[im][lv]
            if p.dtype != torch.float32 or p.device != dev or not p.is_contiguous():
                raise ValueError(f"plane [{im}][{lv}] must be contiguous "
                                 f"float32 on {dev}")
            if p.shape != planes[0][lv].shape:
                raise ValueError("quad images must share plane shapes")
            rows, cols = shapes[lv]
            if p.shape[0] < rows + 2 * pad or p.shape[1] < cols + 2 * pad:
                raise ValueError(f"plane [{im}][{lv}] smaller than its padded "
                                 f"level {rows}x{cols} + 2*{pad}")
            ptrs.append(p.data_ptr())
    for lv in range(start_level + 1):
        dims += [shapes[lv][0], shapes[lv][1], planes[0][lv].shape[1]]
    out = torch.empty((4, n, 2), dtype=torch.float32, device=dev)
    status = torch.empty((n,), dtype=torch.int32, device=dev)
    ptr_arr = np.asarray(ptrs, dtype=np.int64)
    dim_arr = np.asarray(dims, dtype=np.int32)
    fn = _library()
    err = fn(ptr_arr.ctypes.data, dim_arr.ctypes.data, pts.data_ptr(),
             flow.data_ptr(), disp.data_ptr(), valid_i.data_ptr(),
             out.data_ptr(), status.data_ptr(), n, start_level, pad,
             params.max_iters, float(params.eps * params.eps),
             float(params.min_eig_threshold),
             torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"lk_quad_kernel launch failed: CUDA error {err}")
    lk_circular_quad.launches += 1
    return out, status > 0


def lk_circular_quad(img_l0: LKImage, img_r0: LKImage, img_r1: LKImage,
                     img_l1: LKImage, pts: torch.Tensor, valid: torch.Tensor,
                     params: LKParams = LKParams(), flow: torch.Tensor = None,
                     disp: torch.Tensor = None, start_level: int = None):
    """The whole circular quad, one kernel launch on CUDA.

    Returns (pts_r0, pts_r1, pts_l1, pts_l0_return, status), as
    ``lk_circular_quad_pallas``: status is the AND of the four legs'
    statuses and ``valid``; invalid slots pass ``pts`` through.
    """
    shapes = img_l0.shapes
    for im in (img_r0, img_r1, img_l1):
        if im.shapes != shapes or im.pad != img_l0.pad:
            raise ValueError("quad images must share dimensions")
    sl = params.levels if start_level is None else start_level
    if flow is None:
        flow = torch.zeros_like(pts)
    if disp is None:
        disp = torch.zeros_like(pts)
    planes = [im.pyramid for im in (img_l0, img_r0, img_r1, img_l1)]
    if pts.device.type == "cuda":
        out, status = lk_quad_cuda(planes, shapes, img_l0.pad, pts, valid,
                                   flow, disp, params, sl)
    elif pts.device.type == "cpu":
        out, status, _ = lk_quad_plain(planes, shapes, img_l0.pad, pts, valid,
                                       flow, disp, params, sl)
    else:
        raise ValueError(f"no LK implementation for device {pts.device}")
    return out[0], out[1], out[2], out[3], status


lk_circular_quad.launches = 0
