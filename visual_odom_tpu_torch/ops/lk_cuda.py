"""Pyramidal LK on CUDA: two kernels for Hopper and their plain PyTorch twins.

Counterpart of ``visual_odom_tpu/ops/lk_pallas.py``. Both kernels live in
``csrc/lk_legs.cu`` and run each (leg, level) with the same device
function, so the two routes below compute the same bits.

- ``lk_quad_kernel``, the port of ``_legs_kernel``: the JAX package runs
  the quad L0 -> R0 -> R1 -> L1 -> L0 (reference src/feature.cpp:136-139)
  as two launches of it, each a chain of two legs. Here the four legs are
  one chain in one launch: a feature's legs run one after another inside
  its warp, chain B starting where chain A ended, which is exactly
  ``where(valid, r1, pts)`` for every slot the kernel computes. Per
  feature, each leg is seeded at chain + sign * (disp | flow) (legs 1-4:
  +disp, +flow, -disp, -flow), divided by 2**start_level, and refined
  coarse-to-fine from ``start_level`` down to 0.
- ``lk_level_kernel``, the port of ``_level_kernel``: one pyramid level of
  one leg, given each feature's template corner ``prev`` and start
  estimate ``init`` in the level's coordinates. ``ops.lk.lk_track_pyramid``
  launches it once per level, as ``lk_track_pyramid_pallas`` launches
  ``_build_level_call``.

Each level derives Scharr gradients from a 24x24 superblock of I, takes
fp32 bilinear template and gradient patches at floor(prevPt), gates on the
min eigenvalue and the determinant of G, and runs up to ``max_iters``
damped updates. A leg's status fails only at level 0. Invalid slots pass
their input through with status False.

Routes (``VOConfig.lk_backend``, picked in ``frontend.matching``):
``"pallas"`` runs a circular match as one ``lk_circular_quad`` launch,
``"xla"`` as four chained ``lk_track_pyramid`` legs, ``start_level + 1``
level launches each. The JAX names are kept so that each route finds its
counterpart there.

Batched form: with a leading batch dim on every operand (planes
``(B, Hp, Wp)``, features ``(B, n, ...)``) one launch covers B sequences,
as ``_build_legs_call_batched`` does for the JAX package's vmapped step;
the unbatched call is its B = 1 case. The JAX rule also broadcasts
operands that carry no batch dim; the port's batched step batches every
operand, so the batched form here takes only fully batched inputs.

Instances: each kernel is built in four instances, which the wrappers'
``doublestep`` and ``packed`` flags pick per call (``variant``; ``None``
takes ``DEFAULT_DOUBLESTEP`` / ``DEFAULT_PACKED``, and nothing reads the
environment). ``doublestep``, the counterpart of the TPU kernel's
``VO_LK_DOUBLESTEP`` body, reads each update's J window from a superblock
staged in shared memory and equals ``doublestep=False`` bit for bit.
``packed``, the counterpart of ``VO_LK_PACKED``, runs four features a warp;
its sums reduce in another order. The plain versions compute the same
function for every instance.

Devices: each wrapper launches its kernel for CUDA tensors; the plain
versions (``lk_quad_plain``, ``lk_level_plain``, vectorised over features,
a bounded masked loop, and their ``_batched`` twins) run only for CPU
tensors; there is no fallback from one to the other. The kernels' source
note says what bounds them on the H100 and what the design does about it.
Each kernel's launches are counted on the public function that makes them:
``lk_circular_quad.launches`` and ``ops.lk.lk_track_pyramid.launches``
count unbatched launches, their ``batched_launches`` batched ones.

Slots over a mesh row's "model" axis (``split_slots``): both public
functions take ``slot_devices``, and LK is per feature, so each position
tracks a contiguous slice of the slots and the slices are put back in
order: bit for bit the unsplit call. One process launches every slice,
each on its device; a rank of a mesh of ranks launches its own slice and
all-gathers the rest over the row's group.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from visual_odom_tpu_torch.ops.lk import LKImage, LKParams, lk_track_pyramid

# Scharr taps (3,10,3)/16 x (-1,0,1)/2, as the JAX package's pyramid module.
_SM0, _SM1, _SM2 = 3.0 / 16.0, 10.0 / 16.0, 3.0 / 16.0
_DF0, _DF2 = -0.5, 0.5
_D_EPS = 1.19209e-07 * (1024.0 ** 2)
_KERNEL_WINDOW = 21
_KERNEL_MAX_LEVELS = 4
#: J superblock of the window-reuse instances (``JB_ROWS``, ``JB_COLS`` in
#: csrc/lk_legs.cu): a plane must be at least this large
_SUPERBLOCK = (32, 36)

#: The instance both kernels run when a caller names none (the main path
#: never does, so its two routes run the same instance). Chosen by
#: chip_smoke.py's device times on an NVIDIA H100 80GB HBM3 at 700 W, ms per
#: launch with doublestep / without (LANES 32): fast quad at 384 slots
#: 0.1071 / 0.1046, at B = 4 0.1570 / 0.1584, at B = 11 0.3011 / 0.3320;
#: level launch, fast leg level 0, 0.0254 / 0.0272. Packed, with doublestep:
#: 0.4109, 0.5300, 0.6937 and 0.0647.
DEFAULT_DOUBLESTEP = True
DEFAULT_PACKED = False

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


def lk_quad_plain_batched(planes, shapes, pad: int, pts: torch.Tensor,
                          valid: torch.Tensor, flow: torch.Tensor,
                          disp: torch.Tensor, params: LKParams,
                          start_level: int):
    """Plain version of the batched launch: ``lk_quad_plain`` on each
    sequence b of planes[image][level] (B, Hp, Wp) and features (B, n, ...).

    Returns (out (4, B, n, 2), status (B, n), iters (B, 4, start_level + 1,
    n)).
    """
    runs = [lk_quad_plain([[p[b] for p in im] for im in planes], shapes, pad,
                          pts[b], valid[b], flow[b], disp[b], params,
                          start_level)
            for b in range(pts.shape[0])]
    outs, status, iters = zip(*runs)
    return torch.stack(outs, dim=1), torch.stack(status), torch.stack(iters)


def lk_level_plain(I: torch.Tensor, J: torch.Tensor, rows: int, cols: int,
                   pad: int, prev: torch.Tensor, init: torch.Tensor,
                   valid: torch.Tensor, params: LKParams, finest: bool):
    """Plain PyTorch version of the level kernel: one level of one leg on
    the (aligned, padded) planes I and J.

    prev, init: (n, 2) template corners and start estimates in the level's
    coordinates. Returns (out (n, 2): the refined estimate, ``init`` where
    the level's gate fails; ok (n,) bool: the gate, ``valid`` and, at the
    finest level, the in-bounds status; iters (n,) int32 updates, counted
    only for the kernel's work estimate).
    """
    setup = _template(I, rows, cols, pad, prev[:, 0], prev[:, 1], params)
    level_ok = setup[7] & valid
    setup = setup[:7] + (level_ok,)
    x0, y0 = init[:, 0], init[:, 1]
    rx, ry, ok0, ji = _solve(J, rows, cols, pad, setup, x0, y0, finest, params)
    out = torch.stack([torch.where(level_ok, rx, x0),
                       torch.where(level_ok, ry, y0)], dim=1)
    return out, level_ok & ok0, ji


def lk_level_plain_batched(I, J, rows: int, cols: int, pad: int,
                           prev: torch.Tensor, init: torch.Tensor,
                           valid: torch.Tensor, params: LKParams,
                           finest: bool):
    """Plain version of the batched level launch: ``lk_level_plain`` on
    each sequence b of planes (B, Hp, Wp) and features (B, n, ...)."""
    runs = [lk_level_plain(I[b], J[b], rows, cols, pad, prev[b], init[b],
                           valid[b], params, finest)
            for b in range(prev.shape[0])]
    return tuple(torch.stack(x) for x in zip(*runs))


# ---------------------------------------------------------------------------
# CUDA kernel wrappers
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _library():
    """The kernels' library, built and loaded once, with the C signatures
    of ``lk_quad_launch``, ``lk_level_launch`` and ``lk_kernel_info``."""
    from visual_odom_tpu_torch.ops import _nvcc

    lib = _nvcc.load("lk_legs")
    lib.lk_quad_launch.argtypes = ([ctypes.c_void_p] * 8
                                   + [ctypes.c_int] * 5 + [ctypes.c_float] * 2
                                   + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    lib.lk_level_launch.argtypes = ([ctypes.c_void_p] * 7
                                    + [ctypes.c_int] * 9
                                    + [ctypes.c_float] * 2
                                    + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    lib.lk_kernel_info.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    for fn in (lib.lk_quad_launch, lib.lk_level_launch, lib.lk_kernel_info):
        fn.restype = ctypes.c_int
    return lib


def _cuda_device(t: torch.Tensor, name: str) -> torch.device:
    if t.device.type != "cuda":
        raise ValueError(f"{name}: the CUDA LK kernels take CUDA tensors, got "
                         f"one on {t.device}")
    return t.device


def _check_params(params: LKParams):
    if params.window != _KERNEL_WINDOW:
        raise ValueError(f"the CUDA LK kernel is built for window "
                         f"{_KERNEL_WINDOW}, got {params.window}")


def _check(t: torch.Tensor, name: str, dtype, shape, device):
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) or t.device != device:
        raise ValueError(f"{name}: expected {dtype} {tuple(shape)} on {device}, "
                         f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def variant(doublestep=None, packed=None) -> tuple:
    """The kernel instance (doublestep, packed) a wrapper launches: ``None``
    takes ``DEFAULT_DOUBLESTEP`` / ``DEFAULT_PACKED``. The kernels are built
    for the four combinations of two bools and for nothing else."""
    flags = (DEFAULT_DOUBLESTEP if doublestep is None else doublestep,
             DEFAULT_PACKED if packed is None else packed)
    for name, flag in zip(("doublestep", "packed"), flags):
        if not isinstance(flag, bool):
            raise ValueError(f"{name}: the LK kernels are built for True or "
                             f"False, got {flag!r}")
    return flags


def _check_superblock(plane: torch.Tensor, name: str):
    """A plane the window-reuse instances stage from: 16-byte aligned rows
    (cp.async copies 16 bytes) and room for one superblock."""
    rows, stride = plane.shape[-2:]
    if (plane.data_ptr() % 16 or stride % 4 or rows < _SUPERBLOCK[0]
            or stride < _SUPERBLOCK[1]):
        raise ValueError(f"{name}: the doublestep instances need 16-byte "
                         f"aligned planes with a row stride of a multiple of "
                         f"4 and at least {_SUPERBLOCK[0]}x{_SUPERBLOCK[1]}, "
                         f"got {rows}x{stride}")


def kernel_info(level: bool, doublestep: bool, packed: bool) -> dict:
    """Resources of one built instance on the current device, as the CUDA
    runtime reports them: registers a thread, static shared bytes a block,
    local (spill) bytes a thread, threads and features a block, and the
    blocks an SM holds at once."""
    info = np.zeros(6, dtype=np.int32)
    err = _library().lk_kernel_info(int(level), int(doublestep), int(packed),
                                    info.ctypes.data)
    if err != 0:
        raise RuntimeError(f"lk_kernel_info failed: CUDA error {err}")
    keys = ("registers", "shared_bytes", "local_bytes", "threads",
            "features_per_block", "blocks_per_sm")
    return dict(zip(keys, (int(v) for v in info)))


def lk_quad_cuda(planes, shapes, pad: int, pts: torch.Tensor,
                 valid: torch.Tensor, flow: torch.Tensor, disp: torch.Tensor,
                 params: LKParams, start_level: int, *, doublestep=None,
                 packed=None):
    """Launch ``lk_quad_kernel`` on the current stream. Same contract as
    ``lk_quad_plain`` minus the iteration counts, or, given a leading batch
    dim on every operand, as ``lk_quad_plain_batched``: one launch for all
    B sequences. ``doublestep`` / ``packed`` pick the instance (``variant``).
    Raises if the kernel does not take the inputs or the launch fails."""
    doublestep, packed = variant(doublestep, packed)
    dev = _cuda_device(pts, "pts")
    lead = tuple(pts.shape[:-2])
    if len(lead) > 1:
        raise ValueError(f"pts: expected (n, 2) or (B, n, 2), got "
                         f"{tuple(pts.shape)}")
    batch = lead[0] if lead else 1
    n = pts.shape[-2]
    _check_params(params)
    if not 0 <= start_level < _KERNEL_MAX_LEVELS or n == 0 or batch == 0:
        raise ValueError(f"unsupported start_level {start_level} / n {n} / "
                         f"batch {batch}")
    _check(pts, "pts", torch.float32, lead + (n, 2), dev)
    _check(flow, "flow", torch.float32, lead + (n, 2), dev)
    _check(disp, "disp", torch.float32, lead + (n, 2), dev)
    valid_i = valid.to(torch.int32).contiguous()
    _check(valid_i, "valid", torch.int32, lead + (n,), dev)
    ptrs, dims = [], []
    for im in range(4):
        for lv in range(start_level + 1):
            p = planes[im][lv]
            if p.dtype != torch.float32 or p.device != dev or not p.is_contiguous():
                raise ValueError(f"plane [{im}][{lv}] must be contiguous "
                                 f"float32 on {dev}")
            if p.shape != planes[0][lv].shape or tuple(p.shape[:-2]) != lead:
                raise ValueError(f"quad images must share plane shapes with "
                                 f"the features' batch {lead}")
            rows, cols = shapes[lv]
            if p.shape[-2] < rows + 2 * pad or p.shape[-1] < cols + 2 * pad:
                raise ValueError(f"plane [{im}][{lv}] smaller than its padded "
                                 f"level {rows}x{cols} + 2*{pad}")
            if doublestep:
                _check_superblock(p, f"plane [{im}][{lv}]")
            ptrs.append(p.data_ptr())
    for lv in range(start_level + 1):
        plane_rows, stride = planes[0][lv].shape[-2:]
        dims += [shapes[lv][0], shapes[lv][1], stride, plane_rows]
    out = torch.empty((4,) + lead + (n, 2), dtype=torch.float32, device=dev)
    status = torch.empty(lead + (n,), dtype=torch.int32, device=dev)
    ptr_arr = np.asarray(ptrs, dtype=np.int64)
    dim_arr = np.asarray(dims, dtype=np.int32)
    # The runtime launches on the current device: make it the operands'
    # (a mesh row's slices lie on other cards than the process's first).
    with torch.cuda.device(dev):
        err = _library().lk_quad_launch(
            ptr_arr.ctypes.data, dim_arr.ctypes.data, pts.data_ptr(),
            flow.data_ptr(), disp.data_ptr(), valid_i.data_ptr(),
            out.data_ptr(), status.data_ptr(), n, batch, start_level, pad,
            params.max_iters, float(params.eps * params.eps),
            float(params.min_eig_threshold), int(doublestep), int(packed),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"lk_quad_kernel launch failed: CUDA error {err}")
    if lead:
        lk_circular_quad.batched_launches += 1
    else:
        lk_circular_quad.launches += 1
    return out, status > 0


def lk_level_cuda(I: torch.Tensor, J: torch.Tensor, rows: int, cols: int,
                  pad: int, prev: torch.Tensor, init: torch.Tensor,
                  valid: torch.Tensor, params: LKParams, finest: bool, *,
                  doublestep=None, packed=None):
    """Launch ``lk_level_kernel`` on the current stream. Same contract as
    ``lk_level_plain`` minus the iteration counts, or, given a leading
    batch dim on the planes and the features, as ``lk_level_plain_batched``:
    one launch for all B sequences. ``doublestep`` / ``packed`` pick the
    instance (``variant``). Raises if the kernel does not take the inputs
    or the launch fails."""
    doublestep, packed = variant(doublestep, packed)
    dev = _cuda_device(prev, "prev")
    lead = tuple(prev.shape[:-2])
    if len(lead) > 1:
        raise ValueError(f"prev: expected (n, 2) or (B, n, 2), got "
                         f"{tuple(prev.shape)}")
    batch = lead[0] if lead else 1
    n = prev.shape[-2]
    _check_params(params)
    if n == 0 or batch == 0:
        raise ValueError(f"unsupported n {n} / batch {batch}")
    _check(prev, "prev", torch.float32, lead + (n, 2), dev)
    _check(init, "init", torch.float32, lead + (n, 2), dev)
    valid_i = valid.to(torch.int32).contiguous()
    _check(valid_i, "valid", torch.int32, lead + (n,), dev)
    _check(J, "J", torch.float32, I.shape, dev)
    _check(I, "I", torch.float32, lead + tuple(I.shape[-2:]), dev)
    plane_rows, stride = I.shape[-2:]
    if plane_rows < rows + 2 * pad or stride < cols + 2 * pad:
        raise ValueError(f"planes {tuple(I.shape[-2:])} smaller than their "
                         f"padded level {rows}x{cols} + 2*{pad}")
    if doublestep:
        _check_superblock(I, "I")
        _check_superblock(J, "J")
    out = torch.empty(lead + (n, 2), dtype=torch.float32, device=dev)
    ok = torch.empty(lead + (n,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):    # launch on the operands' device
        err = _library().lk_level_launch(
            I.data_ptr(), J.data_ptr(), prev.data_ptr(), init.data_ptr(),
            valid_i.data_ptr(), out.data_ptr(), ok.data_ptr(), rows, cols,
            stride, plane_rows, pad, n, batch, int(finest), params.max_iters,
            float(params.eps * params.eps), float(params.min_eig_threshold),
            int(doublestep), int(packed),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"lk_level_kernel launch failed: CUDA error {err}")
    if lead:
        lk_track_pyramid.batched_launches += 1
    else:
        lk_track_pyramid.launches += 1
    return out, ok > 0


def lk_circular_quad(img_l0: LKImage, img_r0: LKImage, img_r1: LKImage,
                     img_l1: LKImage, pts: torch.Tensor, valid: torch.Tensor,
                     params: LKParams = LKParams(), flow: torch.Tensor = None,
                     disp: torch.Tensor = None, start_level: int = None,
                     slot_devices=None):
    """The whole circular quad, one kernel launch on CUDA.

    Returns (pts_r0, pts_r1, pts_l1, pts_l0_return, status), as
    ``lk_circular_quad_pallas``: status is the AND of the four legs'
    statuses and ``valid``; invalid slots pass ``pts`` through. With a
    leading batch dim on the images' planes and on ``pts`` / ``valid`` /
    ``flow`` / ``disp`` it is ``vmap(lk_circular_quad_pallas)``: B
    sequences in one launch.

    ``slot_devices`` (a mesh row's "model" positions: devices, the first
    where the operands lie, or a ``parallel.collectives.RankAxis``) splits
    the slots over them (``split_slots``): bit for bit the unsplit quad.
    """
    if wants_split(slot_devices):
        if flow is None:
            flow = torch.zeros_like(pts)
        if disp is None:
            disp = torch.zeros_like(pts)
        return split_slots(
            lambda ims, p, v, f, d: lk_circular_quad(
                *ims, p, v, params, flow=f, disp=d, start_level=start_level),
            (img_l0, img_r0, img_r1, img_l1), (pts, valid, flow, disp), 4,
            slot_devices)
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
        from visual_odom_tpu_torch.utils.cudagraph import kernel

        plain = lk_quad_plain_batched if pts.dim() == 3 else lk_quad_plain
        out, status, _ = kernel(plain, planes, shapes, img_l0.pad, pts, valid,
                                flow, disp, params, sl)
    else:
        raise ValueError(f"no LK implementation for device {pts.device}")
    return out[0], out[1], out[2], out[3], status


def wants_split(slot_devices) -> bool:
    """Whether ``slot_devices`` asks for a split: a ``RankAxis`` (even of
    one rank: its collectives still run), or more than one device."""
    from visual_odom_tpu_torch.parallel.collectives import RankAxis

    return (isinstance(slot_devices, RankAxis)
            or (slot_devices is not None and len(slot_devices) > 1))


def split_slots(track, images, per_slot, n_points, slot_devices):
    """``track(images, *per_slot)`` with the slots split contiguously over
    ``slot_devices`` (``parallel.mesh.split_ranges``). ``per_slot`` holds
    the first operand, points (..., n, 2), and others shaped like it or
    like its mask (..., n); ``track`` returns ``n_points`` point arrays
    and then a status (..., n). An empty slice launches nothing.

    - Devices (one process): each slice is tracked on its device, the
      images copied there, and the results come back to the first
      operand's device in slot order. Copies are ordered by the devices'
      streams.
    - A ``RankAxis``: this rank tracks its slice on its own operands, and
      one all-gather per output over the axis' group puts the slices back
      in order on every rank."""
    from visual_odom_tpu_torch.parallel.collectives import (RankAxis,
                                                            axis_size, gather)
    from visual_odom_tpu_torch.parallel.mesh import split_ranges

    pts = per_slot[0]
    ranges = split_ranges(pts.shape[-2], axis_size(slot_devices))

    def cut(x, a, b):
        dim = -2 if x.dim() == pts.dim() else -1
        return x.narrow(dim, a, b - a).contiguous()

    if not isinstance(slot_devices, RankAxis):
        from visual_odom_tpu_torch.utils.cudagraph import moves

        devs = [torch.device(d) for d in slot_devices]
        home = devs[0]
        planes = [p for im in images for p in im.pyramid]
        slices = [(d, [cut(x, a, b) for x in per_slot])
                  for d, (a, b) in zip(devs, ranges) if b > a]
        # one group of copies out to the other positions, one back
        out = iter(moves([(x, d) for d, args in slices if d != home
                          for x in planes + args]))
        parts = []
        for d, args in slices:
            ims = images
            if d != home:
                ims = [im._replace(pyramid=tuple(next(out)
                                                 for _ in im.pyramid))
                       for im in images]
                args = [next(out) for _ in args]
            parts.append((d, track(ims, *args)))
        back = iter(moves([(y, home) for d, p in parts if d != home
                           for y in p]))
        parts = [p if d == home else [next(back) for _ in p]
                 for d, p in parts]
        return tuple(torch.cat([p[i] for p in parts],
                               dim=-2 if i < n_points else -1)
                     for i in range(n_points + 1))
    a, b = ranges[slot_devices.index]
    if b > a:
        out = track(images, *(cut(x, a, b) for x in per_slot))
    else:
        lead = pts.shape[:-2]
        out = tuple(pts.new_zeros(lead + (0, 2)) for _ in range(n_points)) + (
            torch.zeros(lead + (0,), dtype=torch.bool, device=pts.device),)
    sizes = [b - a for a, b in ranges]
    res = []
    for i, x in enumerate(out):
        d = -2 if i < n_points else -1
        got = gather([x.movedim(d, 0)], slot_devices, sizes=sizes)
        res.append(torch.cat(got).movedim(0, d))
    return tuple(res)


lk_circular_quad.launches = 0
lk_circular_quad.batched_launches = 0
