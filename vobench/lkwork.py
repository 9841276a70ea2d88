"""The LK quad's operations and bytes, and the card's published peaks.

Frozen copy of ``chip_smoke.py``'s work arithmetic at commit 245329126dfa
(``SETUP_FLOPS``, ``ITER_FLOPS``, ``BLOCK``, ``FEATURE_BYTES``,
``block_pixels``, ``plane_bytes`` and ``quad_check.work``) and of its peaks
(``PEAK_BYTES_S``, ``PEAK_FP32_FLOPS``), kept here so that the roofline is
read against the same work whatever implements the kernel. The work is
counted from a quad's inputs and the update counts the benchmark's
reference measured (``reference.step.QuadRecord``), not from the program.
"""

from __future__ import annotations

import numpy as np
import torch

#: NVIDIA H100 SXM data sheet: HBM bytes/s and float32 (non-tensor) FLOP/s,
#: both at the card's full 700 W power limit
PEAK_BYTES_S = 3.35e12
PEAK_FP32_FLOPS = 67e12

#: per-(feature, leg, level) template setup: separable Scharr (8 flops per
#: px of the 22x24 vertical pass and of the 22x22 horizontal pass), three
#: 21x21 bilinears (7 flops/px), G (6 flops/px), the gate
SETUP_FLOPS = 8 * 22 * 24 + 8 * 22 * 22 + 441 * (3 * 7 + 6) + 30
#: per update: 21x21 bilinear (7), diff (1), b1 and b2 (4), reductions, 2x2
ITER_FLOPS = 441 * 12 + 100
#: side of the template superblock (21x21 window + bilinear + Scharr support)
BLOCK = 24
#: per-feature inputs (pts, flow, disp, valid) and outputs (4 legs, status)
FEATURE_BYTES = (2 + 2 + 2 + 1) * 4 + (4 * 2 + 1) * 4


def block_pixels(hp, wp, pad, corners, valid, win):
    """Distinct plane pixels of the BLOCK x BLOCK template superblocks at
    the window corners ``corners`` (m, 2) of the ``valid`` (m,) features of
    one level, placed as the kernel places them: a 0-dim tensor, counted
    without a host read (the copy indexed by the mask, one read a call)."""
    ix = torch.floor(corners).clamp(-1e9, 1e9).long() + pad
    x0 = ix[:, 0].clamp(1, wp - win - 2) - 1
    y0 = ix[:, 1].clamp(1, hp - win - 2) - 1
    r = torch.arange(BLOCK, device=corners.device)
    lin = (y0[:, None] + r)[:, :, None] * wp + (x0[:, None] + r)[:, None, :]
    hits = torch.zeros(hp * wp, dtype=torch.int32, device=corners.device)
    hits.index_add_(0, lin.reshape(-1),
                    valid.to(torch.int32).repeat_interleave(BLOCK * BLOCK))
    return (hits > 0).sum()


def plane_bytes(shapes, pad, out, pts, valid, sl, win):
    """Bytes of the pyramid planes one sequence's quad must read, each
    pixel once: the union over valid features of the template superblocks,
    per (image, level). Leg k's template in image k sits where leg k-1
    ended (leg 1's at ``pts``); its J window in image k+1 lies inside the
    next leg's superblock to within sub-pixel corrections, so it is not
    counted again: a lower bound."""
    half = (win - 1) * 0.5
    total = 0
    for k, chain in enumerate([pts] + [out[j] for j in range(3)]):
        for lv in range(sl + 1):
            rows, cols = shapes[lv]
            total = total + block_pixels(rows + 2 * pad, cols + 2 * pad, pad,
                                         chain / 2.0 ** lv - half, valid, win)
    return total * 4


def quad_work(rec, win: int) -> tuple:
    """(flops, bytes) of one batched quad launch (``QuadRecord``), summed
    over its sequences, as 0-dim tensors (read them together: each read
    waits for the device)."""
    sl = rec.start_level
    setups = rec.valid.sum() * 4 * (sl + 1)
    flops = setups * SETUP_FLOPS + rec.iters.sum() * ITER_FLOPS
    nbytes = sum(plane_bytes(rec.shapes, rec.pad, rec.out[:, b], rec.pts[b],
                             rec.valid[b], sl, win)
                 + rec.pts.shape[-2] * FEATURE_BYTES
                 for b in range(rec.pts.shape[0]))
    return flops, nbytes


def bound_seconds(flops, nbytes):
    """The least time the card could take: the larger of the two bounds
    (numbers or tensors of them)."""
    return np.maximum(np.asarray(flops, np.float64) / PEAK_FP32_FLOPS,
                      np.asarray(nbytes, np.float64) / PEAK_BYTES_S)
