"""Image pyramid in the padded, aligned layout the LK kernel reads.

Port of ``visual_odom_tpu/ops/pyramid.py`` (the banded-matrix half). pyrDown
is linear, so one level step (crop the pad, 5-tap REFLECT_101 Gaussian,
even decimation, reflect re-pad, zero alignment tail) is one static band
matrix per axis: ``padded_{k+1} = Mv @ padded_k @ Mh^T``. The two products
stay ``torch.matmul``: the JAX package leaves them to XLA too, outside any
kernel. The buffer layout is kept exactly, so the JAX package's planes can
be handed to the port unchanged.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

_GAUSS5 = np.array([1.0, 4.0, 6.0, 4.0, 1.0], dtype=np.float32) / 16.0


def _reflect101_index(j: int, n: int) -> int:
    """Index folding for cv BORDER_REFLECT_101 (period 2n-2)."""
    if n == 1:
        return 0
    period = 2 * (n - 1)
    j = j % period
    return j if j < n else period - j


def _down_band_matrix(n_in: int) -> np.ndarray:
    """(ceil(n_in/2), n_in): one pyrDown axis — REFLECT_101 5-tap Gaussian
    blur + even decimation — as a band matrix."""
    n_out = -(-n_in // 2)
    M = np.zeros((n_out, n_in), np.float32)
    for i in range(n_out):
        for t in range(5):
            M[i, _reflect101_index(2 * i + t - 2, n_in)] += float(_GAUSS5[t])
    return M


def aligned_extent(n_logical: int, pad: int, axis: int) -> int:
    """The padded-buffer alignment rule shared with the JAX package: a
    (n_logical + 2*pad) reflect-padded axis is zero-extended, rows to a
    multiple of 8 with >= 10 rows of slack, columns to a multiple of 128
    with >= 234 columns of slack."""
    npad = n_logical + 2 * pad
    if axis == 0:
        return -(-(npad + 10) // 8) * 8
    return -(-(npad + 234) // 128) * 128


@functools.lru_cache(maxsize=None)
def _padded_down_matrix(n_in: int, pad: int, axis: int) -> np.ndarray:
    """(out_tot, in_tot) operator: aligned padded level-k axis -> aligned
    padded level-(k+1) axis. Composes crop, blur+decimate, reflect re-pad
    and the zero alignment tail."""
    n_out = -(-n_in // 2)
    in_tot = aligned_extent(n_in, pad, axis)
    out_tot = aligned_extent(n_out, pad, axis)
    D = _down_band_matrix(n_in)
    M = np.zeros((out_tot, in_tot), np.float32)
    for r in range(pad + n_out + pad):
        j = _reflect101_index(r - pad, n_out)
        M[r, pad: pad + n_in] = D[j]
    return M


@functools.lru_cache(maxsize=None)
def _down_matrices(n_rows: int, n_cols: int, pad: int,
                   device: torch.device) -> tuple:
    """(Mv, Mh^T) on ``device``, built once per level shape."""
    Mv = torch.from_numpy(_padded_down_matrix(n_rows, pad, 0)).to(device)
    MhT = torch.from_numpy(_padded_down_matrix(n_cols, pad, 1).T.copy())
    return Mv, MhT.to(device)


def padded_pyr_down(p: torch.Tensor, n_rows: int, n_cols: int,
                    pad: int) -> torch.Tensor:
    """One pyramid level step directly in the padded aligned layout.

    ``p``: (row_tot, col_tot) padded buffer for a (n_rows, n_cols) level.
    Returns the padded buffer for the (ceil(n_rows/2), ceil(n_cols/2))
    level.
    """
    Mv, MhT = _down_matrices(n_rows, n_cols, pad, p.device)
    return torch.matmul(torch.matmul(Mv, p), MhT)
