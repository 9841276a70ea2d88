"""Small fixed-size SPD solves, unrolled.

Port of ``visual_odom_tpu/core/linalg.py:solve_spd``: a pivot-free Cholesky
unrolled into elementwise arithmetic over the batch, for the damped 6x6
Gauss-Newton normal equations of PnP-RANSAC (500 hypotheses per frame).
Non-PD inputs give non-finite outputs, which callers mask.
"""

from __future__ import annotations

import torch


def solve_spd(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve A x = b for SPD A (..., n, n), b (..., n). Returns (..., n)."""
    n = A.shape[-1]
    eps = 1e-30

    def safe(d):
        return torch.where(torch.abs(d) < eps, torch.full_like(d, eps), d)

    L = [[None] * n for _ in range(n)]
    for j in range(n):
        s = A[..., j, j]
        for k in range(j):
            s = s - L[j][k] * L[j][k]
        Ljj = torch.sqrt(s)
        L[j][j] = Ljj
        inv = 1.0 / safe(Ljj)
        for i in range(j + 1, n):
            t = A[..., i, j]
            for k in range(j):
                t = t - L[i][k] * L[j][k]
            L[i][j] = t * inv

    y = [None] * n
    for i in range(n):
        t = b[..., i]
        for k in range(i):
            t = t - L[i][k] * y[k]
        y[i] = t / safe(L[i][i])

    x = [None] * n
    for i in range(n - 1, -1, -1):
        t = y[i]
        for k in range(i + 1, n):
            t = t - L[k][i] * x[k]
        x[i] = t / safe(L[i][i])
    return torch.stack(x, dim=-1)
