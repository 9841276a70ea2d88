"""Batched Nister 5-point minimal essential-matrix solver.

Frozen copy of ``visual_odom_tpu_torch/backend/five_point.py`` at commit 245329126dfa,
with its imports pointed at this package: the benchmark's yardstick, which
a change to the program must not move. The text below is the original's.

Port of ``visual_odom_tpu/backend/five_point.py`` (``_triple_assignment``,
``_polyval``, ``_conv``, ``_durand_kerner``, ``five_point_essential``),
written over leading hypothesis axes: RANSAC hands it every minimal sample
of a frame (and of every sequence of a batch) at once, never one at a time.
The algorithm is the JAX package's:

1. the 4-dim null space of the 5x9 epipolar system, E = x E1 + y E2 +
   z E3 + E4;
2. det(E) = 0 and 2 E E^T E - tr(E E^T) E = 0 as exact trilinear
   expansions in the basis, collected into 20 monomials by a fixed 0/1
   matrix;
3. Gauss-Jordan on the 10 leading monomials (one batched 10x10 solve with
   a step of iterative refinement), three equation pairs giving the 3x3
   polynomial matrix B(z), and det B(z) of degree 10;
4. Durand-Kerner roots in complex64 (80 iterations, 5 Newton steps), each
   near-real root giving (x, y) by least squares and a candidate E.

Two steps differ in how, not in what, so the step never waits for the
device: the null space comes from five Householder reflections of A^T (no
SVD, whose CUDA call reads its convergence flag back to the host; nor
A^T A, whose squared condition number the JAX docstring measured as lost
recoveries), computed in float64, and the 10x10 solve is ``solve_ex``. The null space is a
different orthonormal basis of the same space than LAPACK's SVD returns, so
the ten candidate slots come out in another order: compare candidate sets,
not slots.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

# Monomial exponent triples (x, y, z), degree <= 3. FIRST10 carries the
# leading monomials x^2 z, x^2, y^2 z, y^2, xyz, xy in rows 4..9 whose
# z-weighted differences are linear in (x, y).
_FIRST10 = ((3, 0, 0), (0, 3, 0), (2, 1, 0), (1, 2, 0), (2, 0, 1),
            (2, 0, 0), (0, 2, 1), (0, 2, 0), (1, 1, 1), (1, 1, 0))
_LAST10 = ((1, 0, 2), (1, 0, 1), (1, 0, 0), (0, 1, 2), (0, 1, 1),
           (0, 1, 0), (0, 0, 3), (0, 0, 2), (0, 0, 1), (0, 0, 0))
_MONOMIALS = _FIRST10 + _LAST10
_DK_ITERS = 80
_NEWTON_ITERS = 5


def _triple_assignment() -> np.ndarray:
    """(64, 20) 0/1 matrix: basis triple (i, j, k) in {x,y,z,1}^3 -> the
    monomial its trilinear term contributes to."""
    A = np.zeros((64, 20), np.float32)
    for i in range(4):
        for j in range(4):
            for k in range(4):
                ex = [0, 0, 0]
                for idx in (i, j, k):
                    if idx < 3:
                        ex[idx] += 1
                A[i * 16 + j * 4 + k, _MONOMIALS.index(tuple(ex))] = 1.0
    return A


_A64 = _triple_assignment()


@functools.lru_cache(maxsize=None)
def _conv_matrix(na: int, nb: int, device: torch.device) -> torch.Tensor:
    """(na, nb, na + nb - 1) 0/1: (i, j) -> coefficient i + j. Constants are
    copied to the device once: a copy inside the step would wait for it."""
    S = np.zeros((na, nb, na + nb - 1), np.float32)
    for i in range(na):
        for j in range(nb):
            S[i, j, i + j] = 1.0
    return torch.from_numpy(S).to(device)


@functools.lru_cache(maxsize=None)
def _a64(device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_A64).to(device)


def _polyval(c: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """Ascending coefficients ``c`` (..., d+1) at ``z`` (...) by Horner,
    one fused multiply-add a coefficient."""
    r = torch.zeros_like(z) + c[..., -1]
    for i in range(c.shape[-1] - 2, -1, -1):
        r = torch.addcmul(c[..., i], r, z)
    return r


def _conv(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Full convolution of ascending coefficient vectors over leading axes:
    (..., na) * (..., nb) -> (..., na + nb - 1)."""
    S = _conv_matrix(a.shape[-1], b.shape[-1], a.device)
    return torch.einsum("...i,...j,ijm->...m", a, b, S.to(a.dtype))


def _durand_kerner(coeffs: torch.Tensor, iters: int = _DK_ITERS) -> torch.Tensor:
    """All complex roots of degree-10 polynomials, ascending real
    coefficients (..., 11) -> (..., 10) complex64, by Weierstrass
    simultaneous iteration (a fixed number of steps, all polynomials at
    once), then Newton steps on the scaled polynomial."""
    n = coeffs.shape[-1] - 1
    dev = coeffs.device
    lead = coeffs[..., -1:]
    # A (near-)zero leading coefficient: the caller masks such candidates.
    safe_lead = torch.where(torch.abs(lead) < 1e-20, torch.ones_like(lead), lead)
    monic = coeffs / safe_lead
    # z = s w with s = max_k |c_k|^(1/(n-k)): the scaled monic polynomial has
    # |c'_k| <= 1 and its roots lie within |w| ~ 2, so Horner never
    # overflows complex64 at a near-degenerate hypothesis's huge radius.
    k = torch.arange(n, dtype=torch.float32, device=dev)
    mags = torch.abs(monic[..., :-1])
    s = torch.where(mags > 0, mags, torch.full_like(mags, 1e-30)) ** (1.0 / (n - k))
    s = torch.clamp(s.amax(dim=-1, keepdim=True), 1.0, 1e3)
    powers = torch.arange(n + 1, dtype=torch.float32, device=dev) - n
    scaled = (monic * s ** powers).to(torch.complex64)

    radius = torch.clamp(1.0 + torch.abs(scaled[..., :-1]).amax(dim=-1,
                                                                 keepdim=True),
                         max=10.0)
    angle = 2.0 * np.pi * k / n + 0.35
    w = radius * torch.complex(torch.cos(angle), torch.sin(angle))
    eye = torch.eye(n, dtype=torch.complex64, device=dev)

    for _ in range(iters):
        # w_i -= p(w_i) / prod_{j != i} (w_i - w_j)
        diff = w[..., :, None] - w[..., None, :] + eye
        denom = torch.prod(diff, dim=-1)
        denom = torch.where(torch.abs(denom) < 1e-30,
                            torch.full_like(denom, 1e-30), denom)
        w = w - _polyval(scaled[..., None, :], w) / denom

    # Newton polish: sharpens clustered roots to the f32 floor and removes
    # the imaginary residue of real roots (the caller's real-root test).
    dmonic = scaled[..., 1:] * torch.arange(1, n + 1, dtype=torch.float32,
                                            device=dev)
    for _ in range(_NEWTON_ITERS):
        d = _polyval(dmonic[..., None, :], w)
        d = torch.where(torch.abs(d) < 1e-20, torch.full_like(d, 1e-20), d)
        w = w - _polyval(scaled[..., None, :], w) / d
    return s.to(torch.complex64) * w


def _null_space_5x9(A: torch.Tensor) -> torch.Tensor:
    """(..., 4, 9) orthonormal rows spanning the null space of (..., 5, 9)
    ``A``: the last four columns of Q in A^T = QR, by five Householder
    reflections (a fixed sequence of elementwise ops and reductions)."""
    M = A.transpose(-1, -2)                                   # (..., 9, 5)
    rows = torch.arange(9, device=A.device)
    vs = []
    for k in range(5):
        x = torch.where(rows[:, None] >= k, M[..., :, k:k + 1],
                        torch.zeros_like(M[..., :, k:k + 1]))[..., 0]
        alpha = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
        sign = torch.where(x[..., k:k + 1] < 0, -1.0, 1.0)
        v = x + (rows == k) * (sign * alpha)
        vv = (v * v).sum(dim=-1, keepdim=True)
        beta = torch.where(vv > 0, 2.0 / torch.where(vv > 0, vv, 1.0), 0.0)
        vs.append((v, beta))
        # M <- (I - beta v v^T) M
        M = M - (beta * v)[..., :, None] * (v[..., :, None] * M).sum(dim=-2,
                                                                     keepdim=True)
    # Q[:, 5:] = H_0 H_1 ... H_4 [e_5 .. e_8]
    Y = torch.eye(9, dtype=A.dtype, device=A.device)[:, 5:].expand(
        A.shape[:-2] + (9, 4))
    for v, beta in reversed(vs):
        Y = Y - (beta * v)[..., :, None] * (v[..., :, None] * Y).sum(dim=-2,
                                                                     keepdim=True)
    return Y.transpose(-1, -2)


def _xy_polys(G: torch.Tensor, rA: int, rB: int):
    """z*row(rB) - row(rA) of the reduced system: (a (deg 3), b (deg 3),
    c (deg 4)), ascending, over leading axes."""
    gA, gB = G[..., rA, :], G[..., rB, :]
    a = torch.stack([gA[..., 2], gA[..., 1] - gB[..., 2],
                     gA[..., 0] - gB[..., 1], -gB[..., 0]], dim=-1)
    b = torch.stack([gA[..., 5], gA[..., 4] - gB[..., 5],
                     gA[..., 3] - gB[..., 4], -gB[..., 3]], dim=-1)
    c = torch.stack([gA[..., 9], gA[..., 8] - gB[..., 9],
                     gA[..., 7] - gB[..., 8], gA[..., 6] - gB[..., 7],
                     -gB[..., 6]], dim=-1)
    return a, b, c


def five_point_essential(x1: torch.Tensor, x2: torch.Tensor):
    """Essential matrices from 5 normalized correspondences.

    x1, x2: (..., 5, 2) normalized image coordinates (x2^T E x1 = 0).
    Returns (Es (..., 10, 3, 3) float32, ok (..., 10) bool): up to 10 real
    solutions, each Frobenius-normalized; slots with non-real or
    non-finite roots have ok False.
    """
    lead = x1.shape[:-2]
    # --- 1. null-space basis -------------------------------------------
    u1, v1 = x1[..., 0], x1[..., 1]
    u2, v2 = x2[..., 0], x2[..., 1]
    A = torch.stack([u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2,
                     u1, v1, torch.ones_like(u1)], dim=-1)      # (..., 5, 9)
    # The reflections run in float64 (45 small elementwise ops): the
    # null space of these ill-conditioned systems then carries less
    # rounding than LAPACK's float32 SVD gives JAX.
    B = _null_space_5x9(A.double()).to(A.dtype).reshape(lead + (4, 3, 3))

    # --- 2. constraint coefficients: exact trilinear expansion ----------
    # det tensor D[i,j,k] = B_i[0] . (B_j[1] x B_k[2])
    CR = torch.linalg.cross(B[..., :, None, 1, :], B[..., None, :, 2, :],
                            dim=-1)                             # (..., 4, 4, 3)
    D = torch.einsum("...ia,...jka->...ijk", B[..., :, 0, :], CR)
    # trace tensor T[i,j,k] = 2 B_i B_j^T B_k - tr(B_i B_j^T) B_k
    BBt = torch.einsum("...iab,...jcb->...ijac", B, B)
    tr = torch.einsum("...iab,...jab->...ij", B, B)
    T = (2.0 * torch.einsum("...ijac,...kcb->...ijkab", BBt, B)
         - tr[..., :, :, None, None, None] * B[..., None, None, :, :, :])
    A64 = _a64(x1.device)
    coef_det = torch.matmul(D.reshape(lead + (1, 64)), A64)
    coef_tr = torch.matmul(T.reshape(lead + (64, 9)).transpose(-1, -2), A64)
    C = torch.cat([coef_det, coef_tr], dim=-2)                  # (..., 10, 20)

    # --- 3. eliminate (one step of iterative refinement); det B(z) -------
    C1, C2 = C[..., :10], C[..., 10:]
    G = torch.linalg.solve_ex(C1, C2)[0]
    G = G + torch.linalg.solve_ex(C1, C2 - torch.matmul(C1, G))[0]
    rows = [_xy_polys(G, 4, 5), _xy_polys(G, 6, 7), _xy_polys(G, 8, 9)]
    (a1, b1, c1), (a2, b2, c2), (a3, b3, c3) = rows
    det_poly = (_conv(a1, _conv(b2, c3) - _conv(b3, c2))
                - _conv(b1, _conv(a2, c3) - _conv(a3, c2))
                + _conv(c1, _conv(a2, b3) - _conv(a3, b2)))     # (..., 11)

    # --- 4. roots -> (x, y, z) -> E -------------------------------------
    roots = _durand_kerner(det_poly)
    z = roots.real
    is_real = torch.abs(roots.imag) < 1e-3 * (1.0 + torch.abs(z))

    # All nine polynomials at the ten roots: (..., 10, 3) each of a, b, c.
    def at_roots(polys):
        P = torch.stack(polys, dim=-2)                          # (..., 3, d+1)
        return _polyval(P[..., None, :, :], z[..., :, None])
    Ma = at_roots([r[0] for r in rows])
    Mb = at_roots([r[1] for r in rows])
    v = -at_roots([r[2] for r in rows])
    # 2x2 normal equations of the (3, 2) least squares [Ma Mb] (x, y) = v
    m00 = (Ma * Ma).sum(-1)
    m01 = (Ma * Mb).sum(-1)
    m11 = (Mb * Mb).sum(-1)
    r0 = (Ma * v).sum(-1)
    r1 = (Mb * v).sum(-1)
    d = m00 * m11 - m01 * m01
    d = torch.where(torch.abs(d) < 1e-30, torch.full_like(d, 1e-30), d)
    xs = (m11 * r0 - m01 * r1) / d
    ys = (m00 * r1 - m01 * r0) / d
    Es = (xs[..., None, None] * B[..., None, 0, :, :]
          + ys[..., None, None] * B[..., None, 1, :, :]
          + z[..., None, None] * B[..., None, 2, :, :]
          + B[..., None, 3, :, :])                              # (..., 10, 3, 3)
    # Two-step normalization: a near-degenerate root gives a finite but huge
    # (x, y) whose squared norm overflows f32 to inf, and E / inf = 0 then
    # sweeps every point in as an inlier. Scaling by max |entry| first keeps
    # the norm in range; the norm guard kills what degeneracy remains.
    flat = Es.reshape(lead + (10, 9))
    maxabs = torch.abs(flat).amax(dim=-1)
    Es = Es / torch.clamp(maxabs, min=1e-12)[..., None, None]
    norm = torch.linalg.vector_norm(Es.reshape(lead + (10, 9)), dim=-1)
    Es = Es / torch.clamp(norm, min=1e-12)[..., None, None]
    ok = (is_real & torch.isfinite(Es.reshape(lead + (10, 9))).all(dim=-1)
          & (norm > 1e-3))
    return Es.to(torch.float32), ok
