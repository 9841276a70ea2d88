"""Essential-matrix RANSAC and rotation recovery (the mono-rotation path).

Frozen copy of ``visual_odom_tpu_torch/backend/essential.py`` at commit 245329126dfa,
with its imports pointed at this package: the benchmark's yardstick, which
a change to the program must not move. The text below is the original's.

Port of ``visual_odom_tpu/backend/essential.py`` (``EssentialResult``,
``_normalize``, ``_eight_point``, ``_sampson_sq``, ``_decompose_and_vote``,
``find_essential_ransac``): cv::findEssentialMat(RANSAC, threshold 1 px)
followed by cv::recoverPose, as the reference's optional rotation branch
calls them (src/visualOdometry.cpp:152-157). Hypotheses come from Nister's
5-point solver (``solver="5pt"``, ``backend.five_point``) or from linear
8-point samples (``"8pt"``); both share the Sampson inlier test, the
weighted 8-point polish on the winner's inliers, and the closed-form
twisted-pair + cheirality decomposition (no SVD).

Everything is written over an optional leading batch of sequences and runs
without waiting for the device. The 8-point solve's two decompositions
(JAX: ``eigh`` of the 9x9 normal matrix, ``svd`` of the 3x3 projection),
whose CUDA calls read their convergence flag back to the host, are cyclic
Jacobi sweeps here (``sym_eig``), a fixed number of rotations.

Random draws come from the sequence's ``torch.Generator``; ``uniforms``
(iterations, N) replaces the draw, so a test can feed the JAX package's.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from vobench.reference.five_point import five_point_essential
from vobench.reference.lie import _hat

#: Jacobi sweeps: quadratic convergence takes the 8-point normal matrices
#: to their float32 floor in 4 (measured against float64 LAPACK); 6 leave
#: a margin (tests/test_torch_essential.py holds them to LAPACK)
JACOBI_SWEEPS = 6


class EssentialResult(NamedTuple):
    E: torch.Tensor            # ([B,] 3, 3)
    R: torch.Tensor            # ([B,] 3, 3) rotation, cam2 = R cam1 + t
    t: torch.Tensor            # ([B,] 3) unit translation
    inliers: torch.Tensor      # ([B,] N) bool
    num_inliers: torch.Tensor  # ([B,]) int32


def _normalize(pts: torch.Tensor, focal, pp) -> torch.Tensor:
    # Python scalars, not a tensor of ``pp``: a copy to the card would wait.
    return torch.stack([(pts[..., 0] - float(pp[0])) / focal,
                        (pts[..., 1] - float(pp[1])) / focal], dim=-1)


@functools.lru_cache(maxsize=None)
def _jacobi_rounds(n: int) -> tuple:
    """Round-robin pairings of an even ``n`` indices: n - 1 rounds of n / 2
    disjoint (p, q) pairs, every pair once per sweep."""
    idx = list(range(n))
    rounds = []
    for _ in range(n - 1):
        pairs = [(min(idx[i], idx[n - 1 - i]), max(idx[i], idx[n - 1 - i]))
                 for i in range(n // 2)]
        rounds.append(tuple(pairs))
        idx = [idx[0], idx[-1]] + idx[1:-1]
    return tuple(rounds)


@functools.lru_cache(maxsize=None)
def _round_tensors(n: int, device: torch.device, dtype: torch.dtype) -> list:
    """Per round: flat indices of (p,p), (q,q), (p,q) and the (2k, n, n)
    pattern that places c_k on (p,p), (q,q) and s_k on (p,q), -s_k on
    (q,p) of the round's k pairs."""
    out = []
    for pairs in _jacobi_rounds(n):
        p = np.array([a for a, _ in pairs])
        q = np.array([b for _, b in pairs])
        flat = np.concatenate([p * n + p, q * n + q, p * n + q])
        Pc = np.zeros((len(pairs), n, n), np.float32)
        Ps = np.zeros((len(pairs), n, n), np.float32)
        for k, (a, b) in enumerate(pairs):
            Pc[k, a, a] = Pc[k, b, b] = 1.0
            Ps[k, a, b], Ps[k, b, a] = 1.0, -1.0
        out.append((torch.from_numpy(flat).to(device),
                    torch.from_numpy(np.concatenate([Pc, Ps])).to(device,
                                                                   dtype)))
    return out


def sym_eig(S: torch.Tensor, sweeps: int = JACOBI_SWEEPS):
    """Eigen-decomposition of symmetric (..., n, n) matrices by cyclic
    Jacobi sweeps in round-robin order (each round rotates n/2 disjoint
    planes as one batched product). Returns (eigenvalues (..., n)
    ascending, eigenvectors (..., n, n) as columns), like
    ``torch.linalg.eigh`` but in a fixed number of steps. An odd n is
    padded with a decoupled row and column that no rotation touches."""
    n = S.shape[-1]
    m = n + n % 2
    if m != n:
        S = torch.nn.functional.pad(S, (0, 1, 0, 1))
    V = torch.eye(m, dtype=S.dtype, device=S.device).expand(S.shape).clone()
    rounds = _round_tensors(m, S.device, S.dtype)
    k = m // 2
    for _ in range(sweeps):
        for flat, P in rounds:
            g = S.flatten(-2)[..., flat]
            app, aqq, apq = g[..., :k], g[..., k:2 * k], g[..., 2 * k:]
            # The angle that zeroes (p, q): tan 2t = 2 a_pq / (a_qq - a_pp),
            # the small one, |t| <= pi/4 (a pair whose a_pq is already 0,
            # such as one with the pad index, stays put).
            d = aqq - app
            sign = 1.0 - 2.0 * (d < 0).to(d.dtype)
            theta = 0.5 * torch.atan2(2.0 * apq * sign, torch.abs(d))
            J = torch.einsum("...k,kij->...ij",
                             torch.cat([torch.cos(theta), torch.sin(theta)],
                                       dim=-1), P)
            S = J.transpose(-1, -2) @ S @ J
            V = V @ J
    w = torch.diagonal(S, dim1=-2, dim2=-1)[..., :n]
    V = V[..., :n, :n]
    order = torch.argsort(w, dim=-1)
    return (torch.take_along_dim(w, order, dim=-1),
            torch.take_along_dim(V, order[..., None, :], dim=-1))


def _eight_point(x1: torch.Tensor, x2: torch.Tensor,
                 w: torch.Tensor) -> torch.Tensor:
    """Weighted linear E from normalized correspondences x1, x2 (..., M, 2)
    and weights w (..., M), projected onto the essential manifold
    (singular values (s, s, 0), s the mean of the two largest)."""
    u1, v1 = x1[..., 0], x1[..., 1]
    u2, v2 = x2[..., 0], x2[..., 1]
    A = torch.stack([u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2, u1, v1,
                     torch.ones_like(u1)], dim=-1) * w[..., None]
    AtA = A.transpose(-1, -2) @ A
    _, V = sym_eig(AtA)
    E = V[..., :, 0].reshape(x1.shape[:-2] + (3, 3))
    # E = U diag(s1, s2, s3) V^T with v_i the eigenvectors of E^T E:
    # u_i v_i^T = E v_i v_i^T / s_i, so the projection is
    # s_mean * E (v1 v1^T / s1 + v2 v2^T / s2).
    lam, Ve = sym_eig(E.transpose(-1, -2) @ E)
    sv = torch.sqrt(torch.clamp(lam, min=0.0))                  # ascending
    s1, s2 = sv[..., 2], sv[..., 1]
    va, vb = Ve[..., :, 2], Ve[..., :, 1]

    def inv(s):
        return torch.where(s > 0, 1.0 / torch.where(s > 0, s, 1.0), 0.0)

    P = (va[..., :, None] * va[..., None, :] * inv(s1)[..., None, None]
         + vb[..., :, None] * vb[..., None, :] * inv(s2)[..., None, None])
    return 0.5 * (s1 + s2)[..., None, None] * (E @ P)


def _sampson_sq(E: torch.Tensor, x1: torch.Tensor,
                x2: torch.Tensor) -> torch.Tensor:
    """Squared Sampson distances of x1, x2 (..., N, 2) under E (..., 3, 3)
    in normalized coordinates -> (..., N)."""
    x1h = torch.cat([x1, torch.ones_like(x1[..., :1])], dim=-1)
    x2h = torch.cat([x2, torch.ones_like(x2[..., :1])], dim=-1)
    Ex1 = x1h @ E.transpose(-1, -2)                              # (..., N, 3)
    Etx2 = x2h @ E
    x2tEx1 = (x2h * Ex1).sum(dim=-1)
    denom = (Ex1[..., 0] ** 2 + Ex1[..., 1] ** 2 + Etx2[..., 0] ** 2
             + Etx2[..., 1] ** 2)
    return x2tEx1 * x2tEx1 / torch.clamp(denom, min=1e-12)


def _decompose_and_vote(E, x1, x2, w):
    """recoverPose in closed form: t is perpendicular to E's columns (the
    largest column cross product), R = Cof(E) -+ [t]x E for ||t|| = 1,
    ||E||_F = sqrt(2) (Horn), each made orthonormal by two Newton polar
    steps; of the four (R, +-t) the one with the most weight ``w`` of
    points in front of both cameras wins. E (..., 3, 3), x1, x2 (..., N, 2),
    w (..., N). Returns (R (..., 3, 3), t (..., 3))."""
    cross = torch.linalg.cross
    norm = torch.linalg.vector_norm
    E = E * (float(np.sqrt(2.0)) / torch.clamp(
        norm(E.flatten(-2), dim=-1), min=1e-12))[..., None, None]
    c0, c1, c2 = E[..., :, 0], E[..., :, 1], E[..., :, 2]
    t_cands = torch.stack([cross(c0, c1, dim=-1), cross(c1, c2, dim=-1),
                           cross(c2, c0, dim=-1)], dim=-2)       # (..., 3, 3)
    pick = torch.argmax(norm(t_cands, dim=-1), dim=-1, keepdim=True)
    t = torch.take_along_dim(t_cands, pick[..., None], dim=-2)[..., 0, :]
    t = t / torch.clamp(norm(t, dim=-1, keepdim=True), min=1e-12)

    r0, r1, r2 = E[..., 0, :], E[..., 1, :], E[..., 2, :]
    cof = torch.stack([cross(r1, r2, dim=-1), cross(r2, r0, dim=-1),
                       cross(r0, r1, dim=-1)], dim=-2)
    txE = _hat(t) @ E
    eye = torch.eye(3, dtype=E.dtype, device=E.device)

    def polar(R):
        for _ in range(2):
            R = R @ (1.5 * eye - 0.5 * (R.transpose(-1, -2) @ R))
        return R

    R1 = polar(cof - txE)
    R2 = polar(cof + txE)
    Rs = torch.stack([R1, R1, R2, R2], dim=-3)                   # (..., 4, 3, 3)
    ts = torch.stack([t, -t, t, -t], dim=-2)                     # (..., 4, 3)

    # Depth signs from z2 x2h = z1 R x1h + t, least squares in (z1, z2).
    x1h = torch.cat([x1, torch.ones_like(x1[..., :1])], dim=-1)[..., None, :, :]
    c = torch.cat([x2, torch.ones_like(x2[..., :1])], dim=-1)[..., None, :, :]
    a = x1h @ Rs.transpose(-1, -2)                               # (..., 4, N, 3)
    tt = ts[..., :, None, :]
    aa = (a * a).sum(-1)
    ac = (a * c).sum(-1)
    cc = (c * c).sum(-1)
    at = (a * tt).sum(-1)
    ct = (c * tt).sum(-1)
    det = aa * cc - ac * ac
    det = torch.where(torch.abs(det) < 1e-12, torch.full_like(det, 1e-12), det)
    z1 = (-at * cc + ac * ct) / det
    z2 = (aa * ct - ac * at) / det
    votes = (((z1 > 0) & (z2 > 0)) * w[..., None, :]).sum(-1)   # (..., 4)
    k = torch.argmax(votes, dim=-1, keepdim=True)
    R = torch.take_along_dim(Rs, k[..., None, None], dim=-3)[..., 0, :, :]
    t = torch.take_along_dim(ts, k[..., None], dim=-2)[..., 0, :]
    return R, t


def find_essential_ransac(pts1: torch.Tensor, pts2: torch.Tensor,
                          valid: torch.Tensor, focal: float, pp,
                          generator=None, threshold: float = 1.0,
                          iterations: int = 200, sample_size: int = 8,
                          solver: str = "5pt",
                          uniforms: torch.Tensor = None) -> EssentialResult:
    """findEssentialMat(RANSAC) + recoverPose.

    pts1, pts2 (N, 2) pixel correspondences (L(t0) -> L(t1)), valid (N,);
    ``threshold`` in pixels. ``solver``: "5pt" (Nister, the reference's
    algorithm; five points a sample, every candidate scored) or "8pt"
    (linear, ``sample_size`` points a sample). Each hypothesis samples the
    top-k of iid uniforms over the valid slots, drawn from ``generator``
    unless ``uniforms`` (iterations, N) is given.

    Batched (B sequences): pts (B, N, 2), valid (B, N), ``generator`` a
    sequence of B generators or ``uniforms`` (B, iterations, N); every
    field of the result gets a leading B.
    """
    if solver not in ("5pt", "8pt"):
        raise ValueError(f"solver must be '5pt' or '8pt', got {solver!r}")
    if pts1.dim() == 2:
        res = find_essential_ransac(
            pts1[None], pts2[None], valid[None], focal, pp,
            None if generator is None else (generator,), threshold,
            iterations, sample_size, solver,
            None if uniforms is None else uniforms[None])
        return EssentialResult(*(x[0] for x in res))
    B, N = pts1.shape[:2]
    dev = pts1.device
    x1 = _normalize(pts1.to(torch.float32), focal, pp)
    x2 = _normalize(pts2.to(torch.float32), focal, pp)
    thr_n = (threshold / focal) ** 2

    if uniforms is None:
        uniforms = torch.stack([torch.rand((iterations, N), generator=g,
                                           device=dev) for g in generator])
    u = torch.where(valid[:, None, :], uniforms, torch.full_like(uniforms, -1.0))
    k = 5 if solver == "5pt" else sample_size
    idx = torch.topk(u, k, dim=-1).indices[..., None]           # (B, H, k, 1)
    s1 = torch.take_along_dim(x1[:, None], idx, dim=2)          # (B, H, k, 2)
    s2 = torch.take_along_dim(x2[:, None], idx, dim=2)
    X1, X2 = x1[:, None, None], x2[:, None, None]               # (B, 1, 1, N, 2)
    if solver == "5pt":
        # Up to 10 candidates a sample; the sample contributes its best.
        Es_c, ok_c = five_point_essential(s1, s2)               # (B, H, 10, ...)
        inl_c = (_sampson_sq(Es_c, X1, X2) < thr_n) & valid[:, None, None, :]
        cnt_c = torch.where(ok_c, inl_c.sum(dim=-1), 0)
        j = torch.argmax(cnt_c, dim=-1, keepdim=True)           # (B, H, 1)
        Es = torch.take_along_dim(Es_c, j[..., None, None], dim=2)[:, :, 0]
        inls = torch.take_along_dim(inl_c, j[..., None], dim=2)[:, :, 0]
        counts = torch.take_along_dim(cnt_c, j, dim=2)[:, :, 0]
    else:
        Es = _eight_point(s1, s2, torch.ones(s1.shape[:-1], device=dev))
        inls = (_sampson_sq(Es, x1[:, None], x2[:, None]) < thr_n) & valid[:, None]
        counts = inls.sum(dim=-1)
    finite = torch.isfinite(Es.flatten(-2)).all(dim=-1)
    counts = torch.where(finite, counts, 0)
    best = torch.argmax(counts, dim=1, keepdim=True)            # (B, 1)
    E_best = torch.take_along_dim(Es, best[..., None, None], dim=1)[:, 0]
    inl_best = torch.take_along_dim(inls, best[..., None], dim=1)[:, 0]
    cnt_best = torch.take_along_dim(counts, best, dim=1)[:, 0]

    # Polish on the inlier set (weighted 8-point over all N).
    E = _eight_point(x1, x2, inl_best.to(torch.float32))
    inliers = (_sampson_sq(E, x1, x2) < thr_n) & valid
    better = inliers.sum(dim=-1) >= cnt_best
    E = torch.where(better[:, None, None], E, E_best)
    inliers = torch.where(better[:, None], inliers, inl_best)
    R, t = _decompose_and_vote(E, x1, x2, inliers.to(torch.float32))
    return EssentialResult(E=E, R=R, t=t, inliers=inliers,
                           num_inliers=inliers.sum(dim=-1).to(torch.int32))
