"""Ring-sharded sequence-parallel windowed bundle adjustment.

Port of ``visual_odom_tpu/parallel/ring_ba.py``. A long keyframe trajectory
is split into contiguous windows, one per device along a mesh axis, with
``halo`` overlap keyframes mirrored from each neighbour. Per Gauss-Newton
round every window:

1. refreshes its halo poses from its neighbours (two ``ppermute``s, zeros
   at the ring's ends) and assembles Jacobian blocks for its observation
   rows (halo rows replicate the neighbour's data, so boundary coupling
   blocks are computed locally and exactly);
2. sums the LANDMARK normal equations over the windows' core rows
   (``psum`` of Hll and bl), so the landmark elimination is globally exact
   and the landmark update the same on every device;
3. solves the reduced camera system S dp = rhs with distributed
   block-Jacobi-preconditioned conjugate gradients: tracks span at most
   ``halo + 1`` keyframes, so S couples only adjacent windows and a matvec
   needs one ring exchange of the (halo, 6) boundary entries; the dot
   products are ``psum``s of scalars;
4. back-substitutes the landmarks with one more ``psum``.

The JAX package runs ``local_solve`` under ``shard_map``; here either one
process issues each window's work on its device, or each rank of a mesh of
ranks issues its own window's, and the collectives
(``parallel.collectives``) move the shards. Every guard is a
``torch.where`` on the device (the CG's ``pAp > 0`` and ``rz > 0``, the
finite guard), so a solve never waits for the host. The gauge is a hard
projection of global pose 0's update to zero, not ``ba_solve``'s 1e9
prior. Float32 throughout (TF32 is off package-wide).

Validity: a landmark may couple poses at distance <= halo (track span <=
halo + 1 keyframes). ``make_ring_windows`` raises on a longer track;
``required_ring_halo`` derives the minimal exact halo from the mask and
``ring_ba_solve(halo=None)`` selects it.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from visual_odom_tpu_torch.ba.problem import BAProblem
from visual_odom_tpu_torch.ba.schur import _jacobian_blocks, ba_solve
from visual_odom_tpu_torch.parallel.collectives import (axis_key, axis_size,
                                                        gather, graph_devices,
                                                        graph_place,
                                                        ppermute, psum,
                                                        replicated, shards,
                                                        use_graph_on)
from visual_odom_tpu_torch.parallel.mesh import Mesh, mesh_axis
from visual_odom_tpu_torch.utils.cudagraph import GraphedLoop


class RingWindows(NamedTuple):
    """Host-built windowed view of a BAProblem, ready to place over the
    sequence axis. D = number of windows (devices), Wl = core + 2*halo."""

    poses: torch.Tensor         # (D, Wl, 6)
    landmarks: torch.Tensor     # (D, L, 3) replicated copies
    observations: torch.Tensor  # (D, Wl, L, 3)
    mask: torch.Tensor          # (D, Wl, L) bool
    pose_valid: torch.Tensor    # (D, Wl) bool, False for out-of-range halos
    core: int                   # poses owned per window
    halo: int


def required_ring_halo(problem: BAProblem) -> int:
    """Minimal halo for which the ring solve is EXACT: the largest
    pose-index span any landmark track couples (a track over poses i..j
    couples pose pairs up to distance j - i). Reads the mask on the
    host."""
    mask = problem.mask.cpu().numpy()                          # (W, L)
    W = mask.shape[0]
    idx = np.arange(W)[:, None]
    lo = np.where(mask, idx, W).min(axis=0)                    # (L,)
    hi = np.where(mask, idx, -1).max(axis=0)
    span = np.where(hi >= lo, hi - lo, 0)
    return int(span.max(initial=0))


def pad_problem_for_ring(problem: BAProblem, target_poses: int) -> BAProblem:
    """Append observation-less poses so W divides the window count. Padded
    poses have empty mask rows: zero residuals and Jacobians, so their GN
    update is exactly zero; they ride along untouched and the caller trims
    them."""
    W = problem.poses.shape[0]
    if target_poses == W:
        return problem
    extra = target_poses - W
    obs, mask = problem.observations, problem.mask
    return problem._replace(
        poses=torch.cat([problem.poses,
                         problem.poses[-1:].expand(extra, -1)]),
        observations=torch.cat([obs, obs.new_zeros((extra,) + obs.shape[1:])]),
        mask=torch.cat([mask, mask.new_zeros((extra,) + mask.shape[1:])]))


def make_ring_windows(problem: BAProblem, num_windows: int,
                      halo: int = 1, check_span: bool = True) -> RingWindows:
    """Split a (W, L) BAProblem into overlapping windows, on the problem's
    device.

    W must be divisible by num_windows (``pad_problem_for_ring`` first if
    not). Out-of-range halo slots of the edge windows are clamped to index
    0 and masked invalid. Raises when any landmark track spans more than
    halo + 1 poses: the solve would silently drop that track's long-range
    pose-pose coupling and become approximate.
    """
    W = problem.poses.shape[0]
    D = num_windows
    if W % D != 0:
        raise ValueError(f"poses ({W}) not divisible by windows ({D})")
    core = W // D
    if halo > core:
        raise ValueError(f"halo ({halo}) cannot exceed core ({core})")
    if check_span and D > 1:
        need = required_ring_halo(problem)
        if need > halo:
            raise ValueError(
                f"landmark tracks span up to {need + 1} poses but halo is "
                f"{halo}: the ring solve would drop pose-pose coupling and "
                f"be silently approximate; pass halo >= {need} (or halo="
                f"None to ring_ba_solve for auto-selection)")

    # Global pose index for each (window, local slot).
    local = np.arange(-halo, core + halo)
    gidx = np.arange(D)[:, None] * core + local[None, :]     # (D, Wl)
    valid = (gidx >= 0) & (gidx < W)
    dev = problem.poses.device
    cidx = torch.as_tensor(np.clip(gidx, 0, W - 1), device=dev)
    valid_t = torch.as_tensor(valid, device=dev)
    return RingWindows(
        poses=problem.poses[cidx],                            # (D, Wl, 6)
        landmarks=problem.landmarks.expand((D,) + problem.landmarks.shape),
        observations=problem.observations[cidx],              # (D, Wl, L, 3)
        mask=problem.mask[cidx] & valid_t[..., None],
        pose_valid=valid_t,
        core=core,
        halo=halo,
    )


def merge_ring_windows(problem: BAProblem, win: RingWindows, out_poses,
                       out_landmarks) -> BAProblem:
    """Reassemble the global problem: core poses from their owner window.
    Landmark updates are replicated, so every window holds the same copy:
    window 0's is taken. ``out_poses`` (D, Wl, 6) and ``out_landmarks``
    (D, L, 3) are tensors or arrays."""
    dev = problem.poses.device
    out_poses = torch.as_tensor(out_poses, device=dev)
    D = out_poses.shape[0]
    core, halo = win.core, win.halo
    poses = out_poses[:, halo:halo + core].reshape(D * core, 6)
    return problem._replace(
        poses=poses.to(problem.poses.dtype),
        landmarks=torch.as_tensor(out_landmarks[0], device=dev).to(
            problem.landmarks.dtype))


class _Window(NamedTuple):
    """One window's operands in a GN round: its problem (the window's
    poses, the replicated landmarks, its observation rows) and its
    constants."""

    problem: BAProblem
    pose_valid: torch.Tensor    # (Wl,) bool
    core_w: torch.Tensor        # (Wl,) 1 on core slots, 0 on halo slots
    free: torch.Tensor          # (Wl, 1) 1 on the slots the CG solves for
    eye3: torch.Tensor
    eye6: torch.Tensor
    eyeWl: torch.Tensor


def _ring_round(windows, ax, core: int, halo: int, cg_iters: int,
                damping: float, huber_delta: float):
    """One exact global GN round over the windows this process holds (a
    tuple of ``_Window``s): halo refresh, the windows' Jacobian blocks, the
    landmark normal equations summed, the reduced system solved by the
    distributed PCG, the landmarks back-substituted. Only the poses and
    the landmarks change."""
    D = axis_size(ax)
    fwd = [(i, i + 1) for i in range(D - 1)]     # window 0 receives zeros
    bwd = [(i + 1, i) for i in range(D - 1)]     # window D-1 receives zeros
    pose_valid = [w.pose_valid for w in windows]
    core_w = [w.core_w for w in windows]
    free = [w.free for w in windows]
    eye3 = [w.eye3 for w in windows]
    eye6 = [w.eye6 for w in windows]
    eyeWl = [w.eyeWl for w in windows]
    poses = [w.problem.poses for w in windows]

    def refresh_halos(xs):
        """Each window's halo slots of a distributed (Wl, ...) vector set to
        its neighbours' boundary core entries (zeros past the ring's
        ends)."""
        from_left = ppermute([x[core:core + halo] for x in xs], fwd, ax)
        from_right = ppermute([x[halo:2 * halo] for x in xs], bwd, ax)
        return [torch.cat([lf, x[halo:halo + core], rt])
                for x, lf, rt in zip(xs, from_left, from_right)]

    def dot(a, b):
        return psum([torch.sum(x * y) for x, y in zip(a, b)], ax)

    def ratio(num, den):
        """num / den where den > 0, else 0 (the CG's guards)."""
        return torch.where(den > 0, num / torch.clamp(den, min=1e-30),
                           torch.zeros_like(num))

    # Linearization point: halo poses mirror their owner exactly.
    poses = [torch.where(v[:, None], p, q) for v, p, q in
             zip(pose_valid, refresh_halos(poses), poses)]
    blocks = [_jacobian_blocks(w.problem._replace(poses=p),
                               huber_delta=huber_delta)
              for w, p in zip(windows, poses)]
    # (Wl, L, 3, 6), (Wl, L, 3, 3), (Wl, L, 3)

    # --- globally reduced landmark normal equations -----------------------
    # Every observation row is core to exactly one window, so the sum of
    # the core rows' contributions is the full problem's.
    Bc = [B * w[:, None, None, None] for (_, B, _), w in zip(blocks, core_w)]
    Hll = psum([torch.einsum("wlri,wlrj->lij", bc, B)
                for bc, (_, B, _) in zip(Bc, blocks)], ax)
    bl = psum([torch.einsum("wlri,wlr->li", bc, r)
               for bc, (_, _, r) in zip(Bc, blocks)], ax)
    Hll_inv = replicated(
        ax, lambda H, e: torch.linalg.inv_ex(H + damping * e)[0],
        Hll, eye3)                                              # (L, 3, 3)

    # --- local rows of the global reduced camera system -------------------
    # Halo rows replicate the neighbour's observation rows, so S[w, v] for
    # v up to `halo` slots into the neighbour is exact.
    S, rhs, Hpl, Pinv = [], [], [], []
    for k, (A, B, r) in enumerate(blocks):
        Hpp = torch.einsum("wlri,wlrj->wij", A, A)
        hpl = torch.einsum("wlri,wlrj->wlij", A, B)
        bp = torch.einsum("wlri,wlr->wi", A, r)
        HplWinv = torch.einsum("wlij,ljk->wlik", hpl, Hll_inv[k])
        s = -torch.einsum("wlik,vljk->wvij", HplWinv, hpl)
        s = s + torch.einsum("wv,wij->wvij", eyeWl[k],
                             Hpp + damping * eye6[k])
        S.append(s)
        rhs.append(bp - torch.einsum("wlik,lk->wi", HplWinv, bl[k]))
        Hpl.append(hpl)
        Pinv.append(torch.linalg.inv_ex(
            torch.diagonal(s, dim1=0, dim2=1).permute(2, 0, 1)
            + 1e-12 * eye6[k])[0])                              # (Wl, 6, 6)

    # --- distributed block-Jacobi PCG on S dp = rhs -----------------------
    def matvec(xs):
        return [torch.einsum("wvij,vj->wi", s, x) * f
                for s, x, f in zip(S, refresh_halos(xs), free)]

    def precond(rs):
        return [torch.einsum("wij,wj->wi", p, r) * f
                for p, r, f in zip(Pinv, rs, free)]

    b = [r * f for r, f in zip(rhs, free)]
    x = [torch.zeros_like(v) for v in b]
    res = b
    z = precond(b)
    p = z
    rz = dot(b, z)
    for _ in range(cg_iters):
        Ap = matvec(p)
        pAp = dot(p, Ap)
        # the scalars are psum outputs: once per device
        alpha = replicated(ax, ratio, rz, pAp)
        x = [xi + a * pi for xi, a, pi in zip(x, alpha, p)]
        res = [ri - a * api for ri, a, api in zip(res, alpha, Ap)]
        z = precond(res)
        rz_new = dot(res, z)
        beta = replicated(ax, ratio, rz_new, rz)
        p = [zi + bt * pi for zi, bt, pi in zip(z, beta, p)]
        rz = rz_new
    dp = x

    # --- exact global landmark back-substitution --------------------------
    # corr_l sums Hpl' dp over every global row: core rows per window, then
    # a psum; dx is the same on every device.
    corr = psum([torch.einsum("wlij,wi->lj", h * w[:, None, None, None], d)
                 for h, w, d in zip(Hpl, core_w, dp)], ax)
    dx = replicated(ax, lambda Hi, b_, c: torch.einsum(
        "lij,lj->li", Hi, b_ - c), Hll_inv, bl, corr)

    # windows with a non-finite update, counted on every device
    bad = psum([(~(torch.isfinite(d).all() & torch.isfinite(x_).all()))
                .to(torch.int32) for d, x_ in zip(dp, dx)], ax)
    poses = [torch.where(n > 0, q, q - d) for q, d, n in zip(poses, dp, bad)]
    landmarks = replicated(ax, lambda lm, x_, n: torch.where(
        n > 0, lm, lm - x_), [w.problem.landmarks for w in windows], dx, bad)
    return tuple(w._replace(problem=w.problem._replace(poses=q, landmarks=lm))
                 for w, q, lm in zip(windows, poses, landmarks))


@functools.lru_cache(maxsize=8)
def _graphed_round(ax, core: int, halo: int, cg_iters: int, damping: float,
                   huber_delta: float, _replay_body: bool = False):
    """The GN round over ``ax`` (a tuple of devices, or an NCCL
    ``RankAxis``) as a graphed fixed-trip loop, one per (axis, window
    split, CG iterations, damping, Huber scale) in a process: one capture
    per shape and intrinsics."""
    return GraphedLoop(functools.partial(
        _ring_round, ax=ax, core=core, halo=halo, cg_iters=cg_iters,
        damping=damping, huber_delta=huber_delta), graph_place(ax)[0],
        _replay_body=_replay_body, devices=graph_devices(ax))


def ring_ba_solve(
    problem: BAProblem,
    mesh: Mesh,
    axis: str = "seq",
    halo: int | None = 1,
    rounds: int = 10,
    cg_iters: int = 32,
    damping: float = 1e-4,
    huber_delta: float = 0.0,
) -> BAProblem:
    """Sequence-parallel BA over the mesh's ``axis``, one window per
    position (``parallel.mesh.mesh_axis``).

    Each round is the exact global GN step of ``ba.schur.ba_solve``,
    computed with ring-only pose communication (see the module docstring).
    ``halo=None`` selects the minimal exact halo from the observed track
    spans. ``huber_delta`` > 0 applies ``ba_solve``'s Huber IRLS weighting
    (from replicated halo rows, so every window weighs a shared observation
    alike). Returns the problem, on its own device, with the solved poses
    and landmarks. On a mesh of ranks every rank passes the same problem,
    solves its own window and returns the whole solved problem, the same
    bits on each (the windows' poses all-gathered).

    On a card each round, its ``cg_iters`` CG iterations unrolled, is one
    replay of a CUDA graph (``utils.cudagraph.GraphedLoop``), bit for bit
    the eager round: on an axis of one card the whole round; on an axis
    across cards in one process each card's graphs in turn, cut at the
    copies between windows (``utils.cudagraph._Recording``); on an NCCL
    rank its own window's with the ``ppermute``s and all-gathers inside.
    Gloo ranks iterate eagerly by rule
    (``parallel.collectives.graph_place``).
    """
    ax = mesh_axis(mesh, axis)
    mine = shards(ax)
    D = axis_size(ax)
    if halo is None:
        halo = max(1, required_ring_halo(problem))
    win = make_ring_windows(problem, D, halo=halo)
    core = win.core
    Wl = core + 2 * halo
    dtype = problem.poses.dtype
    pos = np.arange(Wl)
    is_core = (pos >= halo) & (pos < halo + core)
    windows = []
    for k, d in mine:
        is_gauge = (k == 0) & (pos == halo)                     # global pose 0
        pose_valid = win.pose_valid[k].to(d)
        windows.append(_Window(
            problem=problem._replace(poses=win.poses[k].to(d),
                                     landmarks=problem.landmarks.to(d),
                                     observations=win.observations[k].to(d),
                                     mask=win.mask[k].to(d)),
            pose_valid=pose_valid,
            core_w=torch.as_tensor(is_core, dtype=dtype, device=d),
            # CG solves over the free core slots; gauge and invalid slots
            # pinned.
            free=(torch.as_tensor(is_core & ~is_gauge, device=d)
                  & pose_valid).to(dtype)[:, None],
            eye3=torch.eye(3, dtype=dtype, device=d),
            eye6=torch.eye(6, dtype=dtype, device=d),
            eyeWl=torch.eye(Wl, dtype=dtype, device=d)))
    windows = tuple(windows)
    kw = dict(core=core, halo=halo, cg_iters=int(cg_iters),
              damping=float(damping), huber_delta=float(huber_delta))
    if use_graph_on(ax):
        windows = _graphed_round(axis_key(ax), **kw)(windows, rounds)
    else:
        for _ in range(rounds):
            windows = _ring_round(windows, ax, **kw)

    dev = problem.poses.device
    return merge_ring_windows(
        problem, win,
        torch.stack([q.to(dev) for q in gather(
            [w.problem.poses for w in windows], ax)]),
        windows[0].problem.landmarks.to(dev)[None])


def make_ring_window_solver(mesh: Mesh, axis: str = "seq",
                            rounds: int = 8, cg_iters: int = 32,
                            huber_delta: float = 1.5):
    """``solver(problem)`` for ``ba.window.smooth_trajectory_ba`` that
    shards each window's solve over ``mesh``, exactly.

    Per problem it (1) derives the minimal exact halo from the observed
    track spans, (2) pads the pose axis to a multiple of the mesh size,
    and (3) falls back to the single-device ``ba_solve`` with the same
    iteration count and robust weighting whenever the mesh cannot afford
    the halo (halo > core) or has one device: the result is then still
    exact, just not sharded (the JAX package's branch).

    ``solver.branches`` counts the problems each branch solved
    (``{"ring": n, "single": m}``), so a caller can tell which one ran.
    """
    D = axis_size(mesh_axis(mesh, axis))
    branches = {"ring": 0, "single": 0}

    def solver(problem: BAProblem) -> BAProblem:
        W = problem.poses.shape[0]
        halo = max(1, required_ring_halo(problem))
        Wpad = -(-W // D) * D
        if halo > Wpad // D or D == 1:
            branches["single"] += 1
            return ba_solve(problem, iterations=rounds,
                            huber_delta=huber_delta)
        branches["ring"] += 1
        padded = pad_problem_for_ring(problem, Wpad)
        out = ring_ba_solve(padded, mesh, axis=axis, halo=halo,
                            rounds=rounds, cg_iters=cg_iters,
                            huber_delta=huber_delta)
        return out._replace(
            poses=out.poses[:W],
            observations=out.observations[:W],
            mask=out.mask[:W],
        )

    solver.branches = branches
    return solver
