"""Loop detection + closure wiring: VO trajectory -> pose graph -> refined
trajectory.

Port of ``visual_odom_tpu/runner/loopclosure.py``. Revisits are hypothesised
from the estimated positions; each loop edge is measured with the
pipeline's own step (detect on frame i, circular-match into frame j,
triangulate, PnP-RANSAC), so the constraint is a real measurement, not
ground truth; then the keyframe pose graph (``ba.posegraph``) is solved.

Cost model: detection is O(K^2) on K keyframe positions (host numpy); each
measurement is one step on the device, built once per ``close_loops`` call;
the graph solve runs on the device. Nothing here runs in the frame loop.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from visual_odom_tpu_torch import resolve_device
from visual_odom_tpu_torch.ba.posegraph import (PoseGraph, _so3_log_stable,
                                                build_keyframe_graph,
                                                posegraph_solve,
                                                redistribute_poses,
                                                sharded_posegraph_solve)
from visual_odom_tpu_torch.config import CameraIntrinsics, VOConfig
from visual_odom_tpu_torch.core.lie import rodrigues
from visual_odom_tpu_torch.runner.pipeline import (_graphed_step,
                                                   init_vo_state, make_step_fn)
from visual_odom_tpu_torch.utils.cudagraph import use_graph


class LoopClosureInfo(NamedTuple):
    candidates: list          # [(frame_i, frame_j)] considered
    edges: list               # [(frame_i, frame_j, inliers)] accepted
    closure_before_m: Optional[float]
    closure_after_m: Optional[float]
    graph: Optional[PoseGraph] = None   # the keyframe graph as built (solved
                                        # nodes: the returned poses)


def detect_loop_candidates(positions: np.ndarray,
                           keyframe_idx: np.ndarray,
                           radius: float = 10.0,
                           min_separation: int = 100,
                           max_candidates: int = 32) -> list:
    """Revisit hypotheses from the ESTIMATED trajectory: keyframe pairs
    whose estimated positions fall within ``radius`` meters despite being
    ``min_separation`` frames apart, ordered nearest first. Dedup happens
    at measurement time (``close_loops``), not here: the estimate carries
    the very drift the loop exists to fix, so the nearest-estimated pair is
    not always the measurable one."""
    kf = np.asarray(keyframe_idx)
    p = positions[kf]
    d = np.linalg.norm(p[:, None, :] - p[None, :, :], axis=-1)
    ii, jj = np.meshgrid(kf, kf, indexing="ij")
    ok = (jj - ii >= min_separation) & (d <= radius)
    cand = np.argwhere(ok)
    order = np.argsort(d[ok])
    return [(int(kf[cand[k][0]]), int(kf[cand[k][1]]))
            for k in order[:max_candidates]]


def make_edge_measure(config: VOConfig, intrinsics: CameraIntrinsics,
                      seed: int = 0, device=None):
    """``measure(frame_i, frame_j, uniforms=None) -> (T_ij (4, 4) f64,
    num_inliers, accept)``: the relative pose kf_i -> kf_j measured by one
    step, initialised on frame_i's stereo pair and stepped on frame_j's.
    T_ij maps frame-j camera coordinates into frame i's (the delta inverse
    the per-frame chain integrates); the identity when the step rejects.

    The step is built once here and serves every measurement. Its config
    tracks the full pyramid from zero flow and disparity (no motion prior
    exists between non-consecutive frames, and the adaptive probe would
    only burn a fallback per frame) and has no inlier floor: edge
    acceptance is ``close_loops``' ``min_edge_inliers`` plus the
    bidirectional consistency check. ``uniforms`` replaces the RANSAC draw
    (parity tests); each measurement's generator is seeded ``seed``.

    On a card a measurement is one replay of the edge step's CUDA graph
    (``utils.cudagraph.GraphedStep.fetched``: the fresh state loaded into its
    buffers, the outputs fetched in one copy), bit for bit the eager step;
    one given ``uniforms`` steps eagerly (``utils.cudagraph.use_graph``
    picks)."""
    dev = resolve_device(device)
    cfg = dataclasses.replace(config, lk_skip_mode="fixed",
                              lk_seed_skip_levels=0, min_accept_inliers=0)
    step = make_step_fn(cfg, intrinsics, device=dev)
    graphed = (_graphed_step(cfg, intrinsics, False, dev)
               if use_graph(dev) else None)

    def measure(frame_i, frame_j, uniforms=None):
        state = init_vo_state(cfg, intrinsics, *frame_i, seed=seed, device=dev)
        if graphed is not None and uniforms is None:
            _, out = graphed.fetched(state, *(np.asarray(x) for x in frame_j))
            accept = bool(out.accept)
            T = (np.asarray(out.T_inv, np.float64) if accept else np.eye(4))
            return T, int(out.num_inliers), accept
        _, out = step(state, *(torch.as_tensor(np.asarray(x)).to(dev)
                               for x in frame_j), uniforms=uniforms)
        accept = bool(out.accept)
        T = (out.T_inv.cpu().numpy().astype(np.float64) if accept
             else np.eye(4))
        return T, int(out.num_inliers), accept

    return measure


def measure_loop_edge(frame_i, frame_j, config: VOConfig,
                      intrinsics: CameraIntrinsics, seed: int = 0,
                      device=None, uniforms=None):
    """One loop-edge measurement (``make_edge_measure``) with a step of its
    own. Returns (T_ij (4, 4) f64, num_inliers, accept)."""
    return make_edge_measure(config, intrinsics, seed, device)(
        frame_i, frame_j, uniforms)


def measure_loop_edge_bidirectional(
        frame_i, frame_j, config: VOConfig, intrinsics: CameraIntrinsics,
        consistency_t: float = 0.5, consistency_r_deg: float = 5.0,
        device=None, measure=None):
    """Validated loop-edge measurement: measure i->j AND j->i, require the
    two to invert each other (a wide-baseline mismatch produces two
    independent garbage poses whose composition is far from identity), then
    symmetrize to the SE(3) midpoint of the forward and inverted backward
    measurements. ``measure`` (from ``make_edge_measure``) reuses a built
    step; by default one is built for this call.

    Returns (T_ij (4, 4) f64 or None, min_inliers, ok)."""
    if measure is None:
        measure = make_edge_measure(config, intrinsics, device=device)
    Tf, inl_f, acc_f = measure(frame_i, frame_j)
    Tb, inl_b, acc_b = measure(frame_j, frame_i)
    inl = min(inl_f, inl_b)
    if not (acc_f and acc_b):
        return None, inl, False
    E = Tf @ Tb
    r_err = np.degrees(np.arccos(np.clip(
        (np.trace(E[:3, :3]) - 1.0) * 0.5, -1.0, 1.0)))
    t_err = float(np.linalg.norm(E[:3, 3]))
    if t_err > consistency_t or r_err > consistency_r_deg:
        return None, inl, False
    Tb_inv = np.linalg.inv(Tb)
    mid = np.eye(4)
    # Rotation midpoint: R_f advanced halfway toward R_b^-1, the log and
    # the half rotation in float32 (host), composed in float64.
    d = _so3_log_stable(torch.from_numpy(
        (Tf[:3, :3].T @ Tb_inv[:3, :3]).astype(np.float32))).numpy()
    half = rodrigues(torch.from_numpy((0.5 * d.astype(np.float64))
                                      .astype(np.float32))).numpy()
    mid[:3, :3] = Tf[:3, :3] @ half.astype(np.float64)
    mid[:3, 3] = 0.5 * (Tf[:3, 3] + Tb_inv[:3, 3])
    return mid, inl, True


def close_loops(
    poses: np.ndarray,
    frame_of,
    config: VOConfig,
    intrinsics: CameraIntrinsics,
    keyframe_every: int = 16,
    radius: float = 10.0,
    min_separation: int = 100,
    min_edge_inliers: int = 30,
    gn_iterations: int = 10,
    mesh=None,
    gt_loop_pair: Optional[tuple] = None,
    max_measurements: int = 8,
    device=None,
):
    """Detect revisits in ``poses``, measure loop edges, solve the keyframe
    pose graph on ``device``, and redistribute the drift over all frames.

    Args:
      poses: (N, 4, 4) chained trajectory (frame 0 = identity).
      frame_of: ``frame_of(i) -> (left, right)`` random-access frames.
      keyframe_every: node spacing (frame 0 and the last frame are always
        nodes).
      min_edge_inliers: PnP consensus floor for accepting a measured loop
        edge: a failed wide-baseline match must not write a garbage
        constraint into the graph.
      mesh: optional ``parallel.mesh.Mesh``: solves the graph edge-sharded
        over its "model" axis (``sharded_posegraph_solve``) instead of on
        ``device`` alone.
      gt_loop_pair: optional (i, j) for the closure metric frames (a loop
        course knows its schedule).

    Returns (new_poses (N, 4, 4) f64, LoopClosureInfo). With no accepted
    edge, returns the input unchanged.
    """
    dev = resolve_device(device)
    n = len(poses)
    kf = np.arange(0, n, keyframe_every)
    if kf[-1] != n - 1:
        kf = np.append(kf, n - 1)

    positions = poses[:, :3, 3]
    cands = detect_loop_candidates(positions, kf, radius=radius,
                                   min_separation=min_separation)
    measure = make_edge_measure(config, intrinsics, device=dev)
    edges = []
    accepted = []
    used: set = set()
    measured = 0
    inv = np.linalg.inv
    h = max(1, keyframe_every // 4)
    for (fi, fj) in cands:
        # One accepted edge per revisit neighborhood: endpoints within a
        # keyframe interval of an ACCEPTED edge are covered by it (failed
        # measurements do not block their neighbors).
        if any(abs(fi - a) <= keyframe_every and abs(fj - b) <= keyframe_every
               for (a, b) in used):
            continue
        # The drifted estimate cannot name the exact co-located frame, but
        # LOCAL odometry is accurate: probe a small window around the
        # candidate keyframe and bridge the accepted measurement back to it
        # with the chained odometry (T(fi->fj) = T_meas(fi->j) @
        # T_odo(j->fj)) so the graph edge still lands on keyframe nodes.
        for off in (0, -h, h, -2 * h, 2 * h, -3 * h, 3 * h):
            j = fj + off
            if not (0 <= j < n) or measured >= max_measurements:
                continue
            measured += 1
            T_meas, inl, accept = measure_loop_edge_bidirectional(
                frame_of(fi), frame_of(j), config, intrinsics,
                measure=measure)
            if accept and inl >= min_edge_inliers:
                bridge = inv(poses[j]) @ poses[fj]
                # Loop edges outweigh odometry edges: one loop edge
                # corrects the drift of ~min_separation chained steps.
                edges.append((fi, fj, T_meas @ bridge, 10.0))
                accepted.append((fi, fj, int(inl)))
                used.add((fi, fj))
                break
        if measured >= max_measurements:
            break

    def closure(ps):
        if gt_loop_pair is None:
            return None
        i, j = gt_loop_pair
        return float(np.linalg.norm(ps[j][:3, 3] - ps[i][:3, 3]))

    info = LoopClosureInfo(candidates=cands, edges=accepted,
                           closure_before_m=closure(poses),
                           closure_after_m=None)
    if not edges:
        return poses, info

    graph = build_keyframe_graph(poses, kf, edges, device=dev)
    solved = (sharded_posegraph_solve(graph, mesh, iterations=gn_iterations)
              if mesh is not None else
              posegraph_solve(graph, iterations=gn_iterations))
    new_poses = redistribute_poses(poses, kf, solved.nodes.cpu().numpy())
    return new_poses, info._replace(closure_after_m=closure(new_poses),
                                    graph=graph)
