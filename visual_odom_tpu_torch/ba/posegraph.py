"""Pose-graph optimization, the loop-closure back end.

Port of ``visual_odom_tpu/ba/posegraph.py``: the solve on one device or
edge-sharded over a mesh axis, and the host-side graph glue. Given keyframe world poses, sequential odometry edges
and measured loop edges, a damped Gauss-Newton solve redistributes the
accumulated drift around the graph.

- EDGES are the parallel axis. Each edge's residual touches only its two
  nodes' local tangents, so the 6x6 Jacobian blocks come from one
  ``torch.func.vmap`` of ``torch.func.jacfwd`` over the per-edge
  (delta_i, delta_j).
- Nodes ride as (N, 4, 4) matrices with a right-multiplied retraction
  T(delta) = T @ [R(delta_rot) | delta_t]: no logarithm of WORLD rotations
  is taken (a loop course visits 180-degree headings where the log is
  unstable); only ERROR rotations, small by construction, are logged, via
  the atan2-stable vee form.
- H (6N x 6N) and b assemble by scatter-add of the per-edge blocks (a node
  sits in several edges: ``index_put_`` with ``accumulate=True``); the
  damped normal solve is one dense ``torch.linalg.solve_ex``.
- ``sharded_posegraph_solve`` splits the EDGE axis over a mesh axis: each
  shard's (H, b) sums meet in one ``psum`` (``parallel.collectives``), the
  solve is replicated. Communication per GN iteration: one (6N)^2 + 6N
  sum, independent of E.
- On a card ``posegraph_solve`` replays one GN update from a CUDA graph
  per iteration (``utils.cudagraph.GraphedLoop``), as the JAX package jits
  its loop; so does ``sharded_posegraph_solve`` on an axis of one card or
  of NCCL ranks (the all-gathers inside the graph).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from visual_odom_tpu_torch import resolve_device
from visual_odom_tpu_torch.core.lie import rodrigues, se3_matrix
from visual_odom_tpu_torch.utils.cudagraph import GraphedLoop, use_graph


class PoseGraph(NamedTuple):
    """nodes: (N, 4, 4) world poses (cam->world), f32. edges: (E, 2) int64
    node index pairs (i, j). rel: (E, 4, 4) measured T_ij (pose j in frame
    i, i.e. prediction inv(T_i) @ T_j), f32. weight: (E,) f32 (0 = padding
    edge)."""

    nodes: torch.Tensor
    edges: torch.Tensor
    rel: torch.Tensor
    weight: torch.Tensor


def _so3_log_stable(R: torch.Tensor) -> torch.Tensor:
    """Axis-angle of a near-identity rotation (3, 3), atan2-stable and safe
    under forward-mode derivatives (both select branches finite). Good for
    |theta| < pi: loop-edge error rotations are small by construction."""
    w = 0.5 * torch.stack([R[2, 1] - R[1, 2],
                           R[0, 2] - R[2, 0],
                           R[1, 0] - R[0, 1]])        # sin(theta) * axis
    # s and c stay 1-d: under torch.func.jacfwd a 0-d tensor times a Python
    # float gets a float64 tangent.
    s = torch.linalg.vector_norm(w, keepdim=True)
    c = 0.5 * (R[0, 0:1] + R[1, 1:2] + R[2, 2:3] - 1.0)
    theta = torch.atan2(s, c)
    scale = torch.where(s < 1e-6, torch.ones_like(s),
                        theta / torch.clamp(s, min=1e-12))
    return scale * w


def _retract(T: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """T @ [R(delta[..., :3]) | delta[..., 3:]], a smooth SE(3) chart
    around T; batched over leading dims."""
    if delta.dim() == 1:    # keep rodrigues' angle terms 1-d (above)
        return _retract(T[None], delta[None])[0]
    return T @ se3_matrix(rodrigues(delta[..., :3]), delta[..., 3:])


def _edge_residual(d_i, d_j, T_i, T_j, rel_inv, w):
    """Weighted 6-residual of one edge at local tangents (d_i, d_j)."""
    Ti = _retract(T_i, d_i)
    Tj = _retract(T_j, d_j)
    # E = inv(T_ij_meas) @ inv(T_i) @ T_j ; residual = [log R_E | t_E].
    Ri_t = Ti[:3, :3].T
    pred = se3_matrix(Ri_t @ Tj[:3, :3], Ri_t @ (Tj[:3, 3] - Ti[:3, 3]))
    E = rel_inv @ pred
    return torch.sqrt(w) * torch.cat([_so3_log_stable(E[:3, :3]), E[:3, 3]])


def _edge_val_and_jac(*args):
    """Per-edge residuals (E, 6) and Jacobians ((E, 6, 6), (E, 6, 6)) with
    respect to the two nodes' tangents."""
    def one(*a):
        return (_edge_residual(*a),
                torch.func.jacfwd(_edge_residual, argnums=(0, 1))(*a))

    return torch.func.vmap(one)(*args)


def _edge_terms(nodes, edges, rel_inv, weight):
    """These edges' terms of the normal equations at delta = 0, alone:
    (H (6N, 6N), b (N, 6), cost), no gauge and no damping. An edge shard's
    partial sums (``sharded_posegraph_solve``)."""
    N = nodes.shape[0]
    zero = torch.zeros((edges.shape[0], 6), dtype=nodes.dtype,
                       device=nodes.device)
    ei, ej = edges[:, 0], edges[:, 1]
    r, (Ji, Jj) = _edge_val_and_jac(zero, zero, nodes[ei], nodes[ej], rel_inv,
                                    weight)

    # X[e, b, c] lands at H[6 n[e] + b, 6 m[e] + c]; a node sits in several
    # edges, so the blocks accumulate (index_put_'s accumulating form: on
    # CUDA it sorts the indices and sums in a fixed order, where index_add_
    # adds atomically in any order).
    k = torch.arange(6, device=nodes.device)
    H = torch.zeros((6 * N, 6 * N), dtype=nodes.dtype, device=nodes.device)
    b = torch.zeros((N, 6), dtype=nodes.dtype, device=nodes.device)

    def add_blocks(n, m, X):
        H.index_put_((6 * n[:, None, None] + k[None, :, None],
                      6 * m[:, None, None] + k[None, None, :]), X,
                     accumulate=True)

    add_blocks(ei, ei, torch.einsum("eab,eac->ebc", Ji, Ji))
    add_blocks(ej, ej, torch.einsum("eab,eac->ebc", Jj, Jj))
    add_blocks(ei, ej, torch.einsum("eab,eac->ebc", Ji, Jj))
    add_blocks(ej, ei, torch.einsum("eab,eac->ebc", Jj, Ji))
    b.index_put_((ei,), -torch.einsum("eab,ea->eb", Ji, r), accumulate=True)
    b.index_put_((ej,), -torch.einsum("eab,ea->eb", Jj, r), accumulate=True)
    return H, b, torch.sum(r * r)


def _pin_and_damp(H, b, damping: float):
    """The whole graph's (H, b) with the gauge and the damping, applied
    once: node 0 pinned, then diagonal-relative Levenberg damping."""
    N = b.shape[0]
    # Gauge: pin node 0 (strong prior on its tangent staying zero).
    gauge = torch.arange(6 * N, device=H.device) < 6
    H = H + torch.diag(gauge.to(H.dtype) * 1e6)
    b = torch.cat([torch.zeros_like(b[:1]), b[1:]])
    # Levenberg damping, scale-aware (diagonal-relative).
    H = H + torch.diag(damping * torch.clamp(torch.diagonal(H), min=1e-6))
    return H, b


def _assemble(nodes, edges, rel_inv, weight, damping: float):
    """(H (6N, 6N), b (N, 6), cost) at delta = 0, gauge node 0 pinned."""
    H, b, cost = _edge_terms(nodes, edges, rel_inv, weight)
    H, b = _pin_and_damp(H, b, damping)
    return H, b, cost


def _gn_update(nodes, H, b):
    """Nodes moved by the solve of the pinned, damped system."""
    N = nodes.shape[0]
    delta = torch.linalg.solve_ex(H, b.reshape(6 * N))[0].reshape(N, 6)
    return _retract(nodes, delta)


def _gn_iteration(carry, damping: float):
    """One GN update of (nodes, edges, rel_inv, weight): only the nodes
    change."""
    nodes, edges, rel_inv, weight = carry
    H, b, _ = _assemble(nodes, edges, rel_inv, weight, damping)
    return (_gn_update(nodes, H, b), edges, rel_inv, weight)


@functools.lru_cache(maxsize=8)
def _graphed_solve(damping: float, device: torch.device):
    """The GN update as a graphed fixed-trip loop, one per (damping,
    device) in a process: one capture per (N, E)."""
    return GraphedLoop(functools.partial(_gn_iteration, damping=damping),
                       device)


def posegraph_solve(graph: PoseGraph, iterations: int = 10,
                    damping: float = 1e-4) -> PoseGraph:
    """Damped GN on the pose graph, on the graph's device; returns the
    graph with refined nodes. Node 0 is the gauge and does not move. On a
    card each iteration is one replay of the GN update's CUDA graph,
    captured once per (N, E, damping), bit for bit the eager loop
    (``utils.cudagraph.use_graph`` picks by the graph's device)."""
    carry = (graph.nodes, graph.edges, _se3_inv(graph.rel), graph.weight)
    if use_graph(graph.nodes.device):
        carry = _graphed_solve(float(damping), graph.nodes.device)(
            carry, iterations)
    else:
        for _ in range(iterations):
            carry = _gn_iteration(carry, damping)
    return graph._replace(nodes=carry[0])


def _se3_inv(T: torch.Tensor) -> torch.Tensor:
    """Inverse of (..., 4, 4) rigid transforms."""
    R_t = T[..., :3, :3].transpose(-1, -2)
    return se3_matrix(R_t, -(R_t @ T[..., :3, 3:])[..., 0])


def _sharded_gn_iteration(carry, ax, damping: float):
    """One GN update of the edge-sharded graph: ``carry`` is (the nodes on
    each shard this process holds, each shard's (edges, rel_inv, weight));
    only the nodes change."""
    from visual_odom_tpu_torch.parallel.collectives import psum, replicated

    nodes, local = carry
    H, b, _ = zip(*(_edge_terms(n, *s) for n, s in zip(nodes, local)))
    nodes = replicated(
        ax, lambda n, H, b: _gn_update(n, *_pin_and_damp(H, b, damping)),
        nodes, psum(H, ax), psum(b, ax))
    return tuple(nodes), local


@functools.lru_cache(maxsize=8)
def _graphed_sharded_solve(ax, damping: float, _replay_body: bool = False):
    """The edge-sharded GN update over ``ax`` (a tuple of devices, or an
    NCCL ``RankAxis``) as a graphed fixed-trip loop, one per (axis,
    damping) in a process: one capture per shape."""
    from visual_odom_tpu_torch.parallel.collectives import (graph_devices,
                                                            graph_place)

    return GraphedLoop(functools.partial(_sharded_gn_iteration, ax=ax,
                                         damping=damping),
                       graph_place(ax)[0], _replay_body=_replay_body,
                       devices=graph_devices(ax))


def sharded_posegraph_solve(graph: PoseGraph, mesh, iterations: int = 10,
                            damping: float = 1e-4,
                            axis: str = "model") -> PoseGraph:
    """``posegraph_solve`` with the EDGE axis split over ``mesh``'s
    ``axis`` (``parallel.mesh.mesh_axis``); nodes replicated.

    The edges are padded to a multiple of the axis size with zero-weight
    self-edges on node 0 (exact: weight 0 contributes nothing) and split
    contiguously. Each shard accumulates only its edges' H, b and cost
    (``_edge_terms``); one ``psum`` meets them, and the gauge and the
    damping go on once, after it. The solve and the retraction run on each
    shard's device. Returns the graph, on its own device, with the solved
    nodes; on a mesh of ranks every rank passes the same graph and gets
    the same solved nodes. On a card each iteration replays its CUDA graph
    (``utils.cudagraph.GraphedLoop``: on an axis of one card the whole
    update, across cards in one process each card's graphs in turn, on an
    NCCL rank its own with the all-gathers inside), bit for bit the eager
    loop; gloo ranks iterate eagerly by rule
    (``parallel.collectives.graph_place``)."""
    from visual_odom_tpu_torch.parallel.collectives import (axis_key,
                                                            axis_size, shards,
                                                            use_graph_on)
    from visual_odom_tpu_torch.parallel.mesh import mesh_axis

    ax = mesh_axis(mesh, axis)
    D = axis_size(ax)
    E = graph.edges.shape[0]
    pad = (-E) % D
    dev = graph.nodes.device
    edges = torch.cat([graph.edges, torch.zeros((pad, 2), dtype=graph.edges.dtype,
                                                device=dev)])
    rel = torch.cat([graph.rel, torch.eye(4, dtype=graph.rel.dtype,
                                          device=dev).expand(pad, 4, 4)])
    weight = torch.cat([graph.weight, torch.zeros(pad, dtype=graph.weight.dtype,
                                                  device=dev)])
    rel_inv = _se3_inv(rel)
    per = (E + pad) // D
    mine = shards(ax)
    local = tuple((edges[k * per:(k + 1) * per].to(d),
                   rel_inv[k * per:(k + 1) * per].to(d),
                   weight[k * per:(k + 1) * per].to(d)) for k, d in mine)
    carry = (tuple(graph.nodes.to(d) for _, d in mine), local)
    if use_graph_on(ax):
        carry = _graphed_sharded_solve(axis_key(ax), float(damping))(
            carry, iterations)
    else:
        for _ in range(iterations):
            carry = _sharded_gn_iteration(carry, ax, damping)
    return graph._replace(nodes=carry[0][0].to(dev))


# ---------------------------------------------------------------------------
# Keyframe-graph construction + drift redistribution (host-side numpy glue;
# runs once per loop closure, not in the frame loop).
# ---------------------------------------------------------------------------


def build_keyframe_graph(poses: np.ndarray, keyframe_idx: np.ndarray,
                         loop_edges: list, device=None) -> PoseGraph:
    """Graph over ``keyframe_idx`` (sorted frame indices into ``poses``;
    must include 0), on ``device``: sequential edges carry the chained
    odometry between consecutive keyframes (weight 1), ``loop_edges`` are
    (frame_i, frame_j, T_ij (4, 4), weight) with frame indices snapped to
    keyframes by the caller."""
    dev = resolve_device(device)
    kf = np.asarray(keyframe_idx)
    pos = {int(f): k for k, f in enumerate(kf)}
    nodes = poses[kf].astype(np.float32)
    edges, rels, weights = [], [], []
    inv = np.linalg.inv
    for a, b in zip(kf[:-1], kf[1:]):
        edges.append((pos[int(a)], pos[int(b)]))
        rels.append((inv(poses[a]) @ poses[b]).astype(np.float32))
        weights.append(1.0)
    for (fi, fj, T_ij, w) in loop_edges:
        edges.append((pos[int(fi)], pos[int(fj)]))
        rels.append(np.asarray(T_ij, np.float32))
        weights.append(float(w))
    return PoseGraph(
        nodes=torch.tensor(nodes, device=dev),
        edges=torch.tensor(np.asarray(edges, np.int64), device=dev),
        rel=torch.tensor(np.stack(rels), device=dev),
        weight=torch.tensor(np.asarray(weights, np.float32), device=dev),
    )


def redistribute_poses(poses: np.ndarray, keyframe_idx: np.ndarray,
                       new_kf_poses: np.ndarray) -> np.ndarray:
    """Re-anchor every frame on the refined keyframe chain: frames in
    [kf_k, kf_{k+1}) keep their odometry deltas relative to kf_k; frames
    past the last keyframe ride the last one."""
    out = poses.astype(np.float64).copy()
    kf = np.asarray(keyframe_idx)
    inv = np.linalg.inv
    for k, f in enumerate(kf):
        new_k = np.asarray(new_kf_poses[k], np.float64)
        end = kf[k + 1] if k + 1 < len(kf) else len(poses)
        shift = new_k @ inv(poses[f])
        out[f:end] = np.einsum("ij,fjk->fik", shift, poses[f:end])
    return out
