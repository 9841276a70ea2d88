"""Distributed windowed bundle adjustment: landmark-sharded Schur reduction.

Port of ``visual_odom_tpu/parallel/sharded_ba.py``. The reduced camera
system

    S   = Hpp - sum_l  Hpl_l Hll_l^-1 Hpl_l'
    rhs = bp  - sum_l  Hpl_l Hll_l^-1 bl_l

is a sum over LANDMARKS, so with the landmark axis split over the mesh's
"model" devices each shard contracts its own landmarks
(``ba.schur.schur_parts``) and one ``psum`` per GN iteration meets the
four sums (``parallel.collectives``; the JAX package gets the same
collective from a sharding constraint). The small dense solve of S (6W x
6W) is replicated on every shard's device, with damping and the gauge
prior applied once after the sum (``ba.schur.solve_reduced``); landmark
back-substitution is local to each shard. Communication per GN iteration:
(W, 6, 6), (W, 6), (W, W, 6, 6) and (W, 6) floats and one flag per shard,
independent of L.

On a card the GN iteration is captured once as a CUDA graph and replayed
per iteration (``utils.cudagraph.GraphedLoop``), the counterpart of the
JAX package's ``jit`` of a ``lax.scan`` over the iterations: on an axis of
one card (named once per shard) the whole iteration, on an axis across
cards in one process each card's graphs in turn, cut at the ``psum``'s
copies between cards (``utils.cudagraph._Recording``), on an NCCL rank
(in a world of any size) the rank's iteration with its all-gathers
inside. Gloo ranks iterate eagerly by rule
(``parallel.collectives.graph_place``).
"""

from __future__ import annotations

import functools

import torch

from visual_odom_tpu_torch.ba.problem import BAProblem
from visual_odom_tpu_torch.ba.schur import (SchurParts, back_substitute,
                                            schur_parts, solve_reduced)
from visual_odom_tpu_torch.parallel.collectives import (axis_key, axis_size,
                                                        gather, graph_devices,
                                                        graph_place,
                                                        psum, replicated,
                                                        shards, use_graph_on)
from visual_odom_tpu_torch.parallel.mesh import (Mesh, mesh_axis,
                                                 split_ranges)
from visual_odom_tpu_torch.utils.cudagraph import GraphedLoop


def _gn_iteration(local, ax, damping: float):
    """One GN iteration of every shard this process holds (a tuple of
    landmark-sharded ``BAProblem``s): the Schur sums met by ``psum``, the
    reduced solve replicated, the landmarks back-substituted locally."""
    parts, blocks = zip(*(schur_parts(s, damping) for s in local))
    summed = [SchurParts(*xs) for xs in zip(
        *(psum([getattr(p, k) for p in parts], ax)
          for k in SchurParts._fields))]
    dp = replicated(ax, lambda S, poses: solve_reduced(S, poses, damping),
                    summed, [s.poses for s in local])
    dx = [back_substitute(b, d) for b, d in zip(blocks, dp)]
    # shards with a non-finite update, counted on every device
    bad = psum([(~(torch.isfinite(d).all() & torch.isfinite(x).all()))
                .to(torch.int32) for d, x in zip(dp, dx)], ax)
    return tuple(s._replace(
        poses=torch.where(n > 0, s.poses, s.poses - d),
        landmarks=torch.where(n > 0, s.landmarks, s.landmarks - x))
        for s, d, x, n in zip(local, dp, dx, bad))


@functools.lru_cache(maxsize=8)
def _graphed_solve(ax, damping: float, _replay_body: bool = False):
    """The GN iteration over ``ax`` (``axis_key``) as a graphed fixed-trip
    loop, one per (axis, damping) in a process: one capture per shape."""
    return GraphedLoop(functools.partial(_gn_iteration, ax=ax,
                                         damping=damping),
                       graph_place(ax)[0], _replay_body=_replay_body,
                       devices=graph_devices(ax))


def sharded_ba_solve(problem: BAProblem, mesh: Mesh, iterations: int = 10,
                     damping: float = 1e-4) -> BAProblem:
    """GN bundle adjustment with the landmark axis sharded over the mesh's
    "model" axis (an uneven split is allowed); poses replicated.

    The same iteration as ``ba.schur.ba_solve``: with one shard it is
    ``ba_solve`` bit for bit, with more the landmark sums are added in
    another order. The non-finite guard is global: a non-finite update on
    any shard leaves every shard's poses and landmarks where they were.
    Returns the problem, on its own device, with the solved poses and
    landmarks. On a mesh of ranks every rank passes the same problem,
    solves its own landmarks and returns the whole solved problem, the
    same bits on each (the landmarks all-gathered). On a card each
    iteration replays its CUDA graph (see the module docstring), bit for
    bit the eager loop."""
    ax = mesh_axis(mesh, "model")
    home = problem.poses.device
    ranges = split_ranges(problem.landmarks.shape[0], axis_size(ax))
    local = []
    for k, d in shards(ax):
        a, b = ranges[k]
        local.append(problem._replace(
            poses=problem.poses.to(d), landmarks=problem.landmarks[a:b].to(d),
            observations=problem.observations[:, a:b].to(d),
            mask=problem.mask[:, a:b].to(d)))
    local = tuple(local)
    if use_graph_on(ax):
        local = _graphed_solve(axis_key(ax), float(damping))(local,
                                                             iterations)
    else:
        for _ in range(iterations):
            local = _gn_iteration(local, ax, damping)
    landmarks = gather([s.landmarks for s in local], ax,
                       sizes=[b - a for a, b in ranges])
    return problem._replace(
        poses=local[0].poses.to(home),
        landmarks=torch.cat([x.to(home) for x in landmarks]))
