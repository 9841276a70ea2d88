"""State carry from the JAX package's pipeline into the port's.

This system has no weights; its state is what a run carries from frame to
frame. ``state_from_numpy`` rebuilds the port's ``VOState`` from the JAX
package's ``VOState`` turned into numpy arrays, so both pipelines can be
started from one mid-sequence state and compared step by step. The back
end's inputs come across the same way: ``track_snapshots_from_numpy`` (a
run's per-frame track snapshots), ``ba_problem_from_numpy`` (a windowed BA
problem) and ``pose_graph_from_numpy`` (a keyframe pose graph), so that
both packages solve the same problem.
"""

from __future__ import annotations

import numpy as np
import torch

from visual_odom_tpu_torch import resolve_device
from visual_odom_tpu_torch.ba.posegraph import PoseGraph
from visual_odom_tpu_torch.ba.problem import BAProblem
from visual_odom_tpu_torch.frontend.featureset import FeatureState
from visual_odom_tpu_torch.ops.lk import LKImage
from visual_odom_tpu_torch.runner.pipeline import (TrackSnapshot, VOState,
                                                   seeded_generator)


def state_from_numpy(d: dict, seed: int = 0, device=None) -> VOState:
    """Build a port ``VOState`` from a mapping of numpy arrays.

    ``d`` holds
      - "features": a mapping with the FeatureState fields (points, ages,
        valid, ids, next_id, flow, disp);
      - "lk_l0", "lk_r0": mappings with "pyramid" (the padded, aligned
        planes, level 0 first), "shapes" ((rows, cols) per level) and "pad";
      - "tvec": (3,) warm-start translation.
    The RANSAC generator is seeded with ``seed`` (the JAX key has no
    counterpart). A batched JAX state (a leading B on every array) gives a
    batched port state whose sequence b draws from ``seed + b``.
    """
    dev = resolve_device(device)

    def t(x, dtype):
        return torch.tensor(np.asarray(x), dtype=dtype, device=dev)

    f = d["features"]
    features = FeatureState(
        points=t(f["points"], torch.float32), ages=t(f["ages"], torch.int32),
        valid=t(f["valid"], torch.bool), ids=t(f["ids"], torch.int32),
        next_id=t(f["next_id"], torch.int32), flow=t(f["flow"], torch.float32),
        disp=t(f["disp"], torch.float32))

    def image(m):
        return LKImage(
            pyramid=tuple(t(p, torch.float32).contiguous() for p in m["pyramid"]),
            shapes=tuple((int(r), int(c)) for r, c in m["shapes"]),
            pad=int(m["pad"]))

    if features.points.dim() == 3:
        gen = tuple(seeded_generator(seed + b, dev)
                    for b in range(features.points.shape[0]))
    else:
        gen = seeded_generator(seed, dev)
    return VOState(features=features, lk_l0=image(d["lk_l0"]),
                   lk_r0=image(d["lk_r0"]), tvec=t(d["tvec"], torch.float32),
                   generator=gen)


def track_snapshots_from_numpy(snapshots) -> list:
    """The port's numpy ``TrackSnapshot`` list, as ``smooth_trajectory_ba``
    takes it, from the JAX package's per-frame snapshots (NamedTuples with
    the fields points_l0, points_r0, points_l1, points_r1, ids, valid)."""
    return [TrackSnapshot(**{k: np.asarray(v) for k, v in s._asdict().items()})
            for s in snapshots]


def ba_problem_from_numpy(d: dict, device=None) -> BAProblem:
    """A port ``BAProblem`` on ``device`` from a mapping of the BAProblem
    fields: poses (W, 6), landmarks (L, 3), observations (W, L, 3), mask
    (W, L) and the floats fx, fy, cx, cy, bf."""
    dev = resolve_device(device)

    def t(k, dtype=torch.float32):
        return torch.tensor(np.asarray(d[k]), dtype=dtype, device=dev)

    return BAProblem(poses=t("poses"), landmarks=t("landmarks"),
                     observations=t("observations"),
                     mask=t("mask", torch.bool),
                     **{k: float(d[k]) for k in ("fx", "fy", "cx", "cy", "bf")})


def pose_graph_from_numpy(d: dict, device=None) -> PoseGraph:
    """A port ``PoseGraph`` on ``device`` from a mapping of the PoseGraph
    fields: nodes (N, 4, 4), edges (E, 2), rel (E, 4, 4), weight (E,)."""
    dev = resolve_device(device)

    def t(k, dtype=torch.float32):
        return torch.tensor(np.asarray(d[k]), dtype=dtype, device=dev)

    return PoseGraph(nodes=t("nodes"), edges=t("edges", torch.int64),
                     rel=t("rel"), weight=t("weight"))
