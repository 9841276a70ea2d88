"""State carry from the JAX package's pipeline into the port's.

This system has no weights; its state is what a run carries from frame to
frame. ``state_from_numpy`` rebuilds the port's ``VOState`` from the JAX
package's ``VOState`` turned into numpy arrays, so both pipelines can be
started from one mid-sequence state and compared step by step.
"""

from __future__ import annotations

import numpy as np
import torch

from visual_odom_tpu_torch import resolve_device
from visual_odom_tpu_torch.frontend.featureset import FeatureState
from visual_odom_tpu_torch.ops.lk import LKImage
from visual_odom_tpu_torch.runner.pipeline import VOState


def state_from_numpy(d: dict, seed: int = 0, device=None) -> VOState:
    """Build a port ``VOState`` from a mapping of numpy arrays.

    ``d`` holds
      - "features": a mapping with the FeatureState fields (points, ages,
        valid, ids, next_id, flow, disp);
      - "lk_l0", "lk_r0": mappings with "pyramid" (the padded, aligned
        planes, level 0 first), "shapes" ((rows, cols) per level) and "pad";
      - "tvec": (3,) warm-start translation.
    The RANSAC generator is seeded with ``seed`` (the JAX key has no
    counterpart).
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

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return VOState(features=features, lk_l0=image(d["lk_l0"]),
                   lk_r0=image(d["lk_r0"]), tvec=t(d["tvec"], torch.float32),
                   generator=gen)
