"""Fixed-capacity masked feature state.

Frozen copy of ``visual_odom_tpu_torch/frontend/featureset.py`` at commit 245329126dfa,
with its imports pointed at this package: the benchmark's yardstick, which
a change to the program must not move. The text below is the original's.

Port of ``visual_odom_tpu/frontend/featureset.py``: a fixed number of slots
with a validity mask replaces the reference's erase-based FeatureSet
(``vector<Point2f> points; vector<int> ages``, src/feature.h:33-43).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class FeatureState(NamedTuple):
    """Per-sequence persistent tracked-feature store. A batched state (B
    sequences in lockstep) has a leading B on every field.

    points:  (N, 2) float32 (x, y) in the current left image.
    ages:    (N,) int32, frames survived.
    valid:   (N,) bool slot liveness mask.
    ids:     (N,) int32 persistent track id, -1 = dead slot.
    next_id: () int32 allocation cursor for fresh detections.
    flow:    (N, 2) float32 last frame-to-frame motion (seeds the temporal
             LK legs; 0 for fresh detections).
    disp:    (N, 2) float32 last stereo offset (seeds the stereo legs).
    """

    points: torch.Tensor
    ages: torch.Tensor
    valid: torch.Tensor
    ids: torch.Tensor
    next_id: torch.Tensor
    flow: torch.Tensor
    disp: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.points.shape[-2]

    def count(self) -> torch.Tensor:
        """Live feature count (reference FeatureSet::size())."""
        return self.valid.sum(dim=-1)

    def take(self, idx: torch.Tensor) -> "FeatureState":
        """The slots ``idx`` of every sequence; the cursor passes through."""
        return self._replace(points=self.points[..., idx, :],
                             ages=self.ages[..., idx],
                             valid=self.valid[..., idx],
                             ids=self.ids[..., idx],
                             flow=self.flow[..., idx, :],
                             disp=self.disp[..., idx, :])


def empty_feature_state(capacity: int, batch: tuple = (),
                        device=None) -> FeatureState:
    """All slots dead; ``batch=(B,)`` gives a batched state."""
    def zeros(*shape, dtype=torch.float32):
        return torch.zeros(tuple(batch) + shape, dtype=dtype, device=device)

    return FeatureState(
        points=zeros(capacity, 2),
        ages=zeros(capacity, dtype=torch.int32),
        valid=zeros(capacity, dtype=torch.bool),
        ids=torch.full(tuple(batch) + (capacity,), -1, dtype=torch.int32,
                       device=device),
        next_id=zeros(dtype=torch.int32),
        flow=zeros(capacity, 2),
        disp=zeros(capacity, 2),
    )
