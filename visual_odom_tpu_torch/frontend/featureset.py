"""Fixed-capacity masked feature state.

Port of ``visual_odom_tpu/frontend/featureset.py``: a fixed number of slots
with a validity mask replaces the reference's erase-based FeatureSet
(``vector<Point2f> points; vector<int> ages``, src/feature.h:33-43).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class FeatureState(NamedTuple):
    """Per-sequence persistent tracked-feature store.

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


def empty_feature_state(capacity: int, device=None) -> FeatureState:
    def zeros(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=device)

    return FeatureState(
        points=zeros(capacity, 2),
        ages=zeros(capacity, dtype=torch.int32),
        valid=zeros(capacity, dtype=torch.bool),
        ids=torch.full((capacity,), -1, dtype=torch.int32, device=device),
        next_id=zeros(dtype=torch.int32),
        flow=zeros(capacity, 2),
        disp=zeros(capacity, 2),
    )
