"""Image operators: pyramids, FAST and the LK trackers (the circular quad and
the per-leg ``lk_track_pyramid``)."""

from visual_odom_tpu_torch.ops.fast import fast_corners, fast_score_map
from visual_odom_tpu_torch.ops.lk import LKParams, lk_track, lk_track_pyramid
from visual_odom_tpu_torch.ops.pyramid import (build_pyramid, pyr_down,
                                               scharr_derivatives)

__all__ = ["pyr_down", "build_pyramid", "scharr_derivatives",
           "fast_score_map", "fast_corners", "lk_track_pyramid", "lk_track",
           "LKParams"]
