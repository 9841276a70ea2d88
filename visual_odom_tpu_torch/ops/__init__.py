"""Image operators: pyramids, FAST and the LK trackers (the circular quad and
the per-leg ``lk_track_pyramid``)."""

from visual_odom_tpu_torch.ops.lk import LKParams, lk_track, lk_track_pyramid

__all__ = ["lk_track_pyramid", "lk_track", "LKParams"]
