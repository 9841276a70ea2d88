"""Evaluation: KITTI devkit scoring and artifacts, trajectory and track
rendering."""

from visual_odom_tpu_torch.eval.kitti_eval import (SegmentError,
                                                   ate_rmse, average_errors,
                                                   calc_sequence_errors,
                                                   evaluate_sequence,
                                                   rpe_errors,
                                                   trajectory_distances)

__all__ = [
    "SegmentError",
    "trajectory_distances",
    "calc_sequence_errors",
    "average_errors",
    "ate_rmse",
    "rpe_errors",
    "evaluate_sequence",
]
