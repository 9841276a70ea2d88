"""The per-frame step, its CUDA graph and the front doors that drive it."""

from visual_odom_tpu_torch.runner.pipeline import (
    OutputBuffers,
    StepOutput,
    VisualOdometry,
    VOState,
    chain_poses_host,
    make_buffered_step_fn,
    make_step_fn,
    run_sequence,
    run_sequence_buffered,
)
from visual_odom_tpu_torch.utils.cudagraph import GraphedStep

__all__ = [
    "GraphedStep",
    "VisualOdometry",
    "VOState",
    "StepOutput",
    "OutputBuffers",
    "make_step_fn",
    "make_buffered_step_fn",
    "run_sequence",
    "run_sequence_buffered",
    "chain_poses_host",
]
