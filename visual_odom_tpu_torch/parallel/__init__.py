"""Several sequences at once on one card or over a device mesh, the
multi-device back end, and the step pipelined over two devices or two
streams of one card."""

from visual_odom_tpu_torch.parallel.batch import (batched_init_state,
                                                  make_batched_step_fn)
from visual_odom_tpu_torch.parallel.mesh import data_model_mesh, make_mesh
from visual_odom_tpu_torch.parallel.sharded_ba import sharded_ba_solve

__all__ = [
    "make_mesh",
    "data_model_mesh",
    "make_batched_step_fn",
    "batched_init_state",
    "sharded_ba_solve",
]
