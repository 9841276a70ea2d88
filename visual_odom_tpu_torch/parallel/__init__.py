"""Several sequences at once on one card or over a device mesh, the
multi-device back end, and the step pipelined over two devices or two
streams of one card. A mesh spans one process's devices or, after
``initialize_distributed``, the ranks of a process group, one per card."""

from visual_odom_tpu_torch.parallel.batch import (batched_init_state,
                                                  make_batched_step_fn)
from visual_odom_tpu_torch.parallel.collectives import (RankAxis, broadcast,
                                                        gather, ppermute,
                                                        psum, replicated)
from visual_odom_tpu_torch.parallel.mesh import (Rank, data_model_mesh,
                                                 initialize_distributed,
                                                 make_mesh, mesh_axis,
                                                 visible_devices)
from visual_odom_tpu_torch.parallel.sharded_ba import sharded_ba_solve

__all__ = [
    "make_mesh",
    "data_model_mesh",
    "initialize_distributed",
    "visible_devices",
    "mesh_axis",
    "Rank",
    "RankAxis",
    "psum",
    "broadcast",
    "ppermute",
    "replicated",
    "gather",
    "make_batched_step_fn",
    "batched_init_state",
    "sharded_ba_solve",
]
