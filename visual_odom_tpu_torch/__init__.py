"""PyTorch/CUDA port of the stereo visual-odometry pipeline.

The package mirrors ``visual_odom_tpu`` module for module (``config``,
``ops``, ``frontend``, ``core``, ``backend``, ``runner``, ``io``) but imports
only ``torch`` and ``numpy``. Plain tensor code is PyTorch; the LK solves
(the JAX package's Pallas ``_legs_kernel``, the circular quad, and
``_level_kernel``, one level of one leg) are CUDA C++ kernels for Hopper
(``csrc/lk_legs.cu``), built from source at first use.

Precision is fixed here, once for the whole package: float32 everywhere, and
TF32 off for both matmuls and cuDNN convolutions (the JAX reference computes
at ``Precision.HIGHEST``).

Entry points (``runner.pipeline``): ``init_vo_state`` and ``make_step_fn``;
the front doors ``run_sequence_scan`` (with ``preupload``,
``upload_threads`` and ``stats_out``), ``run_sequence_scan_resumable``,
``VisualOdometry``, ``run_sequence``, ``run_sequence_resumable`` and
``run_sequence_buffered``; ``parallel.batch_eval.run_sequences_batched``
for B sequences in lockstep; ``parallel.pipe.run_sequence_pipelined``, the
step in two stages on two devices or two streams of one card; and the
command line, ``python -m visual_odom_tpu_torch.runner.cli``. They run on
CUDA unless the caller passes ``device="cpu"`` (``--device cpu``); without
a card and without that request they raise.
"""

from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA by default, the CPU only when
    the caller names it. Raises when CUDA is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "visual_odom_tpu_torch runs on CUDA by default and no CUDA device "
            "is available; pass device='cpu' to run the plain PyTorch path")
    return dev
