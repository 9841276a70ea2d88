"""B sequences in lockstep on one card.

Port of ``visual_odom_tpu/parallel/batch.py``. The JAX package vmaps its
step over a leading batch axis and shards that axis over a device mesh;
here the step is written over the batch dim (``runner.pipeline``), so the
batched step is ``make_step_fn`` given a batched state, and all B sequences
share each launch: 3 quad launches per batched step whatever B is, or 32
level launches on the per-leg route (``VOConfig.lk_backend="xla"``).
Under vmap the JAX step's adaptive ``lax.cond`` becomes a select; here,
too, the fast and the safe quad run for every sequence and each sequence
picks its own result, so sequence b gets what a single-sequence run of it
gets. Sequence b's RANSAC generator is seeded ``seed + b``, as the JAX
package seeds its keys. The mesh and the model-axis sharding wait for the
multi-device port; these take a device instead, CUDA by default.
"""

from __future__ import annotations

import torch

from visual_odom_tpu_torch import resolve_device
from visual_odom_tpu_torch.config import CameraIntrinsics, VOConfig
from visual_odom_tpu_torch.frontend.featureset import empty_feature_state
from visual_odom_tpu_torch.runner.pipeline import (VOState, make_scan_step_fn,
                                                   make_step_fn, prep_image,
                                                   seeded_generator)


def make_batched_step_fn(config: VOConfig, intrinsics: CameraIntrinsics,
                         device=None):
    """``step(state, lefts (B, H, W), rights (B, H, W), uniforms=None) ->
    (state, StepOutput with a leading B on every field)``; ``uniforms``
    (B, iterations, padded_features) replaces the RANSAC draws."""
    return make_step_fn(config, intrinsics, device=device)


def make_batched_scan_fn(config: VOConfig, intrinsics: CameraIntrinsics,
                         chunk: int, device=None):
    """``scan(state, lefts (chunk, B, H, W), rights (chunk, B, H, W)) ->
    (state, StepOutput stacked (chunk, B, ...))``: each chunk is uploaded
    in one copy and stepped frame by frame; the outputs stay on the
    device."""
    scan_chunk = make_scan_step_fn(config, intrinsics, device=device)

    def scan(state: VOState, lefts, rights):
        if lefts.shape[0] != chunk or rights.shape[0] != chunk:
            raise ValueError(f"scan takes chunks of {chunk} frames, got "
                             f"{lefts.shape[0]} and {rights.shape[0]}")
        return scan_chunk(state, lefts, rights)

    return scan


def batched_init_state(config: VOConfig, lefts, rights, seed: int = 0,
                       device=None) -> VOState:
    """Batched state from (B, H, W) first frames: no features, their
    pyramids, zero warm starts and sequence b's generator seeded
    ``seed + b``."""
    dev = resolve_device(device)
    B = lefts.shape[0]
    return VOState(
        features=empty_feature_state(config.padded_features, batch=(B,),
                                     device=dev),
        lk_l0=prep_image(lefts, config, dev),
        lk_r0=prep_image(rights, config, dev),
        tvec=torch.zeros((B, 3), dtype=torch.float32, device=dev),
        generator=tuple(seeded_generator(seed + b, dev) for b in range(B)))
