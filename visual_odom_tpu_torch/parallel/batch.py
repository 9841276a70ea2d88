"""B sequences in lockstep, on one card or over a (data, model) mesh.

Port of ``visual_odom_tpu/parallel/batch.py``. The JAX package vmaps its
step over a leading batch axis and shards it over a device mesh; here the
step is written over the batch dim (``runner.pipeline``), so the batched
step is ``make_step_fn`` given a batched state, and all B sequences share
each launch: 3 quad launches per batched step whatever B is, or 32 level
launches on the per-leg route (``VOConfig.lk_backend="xla"``). Under vmap
the JAX step's adaptive ``lax.cond`` becomes a select; here, too, the fast
and the safe quad run for every sequence and each sequence picks its own
result, so sequence b gets what a single-sequence run of it gets. Sequence
b's RANSAC generator is seeded ``seed + b``, as the JAX package seeds its
keys.

On a mesh (``parallel.mesh.data_model_mesh``), where the JAX package
constrains the state to ``P("data", "model")``:

- "data": the B sequences are split over the data rows in order
  (contiguously; an uneven split is allowed, every row needs one). Row r's
  state, frames and generators live on its first device
  (``MeshState``), and it makes its own batched launches.
- "model": the feature axis's kernel work, the LK quad, is split over the
  row's devices: each quad launch's slots are cut into contiguous slices,
  one launch per device, gathered back in order (bit for bit the unsplit
  quad; ``ops.lk_cuda.lk_circular_quad``). The rest of the step runs on the
  row's first device; the per-leg route is not split.
- The outputs are gathered on the mesh's first device, in sequence order.
- A (1, 1) mesh is the one-device step: the same calls, the same bits.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from visual_odom_tpu_torch import resolve_device
from visual_odom_tpu_torch.config import CameraIntrinsics, VOConfig
from visual_odom_tpu_torch.frontend.featureset import empty_feature_state
from visual_odom_tpu_torch.parallel.mesh import Mesh, split_ranges
from visual_odom_tpu_torch.runner.pipeline import (StepOutput, VOState,
                                                   make_scan_step_fn,
                                                   make_step_fn, prep_image,
                                                   restore_scan_state,
                                                   seeded_generator,
                                                   state_arrays)
from visual_odom_tpu_torch.utils.checkpoint import STATE_KEYS


class MeshState(NamedTuple):
    """A batched state over a mesh's data rows: ``rows[r]`` is row r's
    sequences' batched ``VOState``, on the row's first device."""

    rows: tuple


def _placement(device, mesh: Mesh):
    """(device, None) where the work runs on one device (no mesh, or a
    one-device mesh: the one-device step, the same calls); (None, the
    (data, model) device grid) on a mesh of several."""
    if mesh is None:
        return device, None
    if mesh.size == 1:
        return mesh.devices.flat[0], None
    if mesh.axis_names != ("data", "model"):
        raise ValueError(f"the batched step takes a (data, model) mesh, got "
                         f"axes {mesh.axis_names}")
    return None, mesh.devices


def _row_ranges(batch: int, grid) -> list:
    """Each data row's contiguous range of the B sequences."""
    if batch < len(grid):
        raise ValueError(f"{batch} sequences over {len(grid)} data rows: "
                         f"every row needs a sequence")
    return split_ranges(batch, len(grid))


def _rows(x, ranges):
    return [x[a:b] for a, b in ranges]


def make_batched_step_fn(config: VOConfig, intrinsics: CameraIntrinsics,
                         device=None, mesh: Mesh = None):
    """``step(state, lefts (B, H, W), rights (B, H, W), uniforms=None) ->
    (state, StepOutput with a leading B on every field)``; ``uniforms``
    (B, iterations, padded_features) replaces the RANSAC draws. On a
    ``mesh`` of more than one device the state is a ``MeshState`` and the
    outputs come back on the mesh's first device."""
    device, grid = _placement(device, mesh)
    if grid is None:
        return make_step_fn(config, intrinsics, device=device)
    home = grid[0, 0]
    steps = [make_step_fn(config, intrinsics, device=row[0],
                          slot_devices=list(row) if len(row) > 1 else None)
             for row in grid]

    def step(state: MeshState, lefts, rights, uniforms=None):
        ranges = _row_ranges(lefts.shape[0], grid)
        us = (_rows(uniforms, ranges) if uniforms is not None
              else [None] * len(ranges))
        new, outs = [], []
        for fn, st, row, l, r, u in zip(steps, state.rows, grid,
                                        _rows(lefts, ranges),
                                        _rows(rights, ranges), us):
            st, out = fn(st, l, r, None if u is None else u.to(row[0]))
            new.append(st)
            outs.append(out)
        return MeshState(tuple(new)), StepOutput(
            *(torch.cat([x.to(home) for x in xs]) for xs in zip(*outs)))

    return step


def make_batched_scan_fn(config: VOConfig, intrinsics: CameraIntrinsics,
                         chunk: int, device=None, mesh: Mesh = None):
    """``scan(state, lefts (chunk, B, H, W), rights (chunk, B, H, W)) ->
    (state, StepOutput stacked (chunk, B, ...))``: the chunk is uploaded
    in one copy (to the mesh's first device; each row's frames go on from
    there) and stepped frame by frame; the outputs stay on the device."""
    device, grid = _placement(device, mesh)
    if grid is None:
        scan_chunk = make_scan_step_fn(config, intrinsics, device=device)
    else:
        step = make_batched_step_fn(config, intrinsics, mesh=mesh)

        def scan_chunk(state, lefts, rights):
            dl = torch.as_tensor(lefts).to(grid[0, 0])
            dr = torch.as_tensor(rights).to(grid[0, 0])
            outs = []
            for i in range(dl.shape[0]):
                state, out = step(state, dl[i], dr[i])
                outs.append(out)
            return state, StepOutput(*(torch.stack(x) for x in zip(*outs)))

    def scan(state, lefts, rights):
        if lefts.shape[0] != chunk or rights.shape[0] != chunk:
            raise ValueError(f"scan takes chunks of {chunk} frames, got "
                             f"{lefts.shape[0]} and {rights.shape[0]}")
        return scan_chunk(state, lefts, rights)

    return scan


def batched_init_state(config: VOConfig, lefts, rights, seed: int = 0,
                       device=None, mesh: Mesh = None):
    """Batched state from (B, H, W) first frames: no features, their
    pyramids, zero warm starts and sequence b's generator seeded
    ``seed + b`` (on its row's device, on a mesh)."""
    device, grid = _placement(device, mesh)
    if grid is not None:
        ranges = _row_ranges(lefts.shape[0], grid)
        return MeshState(tuple(
            batched_init_state(config, l, r, seed=seed + a, device=row[0])
            for (a, _), l, r, row in zip(ranges, _rows(lefts, ranges),
                                         _rows(rights, ranges), grid)))
    dev = resolve_device(device)
    B = lefts.shape[0]
    return VOState(
        features=empty_feature_state(config.padded_features, batch=(B,),
                                     device=dev),
        lk_l0=prep_image(lefts, config, dev),
        lk_r0=prep_image(rights, config, dev),
        tvec=torch.zeros((B, 3), dtype=torch.float32, device=dev),
        generator=tuple(seeded_generator(seed + b, dev) for b in range(B)))


def batched_state_arrays(state) -> dict:
    """``runner.pipeline.state_arrays`` of a batched state or a
    ``MeshState`` (its rows' arrays concatenated in sequence order)."""
    if not isinstance(state, MeshState):
        return state_arrays(state)
    rows = [state_arrays(s) for s in state.rows]
    return {k: np.concatenate([r[k] for r in rows]) for k in rows[0]}


def restore_batched_state(config: VOConfig, ckpt: dict, lefts, rights,
                          device=None, mesh: Mesh = None):
    """Batched state from a snapshot's stacked arrays and the checkpointed
    frame's (B, H, W) images: the pyramids are rebuilt from them and
    sequence b's generator takes row b of ``gen_state`` on ``device``; on
    a mesh, each data row takes its sequences' rows on its first device."""
    device, grid = _placement(device, mesh)
    if grid is None:
        return restore_scan_state(config, None, ckpt, lefts, rights,
                                  device=device)
    ranges = _row_ranges(lefts.shape[0], grid)
    return MeshState(tuple(
        restore_scan_state(config, None, {k: np.asarray(ckpt[k])[a:b]
                                          for k in STATE_KEYS},
                           l, r, device=row[0])
        for (a, b), l, r, row in zip(ranges, _rows(lefts, ranges),
                                     _rows(rights, ranges), grid)))
