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
- "model": the feature axis's kernel work, the LK launches of either
  route, is split over the row's devices: each launch's slots are cut into
  contiguous slices, one launch per device, gathered back in order (bit
  for bit the unsplit launch; ``ops.lk_cuda.split_slots``). The rest of
  the step runs on the row's first device.
- The outputs are gathered on the mesh's first device, in sequence order.
- A (1, 1) mesh is the one-device step: the same calls, the same bits.

On a mesh of ranks (``parallel.mesh.Rank``, one process per position)
every rank passes the same frames and steps its own data row, the rows
split as above:

- each rank of a row holds the row's whole batched state, replicated over
  "model" as JAX's ``P("data", "model")`` replicates everything but the
  feature axis, with the row's generators seeded ``seed + b``; the
  ``MeshState`` of a rank holds its row alone;
- only the LK launches' slots are split over the row's "model" ranks:
  each rank launches its slice and an all-gather over the row's group puts
  the slots back in order;
- the outputs of every sequence come back on every rank, all-gathered over
  its "data" group (once per step, or once per chunk of the scan).

On a card each row replays its step's CUDA graph (``utils.cudagraph``), as
the JAX package jits its sharded step and scans it over a chunk: a row of
one device replays the one-card batched step's graph (shared with the
single-sequence doors); a row of one card named several times, the graph
of its split step (``_graphed_split_step``); a row across distinct
cards in one process, the graphs of its split step on each card in turn,
cut at the copies between cards (``utils.cudagraph._Recording``); an
NCCL rank, the graph of its row's split step with the model group's
all-gather inside (the data group's all-gather of the outputs stays
outside it). Every row's replay is issued before any output moves to the
home device, so that rows on different cards overlap. A rank over gloo
steps eagerly by rule (``parallel.collectives.graph_place``), as does a
call given ``uniforms``.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from visual_odom_tpu_torch import resolve_device
from visual_odom_tpu_torch.config import CameraIntrinsics, VOConfig
from visual_odom_tpu_torch.frontend.featureset import empty_feature_state
from visual_odom_tpu_torch.parallel.collectives import (RankAxis, gather,
                                                        graph_devices,
                                                        graph_place,
                                                        use_graph_on)
from visual_odom_tpu_torch.parallel.mesh import (Mesh, mesh_axis, position,
                                                 split_ranges)
from visual_odom_tpu_torch.runner.pipeline import (StepOutput, VOState,
                                                   _graphed_step,
                                                   make_scan_step_fn,
                                                   make_step_fn, prep_image,
                                                   restore_scan_state,
                                                   seeded_generator,
                                                   state_arrays)
from visual_odom_tpu_torch.utils.checkpoint import STATE_KEYS
from visual_odom_tpu_torch.utils.cudagraph import GraphedStep


class MeshState(NamedTuple):
    """A batched state over a mesh's data rows: ``rows[r]`` is row r's
    sequences' batched ``VOState``, on the row's first device. On a mesh of
    ranks it holds the rank's own row alone."""

    rows: tuple


class _RankRow(NamedTuple):
    """This rank's place on a (data, model) mesh of ranks."""

    row: int           # its data row
    rows: int          # the number of data rows
    device: torch.device
    model: object      # RankAxis of its row's model ranks
    data: object       # RankAxis of its column's data ranks

    def ranges(self, batch: int) -> list:
        """Every data row's range of the B sequences."""
        return _row_ranges(batch, range(self.rows))


def _rank_row(mesh: Mesh) -> _RankRow:
    """This rank's row, device and groups; the groups are made once per
    mesh, by every rank together (``mesh_axis``)."""
    if mesh.axis_names != ("data", "model"):
        raise ValueError(f"the batched step takes a (data, model) mesh, got "
                         f"axes {mesh.axis_names}")
    r, c = position(mesh)
    return _RankRow(r, mesh.devices.shape[0], mesh.devices[r, c].device,
                    mesh_axis(mesh, "model"), mesh_axis(mesh, "data"))


def _gather_rows(out, ranges, me: _RankRow, dim: int = 0):
    """Every sequence's outputs from this rank's row's: each field
    all-gathered over the data group along its batch ``dim``."""
    sizes = [b - a for a, b in ranges]
    return type(out)(*(torch.cat(
        gather([x.movedim(dim, 0)], me.data, sizes=sizes)).movedim(0, dim)
        for x in out))


def _ranked(mesh) -> bool:
    """Whether ``mesh`` is a mesh of ranks."""
    return mesh is not None and mesh.ranks is not None


def _placement(device, mesh: Mesh):
    """(device, None) where the work runs on one device (no mesh, or a
    one-device mesh: the one-device step, the same calls); (None, the
    (data, model) device grid) on a mesh of several devices."""
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


@functools.lru_cache(maxsize=8)
def _graphed_split_step(config: VOConfig, intrinsics: CameraIntrinsics,
                        slots, _replay_body: bool = False) -> GraphedStep:
    """The batched step of a mesh row whose LK launches split their slots
    over ``slots`` (a tuple of devices: one card named several times, or
    distinct cards; or this rank's NCCL model ``RankAxis``) as a
    ``GraphedStep``, one per (config, intrinsics, slots) in a process."""
    dev = graph_place(slots)[0]
    return GraphedStep(make_step_fn(
        config, intrinsics, device=dev,
        slot_devices=slots if isinstance(slots, RankAxis) else list(slots)),
        dev, _replay_body=_replay_body, devices=graph_devices(slots))


class _Row(NamedTuple):
    """A mesh row's step: eager, and its ``GraphedStep`` where it replays
    one (None where it steps eagerly)."""

    device: torch.device
    eager: object
    graphed: object

    def step(self, state, lefts, rights, uniforms=None):
        """One batched step of the row's sequences; ``uniforms`` steps
        eagerly."""
        if self.graphed is None or uniforms is not None:
            return self.eager(state, lefts, rights, None if uniforms is None
                              else uniforms.to(self.device))
        return self.graphed(state, lefts, rights)

    def scan(self, state, lefts, rights):
        """k steps of the row's sequences, (k, B_row, H, W) frames ->
        (state, StepOutput stacked (k, B_row, ...))."""
        if self.graphed is not None:
            return self.graphed.scan(state, lefts, rights)
        dl, dr = lefts.to(self.device), rights.to(self.device)
        outs = []
        for i in range(dl.shape[0]):
            state, out = self.eager(state, dl[i], dr[i])
            outs.append(out)
        return state, StepOutput(*(torch.stack(x) for x in zip(*outs)))

    def capture(self, state, lefts, rights) -> None:
        """Capture the row's graph for ``state`` and these frames now."""
        if self.graphed is not None:
            self.graphed.capture(state, lefts, rights)


def _row(config, intrinsics, slots) -> _Row:
    """The step of a mesh row whose LK slots split over ``slots`` (a tuple
    of the row's devices, or this rank's model ``RankAxis``); a row of one
    device replays the one-card batched step's graph."""
    dev = graph_place(slots)[0]
    one = not isinstance(slots, RankAxis) and len(slots) == 1
    eager = make_step_fn(config, intrinsics, device=dev,
                         slot_devices=None if one else slots)
    graphed = None
    if use_graph_on(slots):
        graphed = (_graphed_step(config, intrinsics, False, dev) if one
                   else _graphed_split_step(config, intrinsics, slots))
    return _Row(dev, eager, graphed)


def make_batched_step_fn(config: VOConfig, intrinsics: CameraIntrinsics,
                         device=None, mesh: Mesh = None):
    """``step(state, lefts (B, H, W), rights (B, H, W), uniforms=None) ->
    (state, StepOutput with a leading B on every field)``; ``uniforms``
    (B, iterations, padded_features) replaces the RANSAC draws. On a
    ``mesh`` of more than one device the state is a ``MeshState`` and the
    outputs come back on the mesh's first device; on a mesh of ranks, on
    every rank's own device.

    On a card each call replays CUDA graphs, bit for bit the eager step:
    one card, the batched step's (``utils.cudagraph.GraphedStep``, shared
    with the single-sequence doors and the scan); a mesh, each row's (see
    the module docstring). A call given ``uniforms`` (the parity tests)
    steps eagerly, as do the CPU and the ranks that
    ``parallel.collectives.graph_place`` keeps eager by rule.
    ``step.capture(state, lefts, rights)`` captures the graphs ahead of
    the first step (a no-op where the step is eager)."""
    if _ranked(mesh):
        me = _rank_row(mesh)
        row = _row(config, intrinsics, me.model)

        def mine(x, ranges):
            a, b = ranges[me.row]
            return None if x is None else x[a:b].to(me.device)

        def rank_step(state: MeshState, lefts, rights, uniforms=None):
            ranges = me.ranges(lefts.shape[0])
            st, out = row.step(state.rows[0], mine(lefts, ranges),
                               mine(rights, ranges), mine(uniforms, ranges))
            return MeshState((st,)), _gather_rows(out, ranges, me)

        def capture(state: MeshState, lefts, rights):
            ranges = me.ranges(lefts.shape[0])
            row.capture(state.rows[0], *(torch.as_tensor(x)[slice(
                *ranges[me.row])] for x in (lefts, rights)))

        rank_step.capture = capture
        return rank_step
    device, grid = _placement(device, mesh)
    if grid is None:
        row = _row(config, intrinsics, (resolve_device(device),))

        def one_card_step(state, lefts, rights, uniforms=None):
            return row.step(state, lefts, rights, uniforms)

        one_card_step.capture = row.capture
        return one_card_step
    home = grid[0, 0]
    rows = [_row(config, intrinsics, tuple(r)) for r in grid]

    def step(state: MeshState, lefts, rights, uniforms=None):
        ranges = _row_ranges(lefts.shape[0], grid)
        us = (_rows(uniforms, ranges) if uniforms is not None
              else [None] * len(ranges))
        new, outs = [], []
        for row, st, l, r, u in zip(rows, state.rows, _rows(lefts, ranges),
                                    _rows(rights, ranges), us):
            st, out = row.step(st, l, r, u)
            new.append(st)
            outs.append(out)
        return MeshState(tuple(new)), StepOutput(
            *(torch.cat([x.to(home) for x in xs]) for xs in zip(*outs)))

    def capture(state: MeshState, lefts, rights):
        lefts, rights = torch.as_tensor(lefts), torch.as_tensor(rights)
        ranges = _row_ranges(lefts.shape[0], grid)
        for row, st, l, r in zip(rows, state.rows, _rows(lefts, ranges),
                                 _rows(rights, ranges)):
            row.capture(st, l, r)

    step.capture = capture
    return step


def make_batched_scan_fn(config: VOConfig, intrinsics: CameraIntrinsics,
                         chunk: int, device=None, mesh: Mesh = None):
    """``scan(state, lefts (chunk, B, H, W), rights (chunk, B, H, W)) ->
    (state, StepOutput stacked (chunk, B, ...))``: the chunk is uploaded
    in one copy (to the mesh's first device; each row's frames go on from
    there) and stepped frame by frame; the outputs stay on the device. On
    a card each step is a replay of a CUDA graph: the batched step's on
    one card (``runner.pipeline.make_scan_step_fn``), each row's on a mesh
    (every row's chunk issued before any output moves to the first
    device). On a mesh of ranks each rank uploads its row's frames to its
    device and gathers the chunk's outputs over its data group once."""
    if _ranked(mesh):
        me = _rank_row(mesh)
        row = _row(config, intrinsics, me.model)

        def scan_chunk(state, lefts, rights):
            ranges = me.ranges(lefts.shape[1])
            a, b = ranges[me.row]
            st, out = row.scan(state.rows[0], *(
                torch.as_tensor(x[:, a:b]).to(me.device)
                for x in (lefts, rights)))
            return MeshState((st,)), _gather_rows(out, ranges, me, dim=1)
    else:
        device, grid = _placement(device, mesh)
        if grid is None:
            scan_chunk = make_scan_step_fn(config, intrinsics, device=device)
        else:
            home = grid[0, 0]
            rows = [_row(config, intrinsics, tuple(r)) for r in grid]

            def scan_chunk(state, lefts, rights):
                dl = torch.as_tensor(lefts).to(home)
                dr = torch.as_tensor(rights).to(home)
                ranges = _row_ranges(dl.shape[1], grid)
                new, outs = [], []
                for row, st, (a, b) in zip(rows, state.rows, ranges):
                    st, out = row.scan(st, dl[:, a:b], dr[:, a:b])
                    new.append(st)
                    outs.append(out)
                return MeshState(tuple(new)), StepOutput(*(
                    torch.cat([x.to(home) for x in xs], dim=1)
                    for xs in zip(*outs)))

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
    ``seed + b`` (on its row's device, on a mesh; a rank of a mesh of ranks
    builds its own row's)."""
    if _ranked(mesh):
        me = _rank_row(mesh)
        a, b = me.ranges(lefts.shape[0])[me.row]
        return MeshState((batched_init_state(config, lefts[a:b], rights[a:b],
                                             seed=seed + a,
                                             device=me.device),))
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
    ``MeshState`` (its rows' arrays concatenated in sequence order: on a
    mesh of ranks, the rank's own row's)."""
    if not isinstance(state, MeshState):
        return state_arrays(state)
    rows = [state_arrays(s) for s in state.rows]
    return {k: np.concatenate([r[k] for r in rows]) for k in rows[0]}


def restore_batched_state(config: VOConfig, ckpt: dict, lefts, rights,
                          device=None, mesh: Mesh = None):
    """Batched state from a snapshot's stacked arrays and the checkpointed
    frame's (B, H, W) images: the pyramids are rebuilt from them and
    sequence b's generator takes row b of ``gen_state`` on ``device``; on
    a mesh, each data row takes its sequences' rows on its first device (a
    rank of a mesh of ranks, its own row's)."""
    if _ranked(mesh):
        me = _rank_row(mesh)
        a, b = me.ranges(lefts.shape[0])[me.row]
        return MeshState((restore_scan_state(
            config, None, {k: np.asarray(ckpt[k])[a:b] for k in STATE_KEYS},
            lefts[a:b], rights[a:b], device=me.device),))
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
