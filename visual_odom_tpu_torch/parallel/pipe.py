"""Pipeline-parallel VO: the step split in a frontend and a backend stage.

Port of ``visual_odom_tpu/parallel/pipe.py``. Stage 0, on ``devices[0]``,
owns the tracked features and the image pyramids: the new pair's
pyramids, detection and bucketing, the circular match
(``runner.pipeline.make_frontend_fn``: 3 ``lk_quad_kernel`` launches a
frame, or 32 ``lk_level_kernel`` launches on ``lk_backend="xla"``). Stage
1, on ``devices[1]``, owns the PnP warm start and the RANSAC generator:
triangulation, PnP-RANSAC, the optional mono rotation and the gates
(``make_backend_fn``). The only traffic between them is the match packet,
(P, 7) float32 = l0.xy, r0.xy, l1.xy, valid, and the frame's fallback
flag.

On the card each stage runs on a CUDA stream of its own, also when both
devices are the same card, and each is one CUDA graph
(``utils.cudagraph.GraphedStep``, one per stage, config and device in a
process; captured before the loop, as the JAX package jits each stage, and
driven through its ``stage``):

- frames are uploaded from pinned memory into the frontend graph's frame
  buffers, on its stream, and each frame is one replay there, which
  writes the packet into the graph's output row;
- the packet is copied into the backend graph's input buffers on the
  backend stream, after an event the frontend recorded; the frontend's
  next replay, which overwrites the row, waits for an event recorded
  after that copy. Between two cards the copy is a peer copy that torch
  orders after, and before, both stages' streams;
- each backend replay (its generator registered with its graph) writes
  the frame's outputs into its row, a copy of which is kept on the
  backend stream.

The host issues frontend(i) and then backend(i-1) without waiting for
either and never waits for the device inside the loop; the outputs are
fetched once after it. On the CPU (or inside
``utils.cudagraph.dispatch(False)``) the stages run eagerly, a packet
handed over by an event that the backend stream waits on
(``record_stream`` keeps its memory alive for the consumer), or by a
non-blocking copy between cards.

The split is at a pure data boundary and the backend draws from a
generator seeded ``seed`` in the step's order, so on one device the
outputs equal ``runner.pipeline.run_sequence_scan``'s bit for bit, but for
``num_bucketed``: as in the JAX package (``pipe.py:149-150``) it is the
count of matched features, ``num_matched``.
"""

from __future__ import annotations

import contextlib
import functools
import time
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from visual_odom_tpu_torch import resolve_device
from visual_odom_tpu_torch.config import CameraIntrinsics, VOConfig
from visual_odom_tpu_torch.frontend.featureset import (FeatureState,
                                                       empty_feature_state)
from visual_odom_tpu_torch.frontend.matching import commit_tracked_state
from visual_odom_tpu_torch.ops.lk import LKImage
from visual_odom_tpu_torch.parallel.mesh import local_devices
from visual_odom_tpu_torch.runner.pipeline import (StepOutput, _fetch_many,
                                                   _sync, chain_poses_host,
                                                   make_backend_fn,
                                                   make_frontend_fn,
                                                   prep_image,
                                                   seeded_generator)
from visual_odom_tpu_torch.utils.cudagraph import GraphedStep, use_graph


class _FrontState(NamedTuple):
    """Stage 0's state."""

    features: FeatureState
    lk_l0: LKImage
    lk_r0: LKImage


class _BackState(NamedTuple):
    """Stage 1's state."""

    tvec: torch.Tensor
    generator: object


class _Packet(NamedTuple):
    """The frontend's output, the backend's input."""

    packet: torch.Tensor    # (P, 7) f32: l0.xy, r0.xy, l1.xy, valid
    fallback: torch.Tensor  # () bool


def _on(stream):
    return (torch.cuda.stream(stream) if stream is not None
            else contextlib.nullcontext())


def _pinned(img: np.ndarray) -> torch.Tensor:
    """``img`` in a pinned host buffer. numpy copies the frame into it on
    this thread: ``pin_memory()`` copies with the intra-op thread pool,
    whose idle workers then spin: a frame at a time, that cost the process
    40-65 ms of host CPU a frame on an 8-core host."""
    dtype = torch.from_numpy(np.empty(0, img.dtype)).dtype
    pinned = torch.empty(img.shape, dtype=dtype, pin_memory=True)
    np.copyto(pinned.numpy(), img)
    return pinned


def _upload_frame(img, dev: torch.device, stream) -> torch.Tensor:
    """A host frame on ``dev``: on a card from pinned memory, without
    waiting, on ``stream``."""
    img = np.asarray(img)
    if dev.type != "cuda":
        return torch.as_tensor(img)
    with torch.cuda.stream(stream):
        return _pinned(img).to(dev, non_blocking=True)


def _host_frame(img, dev: torch.device) -> torch.Tensor:
    """A host frame to copy to ``dev`` without waiting: in pinned memory
    for a card."""
    img = np.asarray(img)
    return _pinned(img) if dev.type == "cuda" else torch.as_tensor(img)


def _stage_steps(config: VOConfig, intrinsics: CameraIntrinsics, devs,
                 streams=(None, None)):
    """The two stages as steps: ``frontend(_FrontState, left, right) ->
    (_FrontState, _Packet)`` on ``devs[0]`` and ``backend(_BackState,
    packet, fallback) -> (_BackState, StepOutput)`` on ``devs[1]``, each
    built on its stream."""
    with _on(streams[0]):
        front_half = make_frontend_fn(config, devs[0])
    with _on(streams[1]):
        back_half = make_backend_fn(config, intrinsics, devs[1])
        zero3 = torch.zeros(3, dtype=torch.float32, device=devs[1])

    def frontend(st, left, right):
        lk_l1, lk_r1, _, match, fallback = front_half(*st, left, right)
        packet = torch.cat([match.points_l0, match.points_r0,
                            match.points_l1,
                            match.valid[:, None].to(torch.float32)], dim=1)
        return (_FrontState(commit_tracked_state(match), lk_l1, lk_r1),
                _Packet(packet, fallback))

    def backend(st, packet, fallback):
        valid = packet[:, 6] > 0.5
        pnp, rvec_out, gate, accept, keep = back_half(
            packet[:, 0:2].contiguous(), packet[:, 2:4].contiguous(),
            packet[:, 4:6].contiguous(), valid, st.tvec, st.generator)
        matched = valid.sum(dim=-1).to(torch.int32)
        out = StepOutput(
            T_inv=gate.T_inv, accept=accept, scale=gate.scale,
            euler=gate.euler, rvec=rvec_out, tvec=pnp.tvec,
            num_inliers=pnp.num_inliers, num_matched=matched,
            num_bucketed=matched, fallback=fallback)
        return (_BackState(torch.where(keep[..., None], pnp.tvec, zero3),
                           st.generator), out)

    return frontend, backend


@functools.lru_cache(maxsize=8)
def _graphed_stages(config: VOConfig, intrinsics: CameraIntrinsics,
                    front: torch.device, back: torch.device):
    """(frontend, backend) as ``GraphedStep``s, one pair per (config,
    intrinsics, devices) in a process."""
    frontend, backend = _stage_steps(config, intrinsics, (front, back))
    return GraphedStep(frontend, front), GraphedStep(backend, back)


def _pipeline_loop(frames, front, back, hand_over):
    """``front(left, right)`` for every frame after the first, then
    ``back(handed)`` for the frame before it and ``hand_over(packet)`` of
    this frame's; the last packet is drained after the loop. Returns the
    backend's results, one a frame. Nothing here waits for the device."""
    outs, handed = [], None
    for left, right in frames[1:]:
        packet = front(left, right)
        if handed is not None:
            outs.append(back(handed))
        handed = hand_over(packet)
    outs.append(back(handed))
    return outs


def _hand_over(packet, streams, devs):
    """The frontend's packet (tensors on ``devs[0]``) made usable by the
    backend stream."""
    s_front, s_back = streams
    if s_front is None:
        return tuple(x.to(devs[1]) for x in packet)
    if devs[0] == devs[1]:
        ready = s_front.record_event()
        s_back.wait_event(ready)
        for x in packet:
            x.record_stream(s_back)
        return packet
    # Between cards the copy runs ordered after both stages' streams.
    with torch.cuda.stream(s_front), torch.cuda.stream(s_back):
        return tuple(x.to(devs[1], non_blocking=True) for x in packet)


def _eager_stages(frontend, backend, states, streams, devs):
    """The eager loop's ``front``, ``back``, ``hand_over`` and ``collect``
    (the outputs stacked)."""
    s_front, s_back = streams
    st = list(states)

    def front(left, right):
        with _on(s_front):
            left = _upload_frame(left, devs[0], s_front)
            right = _upload_frame(right, devs[0], s_front)
            st[0], packet = frontend(st[0], left, right)
        return packet

    def back(handed):
        with _on(s_back):
            st[1], out = backend(st[1], *handed)
        return out

    def collect(outs):
        return StepOutput(*(torch.stack(x) for x in zip(*outs)))

    return front, back, lambda p: _hand_over(p, streams, devs), collect


def _graphed_loop(fstage, bstage, streams, devs):
    """The loop's ``front``, ``back``, ``hand_over`` and ``collect`` over
    the stages' ``GraphedStage``s (their states loaded). The frontend's
    packet, views of its graph's row, is copied into the backend's input
    buffers on the backend stream after the frontend's event, and the
    frontend's next replay, which overwrites the row, waits for an event
    recorded after that copy."""
    s_front, s_back = streams
    consumed = [None]

    def front(left, right):
        with _on(s_front):
            if consumed[0] is not None:
                s_front.wait_event(consumed[0])
            fstage.feed([_host_frame(left, devs[0]),
                         _host_frame(right, devs[0])])
            packet, = fstage.replay()
            ready = s_front.record_event() if s_front is not None else None
        return packet, ready

    def hand_over(item):
        packet, ready = item
        if s_front is not None and devs[0] != devs[1]:
            # A peer copy, ordered after and before both streams' work.
            with torch.cuda.stream(s_front), torch.cuda.stream(s_back):
                bstage.feed(packet)
        else:
            with _on(s_back):
                if ready is not None:
                    s_back.wait_event(ready)
                bstage.feed(packet)
        if s_back is not None:
            consumed[0] = s_back.record_event()
        return bstage

    def back(stage):
        with _on(s_back):
            stage.replay(keep=True)

    def collect(_):
        return bstage.kept()[0]

    return front, back, hand_over, collect


def run_sequence_pipelined(frames, config: VOConfig,
                           intrinsics: CameraIntrinsics,
                           devices: Optional[Sequence] = None, seed: int = 0):
    """Two-stage pipelined sequence run over two devices (the same card
    twice is allowed: each stage then has a stream of its own).

    ``devices=None`` takes the visible CUDA devices and raises without
    two of them (or without a card); ``["cpu", "cpu"]`` runs the plain
    path. Returns (poses (N+1, 4, 4) float64, fetched StepOutput stack
    (numpy), wall_s): the wall covers the loop and the wait for the
    device after it, the outputs are fetched after it in one copy. On
    cards each stage replays its CUDA graph (captured before the wall;
    ``runner.graph.use_graph`` picks).
    """
    devs = (local_devices() if devices is None
            else [resolve_device(d) for d in devices])
    if len(devs) < 2:
        raise ValueError("pipeline parallelism needs two devices")
    devs = devs[:2]
    frames = list(frames)
    if len(frames) < 2:
        raise ValueError("run_sequence_pipelined needs at least two frames")
    graphed = all([use_graph(d) for d in devs])
    return _run(frames, config, intrinsics, devs, seed, graphed)


def _run(frames, config, intrinsics, devs, seed, graphed: bool):
    """The pipelined run, each stage replaying its graph or eager."""
    streams = tuple(torch.cuda.Stream(d) if d.type == "cuda" else None
                    for d in devs)
    if graphed:
        graphs = _graphed_stages(config, intrinsics, *devs)
        frontend, backend = graphs[0].step, graphs[1].step
    else:
        frontend, backend = _stage_steps(config, intrinsics, devs, streams)
    with _on(streams[0]):
        # Stage 0's state, built on its stream.
        front_state = _FrontState(
            empty_feature_state(config.padded_features, device=devs[0]),
            prep_image(_upload_frame(frames[0][0], devs[0], streams[0]),
                       config, devs[0]),
            prep_image(_upload_frame(frames[0][1], devs[0], streams[0]),
                       config, devs[0]))
    with _on(streams[1]):
        back_state = _BackState(torch.zeros(3, dtype=torch.float32,
                                            device=devs[1]),
                                seeded_generator(seed, devs[1]))
    for d in devs:
        _sync(d)    # the states, built on the stages' streams, are whole

    with contextlib.ExitStack() as held:
        if graphed:
            fstage = held.enter_context(graphs[0].stage(
                front_state, *(np.asarray(x) for x in frames[1])))
            # The backend's first inputs: a packet of no valid match.
            bstage = held.enter_context(graphs[1].stage(
                back_state, *_Packet(
                    torch.zeros((config.padded_features, 7),
                                dtype=torch.float32, device=devs[1]),
                    torch.zeros((), dtype=torch.bool, device=devs[1]))))
            loop = _graphed_loop(fstage, bstage, streams, devs)
        else:
            loop = _eager_stages(frontend, backend, (front_state, back_state),
                                 streams, devs)
        front, back, hand_over, collect = loop
        for d in devs:
            _sync(d)
        t0 = time.perf_counter()
        outs = _pipeline_loop(frames, front, back, hand_over)
        for d in devs:
            _sync(d)
        wall = time.perf_counter() - t0
        stacked = collect(outs)
    fetched = _fetch_many([stacked])[0]
    return chain_poses_host(fetched.T_inv, fetched.accept), fetched, wall
