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
devices are the same card. The host issues frontend(i) and then
backend(i-1) without waiting for either: a packet is handed over by an
event that the backend stream waits on (``record_stream`` keeps its
memory alive for the consumer), or, between two cards, by a non-blocking
copy ordered by both streams. Frames are uploaded from pinned memory on
the frontend stream. The loop never waits for the device; the outputs are
fetched once after it.

The split is at a pure data boundary and the backend draws from a
generator seeded ``seed`` in the step's order, so on one device the
outputs equal ``runner.pipeline.run_sequence_scan``'s bit for bit, but for
``num_bucketed``: as in the JAX package (``pipe.py:149-150``) it is the
count of matched features, ``num_matched``.
"""

from __future__ import annotations

import contextlib
import time
from typing import Optional, Sequence

import numpy as np
import torch

from visual_odom_tpu_torch import resolve_device
from visual_odom_tpu_torch.config import CameraIntrinsics, VOConfig
from visual_odom_tpu_torch.frontend.featureset import empty_feature_state
from visual_odom_tpu_torch.frontend.matching import commit_tracked_state
from visual_odom_tpu_torch.parallel.mesh import local_devices
from visual_odom_tpu_torch.runner.pipeline import (StepOutput, _fetch_many,
                                                   _sync, chain_poses_host,
                                                   make_backend_fn,
                                                   make_frontend_fn,
                                                   prep_image,
                                                   seeded_generator)


def _on(stream):
    return (torch.cuda.stream(stream) if stream is not None
            else contextlib.nullcontext())


def _upload_frame(img, dev: torch.device, stream) -> torch.Tensor:
    """A host frame on ``dev``: on a card from pinned memory, without
    waiting, on ``stream``. numpy copies the frame into the pinned buffer
    on this thread: ``pin_memory()`` copies with the intra-op thread pool,
    whose idle workers then spin: a frame at a time, that cost the process
    40-65 ms of host CPU a frame on an 8-core host."""
    img = np.asarray(img)
    if dev.type != "cuda":
        return torch.as_tensor(img)
    dtype = torch.from_numpy(np.empty(0, img.dtype)).dtype
    pinned = torch.empty(img.shape, dtype=dtype, pin_memory=True)
    np.copyto(pinned.numpy(), img)
    with torch.cuda.stream(stream):
        return pinned.to(dev, non_blocking=True)


def _pipeline_loop(frames, frontend, backend, states, streams, devs):
    """frontend(i) and then backend(i-1), for every frame after the first;
    the last packet is drained after the loop. Each stage carries its own
    state. Returns the backend's outputs (on ``devs[1]``), one a frame.
    Nothing here waits for the device."""
    s_front, s_back = streams
    front_state, back_state = states
    outs, handed = [], None
    for left, right in frames[1:]:
        with _on(s_front):
            left = _upload_frame(left, devs[0], s_front)
            right = _upload_frame(right, devs[0], s_front)
            front_state, packet = frontend(front_state, left, right)
        if handed is not None:
            with _on(s_back):
                back_state, out = backend(back_state, handed)
            outs.append(out)
        handed = _hand_over(packet, streams, devs)
    with _on(s_back):
        back_state, out = backend(back_state, handed)
    outs.append(out)
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


def run_sequence_pipelined(frames, config: VOConfig,
                           intrinsics: CameraIntrinsics,
                           devices: Optional[Sequence] = None, seed: int = 0):
    """Two-stage pipelined sequence run over two devices (the same card
    twice is allowed: each stage then has a stream of its own).

    ``devices=None`` takes the visible CUDA devices and raises without
    two of them (or without a card); ``["cpu", "cpu"]`` runs the plain
    path. Returns (poses (N+1, 4, 4) float64, fetched StepOutput stack
    (numpy), wall_s): the wall covers the loop and the wait for the
    device after it, the outputs are fetched after it in one copy.
    """
    devs = (local_devices() if devices is None
            else [resolve_device(d) for d in devices])
    if len(devs) < 2:
        raise ValueError("pipeline parallelism needs two devices")
    devs = devs[:2]
    frames = list(frames)
    if len(frames) < 2:
        raise ValueError("run_sequence_pipelined needs at least two frames")
    streams = tuple(torch.cuda.Stream(d) if d.type == "cuda" else None
                    for d in devs)

    with _on(streams[0]):
        # Stage 0's state and program, built on its stream.
        front_half = make_frontend_fn(config, devs[0])
        feats = empty_feature_state(config.padded_features, device=devs[0])
        lk_l0 = prep_image(_upload_frame(frames[0][0], devs[0], streams[0]),
                           config, devs[0])
        lk_r0 = prep_image(_upload_frame(frames[0][1], devs[0], streams[0]),
                           config, devs[0])
    with _on(streams[1]):
        back_half = make_backend_fn(config, intrinsics, devs[1])
        zero3 = torch.zeros(3, dtype=torch.float32, device=devs[1])
        tvec = torch.zeros(3, dtype=torch.float32, device=devs[1])
    generator = seeded_generator(seed, devs[1])

    def frontend(st, left, right):
        lk_l1, lk_r1, _, match, fallback = front_half(*st, left, right)
        packet = torch.cat([match.points_l0, match.points_r0,
                            match.points_l1,
                            match.valid[:, None].to(torch.float32)], dim=1)
        return (commit_tracked_state(match), lk_l1, lk_r1), (packet, fallback)

    def backend(tvec, handed):
        packet, fallback = handed
        valid = packet[:, 6] > 0.5
        pnp, rvec_out, gate, accept, keep = back_half(
            packet[:, 0:2].contiguous(), packet[:, 2:4].contiguous(),
            packet[:, 4:6].contiguous(), valid, tvec, generator)
        matched = valid.sum(dim=-1).to(torch.int32)
        out = StepOutput(
            T_inv=gate.T_inv, accept=accept, scale=gate.scale,
            euler=gate.euler, rvec=rvec_out, tvec=pnp.tvec,
            num_inliers=pnp.num_inliers, num_matched=matched,
            num_bucketed=matched, fallback=fallback)
        return torch.where(keep[..., None], pnp.tvec, zero3), out

    for d in devs:
        _sync(d)
    t0 = time.perf_counter()
    outs = _pipeline_loop(frames, frontend, backend,
                          ((feats, lk_l0, lk_r0), tvec), streams, devs)
    for d in devs:
        _sync(d)
    wall = time.perf_counter() - t0
    fetched = _fetch_many([StepOutput(*(torch.stack(x) for x in zip(*outs)))])[0]
    return chain_poses_host(fetched.T_inv, fetched.accept), fetched, wall
