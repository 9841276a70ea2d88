"""Multi-sequence batched evaluation: B sequences in lockstep on one card.

Port of ``visual_odom_tpu/parallel/batch_eval.py`` (BASELINE.json eval
config 5, all KITTI sequences at once). B sequences advance through the
batched step (``parallel/batch.py``); per-frame outputs stay on the device
until fetched, and each sequence's poses are chained on the host in
float64.

Sequences are read lazily: random-access sequences (``.frame(i)`` and
``len``, such as ``io.synthetic.SyntheticStereoSequence``) or plain frame
lists. A sequence shorter than the longest is padded with its last frame;
the steps past its end are cut from its pose chain and its stats. The
snapshot/resume of the JAX runner waits for the checkpoint port.

The step, the chunk step (``runner.pipeline.make_scan_step_fn``), the
fetch and the pose chaining are the single-sequence runner's; only the loop is this
module's own. ``runner.pipeline.run_sequence_scan`` streams from any
iterable and holds one chunk in host memory; this loop needs random access
to pad short sequences with their last frame, and reads the next frame or
chunk on a thread while the card works.
"""

from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor
from typing import Sequence

import numpy as np
import torch

from visual_odom_tpu_torch import resolve_device
from visual_odom_tpu_torch.config import CameraIntrinsics, VOConfig
from visual_odom_tpu_torch.parallel.batch import (batched_init_state,
                                                  make_batched_scan_fn,
                                                  make_batched_step_fn)
from visual_odom_tpu_torch.runner.pipeline import (StepOutput, _fetch,
                                                   chain_poses_host)


def _frame_at(seq, i: int):
    """Clamped random access over a sequence with ``.frame`` or a list."""
    j = min(i, len(seq) - 1)
    if hasattr(seq, "frame"):
        return seq.frame(j)
    return seq[j]


def run_sequences_batched(sequences: Sequence, config: VOConfig,
                          intrinsics: CameraIntrinsics, seed: int = 0,
                          chunk: int = 0, device=None):
    """Run B sequences in lockstep. Returns (list of (N_b, 4, 4) float64
    pose arrays, per-sequence stats dicts, wall_seconds).

    Stats per sequence: ``frames`` (its length), ``accept_ratio`` and
    ``mean_inliers`` over its own steps, and ``fallback_frames``, its steps
    that the adaptive skip policy re-tracked at the safe level.

    ``chunk == 0``: one batched step per frame, the next frame read on a
    background thread while the card works (one-step-ahead prefetch), all
    outputs fetched once at the end. ``chunk > 0``: ``chunk`` frames per
    upload, read one chunk ahead on the thread, outputs fetched once per
    chunk; the first chunk's read and upload stay out of ``wall_seconds``.
    Sequence b draws its RANSAC samples from a generator seeded
    ``seed + b``.
    """
    dev = resolve_device(device)
    lengths = [len(s) for s in sequences]
    if not lengths or min(lengths) == 0:
        raise ValueError("run_sequences_batched needs sequences of at least "
                         "one frame")
    n_steps = max(lengths) - 1

    def stacked(i):
        fr = [_frame_at(s, i) for s in sequences]
        return (np.stack([np.asarray(f[0]) for f in fr]),
                np.stack([np.asarray(f[1]) for f in fr]))

    state = batched_init_state(config, *stacked(0), seed=seed, device=dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    fetched = []
    with ThreadPoolExecutor(max_workers=1) as ex:
        if chunk:
            scan = make_batched_scan_fn(config, intrinsics, chunk, device=dev)
            n_chunks = -(-n_steps // chunk)

            def chunk_at(c):
                # (chunk, B, H, W); the tail repeats the final frame, whose
                # steps are cut below.
                fr = [stacked(min(1 + c * chunk + j, n_steps))
                      for j in range(chunk)]
                return (torch.from_numpy(np.stack([f[0] for f in fr])),
                        torch.from_numpy(np.stack([f[1] for f in fr])))

            def upload(host):
                return tuple(x.to(dev) for x in host)

            cur = upload(chunk_at(0)) if n_chunks else None
            sync()
            t0 = time.perf_counter()
            for c in range(n_chunks):
                ahead = ex.submit(chunk_at, c + 1) if c + 1 < n_chunks else None
                state, out = scan(state, *cur)
                fetched.append(_fetch(out))
                cur = upload(ahead.result()) if ahead is not None else None
            wall = time.perf_counter() - t0
        else:
            step = make_batched_step_fn(config, intrinsics, device=dev)
            pending = ex.submit(stacked, 1) if n_steps else None
            outs = []
            sync()
            t0 = time.perf_counter()
            for i in range(1, n_steps + 1):
                lefts, rights = pending.result()
                if i < n_steps:
                    pending = ex.submit(stacked, i + 1)
                state, out = step(state, torch.from_numpy(lefts).to(dev),
                                  torch.from_numpy(rights).to(dev))
                outs.append(out)
            if outs:
                fetched.append(_fetch(StepOutput(
                    *(torch.stack(x) for x in zip(*outs)))))
            wall = time.perf_counter() - t0

    B = len(sequences)
    if fetched:
        out = StepOutput(*(np.concatenate(xs)[:n_steps]
                           for xs in zip(*fetched)))
    else:
        out = StepOutput(*(np.zeros((0, B)) for _ in StepOutput._fields))
    poses, stats = [], []
    for b in range(B):
        nb = lengths[b] - 1
        poses.append(chain_poses_host(out.T_inv[:nb, b], out.accept[:nb, b]))
        stats.append({
            "frames": lengths[b],
            "accept_ratio": float(out.accept[:nb, b].mean()) if nb else 0.0,
            "mean_inliers": float(out.num_inliers[:nb, b].mean()) if nb else 0.0,
            "fallback_frames": int(out.fallback[:nb, b].sum()),
        })
    return poses, stats, wall
