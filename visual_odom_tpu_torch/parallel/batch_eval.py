"""Multi-sequence batched evaluation: B sequences in lockstep on one card or
over a (data, model) device mesh.

Port of ``visual_odom_tpu/parallel/batch_eval.py`` (BASELINE.json eval
config 5, all KITTI sequences at once). B sequences advance through the
batched step (``parallel/batch.py``); per-frame outputs stay on the device
until fetched, and each sequence's poses are chained on the host in
float64.

Sequences are read lazily: random-access sequences (``.frame(i)`` and
``len``, such as ``io.kitti.KittiSequence`` or
``io.synthetic.SyntheticStereoSequence``) or plain frame lists. A sequence
shorter than the longest is padded with its last frame; the steps past its
end are cut from its pose chain and its stats.

The step, the chunk step (``runner.pipeline.make_scan_step_fn``), the
uploader thread, the fetch, the snapshot's state arrays and the pose
chaining are the single-sequence runner's; only the loop is this module's
own. ``runner.pipeline.run_sequence_scan`` streams from any iterable; this
loop needs random access to pad short sequences with their last frame and
to rebuild a snapshot's pyramids.
"""

from __future__ import annotations

import functools
import os
import sys
import time
from collections import namedtuple
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Sequence

import numpy as np
import torch

from visual_odom_tpu_torch import resolve_device
from visual_odom_tpu_torch.config import CameraIntrinsics, VOConfig
from visual_odom_tpu_torch.parallel.batch import (batched_init_state,
                                                  batched_state_arrays,
                                                  make_batched_scan_fn,
                                                  make_batched_step_fn,
                                                  restore_batched_state)
from visual_odom_tpu_torch.parallel.mesh import Mesh, position
from visual_odom_tpu_torch.runner.pipeline import (_ChunkUploader, _concat,
                                                   _fetch, _fetch_chunks,
                                                   _on_current_stream, _sync,
                                                   chain_poses_host)
from visual_odom_tpu_torch.utils import profiling
from visual_odom_tpu_torch.utils.checkpoint import (BATCH_OUTPUTS,
                                                    CorruptCheckpoint,
                                                    load_batch_checkpoint,
                                                    save_batch_checkpoint)


#: the outputs the batched runner keeps (and a snapshot stores), each with
#: a leading step axis and then B
_BatchOut = namedtuple("_BatchOut", BATCH_OUTPUTS)


def _frame_at(seq, i: int):
    """Clamped random access over a sequence with ``.frame`` or a list."""
    j = min(i, len(seq) - 1)
    if hasattr(seq, "frame"):
        return seq.frame(j)
    return seq[j]


def _sync_all(dev, mesh) -> None:
    """Wait for ``dev``, or for every device of a one-process ``mesh`` (a
    rank waits for its own device)."""
    one_process = mesh is not None and mesh.ranks is None
    for d in dict.fromkeys(mesh.devices.flat if one_process else [dev]):
        _sync(d)


def run_sequences_batched(sequences: Sequence, config: VOConfig,
                          intrinsics: CameraIntrinsics, seed: int = 0,
                          chunk: int = 0, checkpoint_path: str = "",
                          checkpoint_every: int = 0, verbose: bool = False,
                          snapshot_stats: Optional[list] = None,
                          device=None, mesh: Optional[Mesh] = None):
    """Run B sequences in lockstep. Returns (list of (N_b, 4, 4) float64
    pose arrays, per-sequence stats dicts, wall_seconds).

    Stats per sequence: ``frames`` (its length), ``accept_ratio`` and
    ``mean_inliers`` over its own steps, and ``fallback_frames``, its steps
    that the adaptive skip policy re-tracked at the safe level.

    ``chunk == 0``: one batched step per frame, the next frame read on a
    background thread while the card works (one-step-ahead prefetch), all
    outputs fetched once at the end. ``chunk > 0``: ``chunk`` frames per
    upload, read and uploaded by one background thread (two chunks ahead),
    the outputs kept on the device and fetched once after the loop; the
    first chunk's read and upload stay out of ``wall_seconds``. Sequence b
    draws its RANSAC samples from a generator seeded ``seed + b``.

    ``checkpoint_path`` (chunked runs only) makes the run restartable: one
    atomic snapshot of all B sequences every ``checkpoint_every`` steps,
    rounded up to whole chunks, so a resumed run's chunks line up with an
    uninterrupted one's and its result is the same bit for bit. A snapshot
    fetches the state's arrays in one copy and the outputs not yet fetched
    in another; a failure between snapshots loses only outputs still on
    the device. An existing snapshot is resumed from; one that cannot be
    trusted (torn, a key missing, another B or device kind, a cursor off
    the chunk grid) is rejected with a warning on stderr and the run starts
    fresh. ``snapshot_stats``, a list, gets one ``{"step", "ms", "bytes"}``
    per snapshot written (copies and write).

    ``mesh`` (a ``parallel.mesh.data_model_mesh``, in place of ``device``)
    runs the sharded batched step (``parallel.batch``): the sequences split
    over its data rows, each quad launch over a row's model devices; frames
    are uploaded to and outputs fetched from its first device. A run
    resumed on the same mesh equals the uninterrupted one bit for bit.

    On a mesh of ranks (``parallel.mesh.Rank``) every rank calls this with
    the same sequences: it steps its data row on its own device and returns
    every sequence's poses and stats, the same on every rank (the outputs
    all-gathered over its data group). Such a run takes no
    ``checkpoint_path``: a snapshot would have to gather every row's state
    to one writer and resume on every rank, which it does not do.

    On a card every step replays CUDA graphs
    (``parallel.batch.make_batched_scan_fn`` for a chunked run,
    ``make_batched_step_fn`` for ``chunk == 0``, whose graphs are captured
    before the wall): the batched step's on one card, each data row's on
    a one-process mesh (a row across cards, each card's graphs in turn),
    each rank's on a mesh of NCCL ranks (every rank captures before the
    wall, together). Gloo ranks step eagerly
    (``parallel.collectives.graph_place``).

    The call is a ``runner.call`` span (``utils.profiling``) holding
    ``runner.setup`` (the initial state, the step's graphs, the first
    chunk's read and upload), ``runner.loop`` (``wall_seconds``; inside it
    each ``runner.wait_upload`` on the uploader, ``runner.enqueue`` of a
    chunk's or step's replays and ``runner.fetch``) and ``runner.chain``
    (the poses and stats); its uploader's spans join its request.
    """
    if mesh is not None and device is not None:
        raise ValueError("run_sequences_batched takes a device or a mesh, "
                         "not both")
    ranked = mesh is not None and mesh.ranks is not None
    if ranked and checkpoint_path:
        raise ValueError("batched checkpoints are not written on a mesh of "
                         "ranks: run the restartable batched runner on one "
                         "device or on a one-process mesh")
    dev = resolve_device(mesh.devices[position(mesh)].device if ranked
                         else mesh.devices.flat[0] if mesh is not None
                         else device)
    lengths = [len(s) for s in sequences]
    if not lengths or min(lengths) == 0:
        raise ValueError("run_sequences_batched needs sequences of at least "
                         "one frame")
    if checkpoint_path and not chunk:
        raise ValueError("batched checkpointing needs chunk > 0 "
                         "(snapshots land on chunk boundaries)")
    B = len(sequences)
    n_steps = max(lengths) - 1

    def stacked(i):
        fr = [_frame_at(s, i) for s in sequences]
        return (np.stack([np.asarray(f[0]) for f in fr]),
                np.stack([np.asarray(f[1]) for f in fr]))

    with profiling.span("runner.call"):
        if chunk:
            parts, wall = _run_chunked(stacked, B, n_steps, config,
                                       intrinsics, seed, chunk,
                                       checkpoint_path, checkpoint_every,
                                       verbose, snapshot_stats, dev, mesh)
        else:
            parts, wall = _run_stepwise(stacked, n_steps, config, intrinsics,
                                        seed, dev, mesh)
        with profiling.span("runner.chain"):
            poses, stats = _chained(parts, lengths, B, n_steps)
    return poses, stats, wall


def _chained(parts, lengths, B, n_steps) -> tuple:
    """(poses, stats) of each sequence from the fetched outputs."""
    if parts:
        out = _concat([(p,) for p in parts])[0]
        out = _BatchOut(*(x[:n_steps] for x in out))
    else:
        out = _BatchOut(*(np.zeros((0, B)) for _ in _BatchOut._fields))
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
    return poses, stats


def _kept(out) -> _BatchOut:
    return _BatchOut(*(getattr(out, k) for k in _BatchOut._fields))


def _on(dev, mesh):
    """The runner's ``device=`` / ``mesh=`` keywords, one of them set."""
    return dict(mesh=mesh) if mesh is not None else dict(device=dev)


def _run_stepwise(stacked, n_steps, config, intrinsics, seed, dev, mesh):
    """One batched step per frame; returns ([fetched _BatchOut], wall)."""
    outs = []
    with ThreadPoolExecutor(max_workers=1) as ex:
        with profiling.span("runner.setup"):
            state = batched_init_state(config, *stacked(0), seed=seed,
                                       **_on(dev, mesh))
            step = make_batched_step_fn(config, intrinsics, **_on(dev, mesh))
            if n_steps:
                # The graphs are captured here, outside the wall (a no-op
                # once they are, or where the step is eager; every rank of
                # a mesh of ranks captures here together).
                step.capture(state, *stacked(1))
            read = functools.partial(_stacked_in_span, stacked,
                                     profiling.current_request())
            pending = ex.submit(read, 1) if n_steps else None
            _sync_all(dev, mesh)
        with profiling.span("runner.loop") as loop:
            for i in range(1, n_steps + 1):
                with profiling.span("runner.wait_upload"):
                    lefts, rights = pending.result()
                if i < n_steps:
                    pending = ex.submit(read, i + 1)
                with profiling.span("runner.enqueue"):
                    state, out = step(state, torch.from_numpy(lefts).to(dev),
                                      torch.from_numpy(rights).to(dev))
                outs.append(_kept(out))
            with profiling.span("runner.fetch"):
                parts = ([_fetch(_BatchOut(*(torch.stack(x)
                                             for x in zip(*outs))))]
                         if outs else [])
    return parts, loop.seconds


def _stacked_in_span(stacked, request: int, i: int):
    """``stacked(i)`` on the prefetch thread, as an ``upload.stack`` span of
    the runner call's ``request``."""
    with profiling.span("upload.stack", request=request):
        return stacked(i)


def _run_chunked(stacked, B, n_steps, config, intrinsics, seed, chunk,
                 checkpoint_path, checkpoint_every, verbose, snapshot_stats,
                 dev, mesh):
    """The chunked loop with its snapshots; returns ([fetched _BatchOut per
    part], wall)."""
    n_chunks = -(-n_steps // chunk)
    ck_chunks = (max(1, -(-checkpoint_every // chunk)) if checkpoint_every
                 else 1)

    def chunk_at(c):
        # (chunk, B, H, W); the tail repeats the final frame, whose steps
        # are cut from each sequence's chain.
        fr = [stacked(min(1 + c * chunk + j, n_steps)) for j in range(chunk)]
        return (np.stack([f[0] for f in fr]), np.stack([f[1] for f in fr]),
                chunk)

    done = []                                    # fetched, per part
    pending = []                                 # on the device, per chunk

    def fetch_pending():
        with profiling.span("runner.fetch"):
            done.extend(c[0] for c in _fetch_chunks(pending))
            pending.clear()

    with profiling.span("runner.setup"):
        scan = make_batched_scan_fn(config, intrinsics, chunk,
                                    **_on(dev, mesh))
        start_chunk, prev, state = 0, None, None
        if checkpoint_path and os.path.exists(checkpoint_path):
            start_chunk, prev, state = _resume(
                checkpoint_path, stacked, B, n_steps, n_chunks, config,
                chunk, verbose, dev, mesh)
        if state is None and start_chunk < n_chunks:
            state = batched_init_state(config, *stacked(0), seed=seed,
                                       **_on(dev, mesh))
        if prev is not None:
            done.append(prev)
        up = _ChunkUploader((chunk_at(c)
                             for c in range(start_chunk, n_chunks)),
                            dev, maxsize=2)
        try:
            cur = up.get()
            _sync_all(dev, mesh)
        except BaseException:
            up.cancel()
            raise
    chunks_done = start_chunk
    try:
        with profiling.span("runner.loop") as loop:
            while cur is not None:
                with profiling.span("runner.enqueue"):
                    state, out = scan(state, _on_current_stream(cur[0]),
                                      _on_current_stream(cur[1]))
                pending.append((_kept(out),))
                chunks_done += 1
                if (checkpoint_path and chunks_done < n_chunks
                        and (chunks_done - start_chunk) % ck_chunks == 0):
                    ts = time.perf_counter()
                    arrays = batched_state_arrays(state)
                    fetch_pending()
                    steps_now = chunks_done * chunk
                    outs = _concat([(p,) for p in done])[0]
                    size = save_batch_checkpoint(
                        checkpoint_path, steps_now, arrays,
                        {k: v[:steps_now] for k, v in outs._asdict().items()},
                        device=dev)
                    if snapshot_stats is not None:
                        snapshot_stats.append({
                            "step": steps_now, "bytes": size,
                            "ms": 1e3 * (time.perf_counter() - ts)})
                    if verbose:
                        print(f"batched checkpoint @ step {steps_now}")
                with profiling.span("runner.wait_upload"):
                    cur = up.get()
            fetch_pending()
    except BaseException:
        up.cancel()
        raise
    up.finish()
    return done, loop.seconds


def _resume(checkpoint_path, stacked, B, n_steps, n_chunks, config, chunk,
            verbose, dev, mesh) -> tuple:
    """(first chunk to run, the outputs fetched before it, the state) from
    the snapshot at ``checkpoint_path``; (0, None, None), with a warning,
    for one that cannot be trusted."""
    try:
        ck = load_batch_checkpoint(checkpoint_path, B, device=dev)
        steps_done = int(ck["frames_done"])
        if steps_done % chunk or steps_done > n_steps:
            raise CorruptCheckpoint(
                f"cursor {steps_done} not a chunk-{chunk} boundary "
                f"within {n_steps} steps")
        start_chunk = steps_done // chunk
        prev = _BatchOut(*(ck["out_" + k] for k in BATCH_OUTPUTS))
        state = None
        if start_chunk < n_chunks:
            state = restore_batched_state(config, ck, *stacked(steps_done),
                                          **_on(dev, mesh))
        if verbose:
            print(f"resumed batched scan from {checkpoint_path} "
                  f"at step {steps_done}")
        return start_chunk, prev, state
    except CorruptCheckpoint as e:
        print(f"warning: rejecting corrupt checkpoint: {e}", file=sys.stderr)
        return 0, None, None
