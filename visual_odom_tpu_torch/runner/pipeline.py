"""The VO pipeline: the per-frame step and its front doors.

Port of ``visual_odom_tpu/runner/pipeline.py``. The step
(``make_step_fn``) takes the new stereo pair to the 4x4 frame delta:
pyramids of the new pair (reused as t0 next frame), FAST + bucketing on
L(t0), the circular LK match under the adaptive skip policy (on the route
``config.lk_backend`` picks: quad launches or per-leg level launches),
triangulation, PnP-RANSAC, and the rotation / scale / inlier-floor gates.
Everything stays on the device and the host chains poses in float64.

The front doors, all stepping the same ``make_step_fn`` with the same
generator draws, so on one device they give the same poses bit for bit:

- ``run_sequence_scan``, the throughput door: chunks of frames uploaded by
  background threads (``_ChunkUploader``, ``_ParallelChunkUploader``) or
  all before the loop (``preupload``), stepped by ``make_scan_step_fn``;
  the outputs stay on the device until every chunk is dispatched.
- ``run_sequence_scan_resumable``: the same with chunk-boundary snapshots
  and crash resume (``restore_scan_state``).
- ``VisualOdometry`` (feed a frame, get a pose; one fetch a frame),
  ``run_sequence`` over it, and ``run_sequence_resumable`` with its
  per-frame snapshots (``utils.checkpoint.save_checkpoint`` /
  ``restore_vo``).
- ``run_sequence_buffered``: every output written into preallocated device
  buffers at a device-side cursor, one fetch at the end.

The step is written over an optional leading batch dim: given a batched
state (``parallel.batch.batched_init_state``) and (B, H, W) frames it
advances B sequences in lockstep, the counterpart of the JAX package's
``jax.vmap`` of its step (``parallel/batch.py``); a single sequence is the
case without that dim. Each module keeps the batch dim through to the LK
kernels, each launch covering all B sequences.

The entry points run on CUDA unless ``device="cpu"`` is passed, and raise
when CUDA is asked for and absent. On a card every door steps through the
step's CUDA graph (``utils.cudagraph.GraphedStep``, one per (config,
intrinsics, ``with_tracks``, device) in a process, ``_graphed_step``):
the scan family a chunk of replays at a time, ``VisualOdometry`` and the
buffered step one replay a frame. Each equals the eager step bit for bit;
the CPU steps eagerly.
"""

from __future__ import annotations

import functools
import itertools
import os
import queue
import sys
import threading
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from visual_odom_tpu_torch import resolve_device
from visual_odom_tpu_torch.backend.essential import find_essential_ransac
from visual_odom_tpu_torch.backend.integrate import gate_and_integrate
from visual_odom_tpu_torch.backend.pnp import pnp_ransac
from visual_odom_tpu_torch.config import CameraIntrinsics, VOConfig
from visual_odom_tpu_torch.core.lie import rodrigues_inverse
from visual_odom_tpu_torch.core.triangulate import triangulate_points
from visual_odom_tpu_torch.eval.plot import render_tracks, save_png
from visual_odom_tpu_torch.frontend.bucketing import detect_and_bucket
from visual_odom_tpu_torch.frontend.featureset import (FeatureState,
                                                       empty_feature_state)
from visual_odom_tpu_torch.frontend.matching import (commit_tracked_state,
                                                     skip_mode_match)
from visual_odom_tpu_torch.io.kitti import PoseWriter, save_poses_kitti
from visual_odom_tpu_torch.ops.lk import LKImage, LKParams, prepare_lk_image
from visual_odom_tpu_torch.utils import profiling
from visual_odom_tpu_torch.utils.checkpoint import (CorruptCheckpoint,
                                                    load_checkpoint,
                                                    load_scan_checkpoint,
                                                    restore_vo,
                                                    save_checkpoint,
                                                    save_scan_checkpoint)
from visual_odom_tpu_torch.utils.cudagraph import GraphedStep, use_graph
from visual_odom_tpu_torch.utils.metrics import MetricsLogger


class VOState(NamedTuple):
    """Device-resident state carried across frames. A batched state has a
    leading B on every tensor and one generator per sequence."""

    features: FeatureState     # tracked features, positions in L(t0)
    lk_l0: LKImage             # prepared pyramid of L(t0)
    lk_r0: LKImage             # prepared pyramid of R(t0)
    tvec: torch.Tensor         # ([B,] 3) warm-start translation
    generator: object          # RANSAC sampling: a torch.Generator, or a
                               # tuple of B of them


class StepOutput(NamedTuple):
    """Small per-frame outputs (a leading B on each for a batched step)."""

    T_inv: torch.Tensor         # (4, 4) frame delta inverse (f32)
    accept: torch.Tensor        # () bool
    scale: torch.Tensor         # () ||t||
    euler: torch.Tensor         # (3,)
    rvec: torch.Tensor          # (3,)
    tvec: torch.Tensor          # (3,)
    num_inliers: torch.Tensor   # () int32
    num_matched: torch.Tensor   # () int32, circular-match survivors
    num_bucketed: torch.Tensor  # () int32, features entering LK
    fallback: torch.Tensor      # () bool, adaptive skip re-tracked at the safe level


class TrackSnapshot(NamedTuple):
    """Optional per-frame track dump for windowed-BA observation collection
    (``ba.window``): ids key multi-frame tracks, l1/r1 are the frame-t
    stereo measurement, l0/r0 the same tracks at frame t-1."""

    points_l0: torch.Tensor     # (N, 2)
    points_r0: torch.Tensor
    points_l1: torch.Tensor
    points_r1: torch.Tensor
    ids: torch.Tensor           # (N,) int32
    valid: torch.Tensor         # (N,) bool


def _lk_params(config: VOConfig) -> LKParams:
    return LKParams(window=config.lk_window, levels=config.lk_levels,
                    max_iters=config.lk_max_iters, eps=config.lk_eps,
                    min_eig_threshold=config.lk_min_eig_threshold)


def prep_image(img, config: VOConfig, device=None) -> LKImage:
    """``prepare_lk_image`` of a frame (numpy or tensor, any dtype, on any
    device) as float32 on ``device``. The step, the state builders and the
    restores all build their pyramids here, so a restored state's pyramids
    are the step's bit for bit."""
    img = torch.as_tensor(img).to(device=resolve_device(device),
                                  dtype=torch.float32)
    return prepare_lk_image(img, _lk_params(config))


def seeded_generator(seed: int, device: torch.device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


def init_vo_state(config: VOConfig, intrinsics: CameraIntrinsics, left0,
                  right0, seed: int = 0, device=None) -> VOState:
    """State from frame 0: no features, frame 0's pyramids, zero warm start
    and a RANSAC generator seeded with ``seed``."""
    dev = resolve_device(device)
    return VOState(
        features=empty_feature_state(config.padded_features, device=dev),
        lk_l0=prep_image(left0, config, dev),
        lk_r0=prep_image(right0, config, dev),
        tvec=torch.zeros(3, dtype=torch.float32, device=dev),
        generator=seeded_generator(seed, dev))


def make_frontend_fn(config: VOConfig, device=None, slot_devices=None):
    """The step's first half, ``frontend(features, lk_l0, lk_r0, left_t1,
    right_t1) -> (lk_l1, lk_r1, bucketed, match, fallback)``: the new
    pair's pyramids, FAST (or Shi-Tomasi) and bucketing on L(t0), and the
    circular match under the skip policy, on the LK route
    ``config.lk_backend`` picks. ``make_step_fn`` and the pipelined runner's
    frontend stage (``parallel.pipe``) both run it. ``slot_devices`` (a
    mesh row's "model" devices, ``device`` first) splits each quad launch's
    slots over them (``ops.lk_cuda.lk_circular_quad``)."""
    dev = resolve_device(device)
    params = _lk_params(config)

    def frontend(features: FeatureState, lk_l0: LKImage, lk_r0: LKImage,
                 left_t1, right_t1):
        lk_l1 = prep_image(left_t1, config, dev)
        lk_r1 = prep_image(right_t1, config, dev)

        pad = lk_l0.pad
        h, w = lk_l0.shapes[0]
        raw_l0 = lk_l0.pyramid[0][..., pad:pad + h, pad:pad + w]
        bucketed = detect_and_bucket(raw_l0, features, config)

        match, fallback = skip_mode_match(lk_l0, lk_r0, lk_l1, lk_r1,
                                          bucketed, params, config,
                                          slot_devices=slot_devices)
        return lk_l1, lk_r1, bucketed, match, fallback

    return frontend


def make_backend_fn(config: VOConfig, intrinsics: CameraIntrinsics,
                    device=None):
    """The step's second half, ``backend(points_l0, points_r0, points_l1,
    valid, tvec, generator, uniforms=None, ess_uniforms=None) -> (pnp,
    rvec, gate, accept, keep)``: triangulation (``safe3d`` where a point is
    not valid), PnP-RANSAC warm-started at ``tvec``, the optional mono
    rotation, and the rotation / scale / inlier-floor gates; ``keep`` says
    whether the solution may seed the next solve. PnP's uniforms and then
    the essential RANSAC's are drawn from ``generator``, in that order.
    ``make_step_fn`` and the pipelined runner's backend stage both run
    it."""
    dev = resolve_device(device)
    P_l = torch.as_tensor(intrinsics.proj_left(), device=dev)
    P_r = torch.as_tensor(intrinsics.proj_right(), device=dev)
    K = torch.as_tensor(intrinsics.intrinsic_matrix(), device=dev)
    floor = config.resolved_min_accept_inliers()
    zero3 = torch.zeros(3, dtype=torch.float32, device=dev)
    safe3d = torch.tensor([0.0, 0.0, 10.0], dtype=torch.float32, device=dev)

    def backend(points_l0, points_r0, points_l1, valid, tvec, generator,
                uniforms=None, ess_uniforms=None):
        pts3d = triangulate_points(P_l, P_r, points_l0, points_r0)
        pts3d = torch.where(valid[..., None], pts3d, safe3d)

        pnp = pnp_ransac(pts3d, points_l1, valid, K, zero3, tvec,
                         generator=generator,
                         iterations=config.ransac_iterations,
                         reproj_threshold=config.ransac_reproj_threshold,
                         sample_size=config.ransac_sample_size,
                         refine_iters=config.pnp_refine_iters,
                         uniforms=uniforms)

        rvec_out = pnp.rvec
        if config.mono_rotation:
            ess = find_essential_ransac(
                points_l0, points_l1, valid,
                float(intrinsics.fx), (float(intrinsics.cx),
                                       float(intrinsics.cy)),
                generator=generator, uniforms=ess_uniforms)
            rvec_out = rodrigues_inverse(ess.R)

        gate = gate_and_integrate(rvec_out, pnp.tvec)
        accept = gate.accept
        if floor > 0:
            # Beyond-reference scene-cut / tracking-loss floor.
            accept = accept & (pnp.num_inliers >= floor)
        # Only an accepted solution may seed the next solve.
        keep = accept & config.use_extrinsic_guess
        return pnp, rvec_out, gate, accept, keep

    return backend


def make_step_fn(config: VOConfig, intrinsics: CameraIntrinsics,
                 with_tracks: bool = False, device=None, slot_devices=None):
    """Build the per-frame step ``step(state, left_t1, right_t1,
    uniforms=None, ess_uniforms=None) -> (new_state, StepOutput)``, or
    ``(new_state, StepOutput, TrackSnapshot)`` ``with_tracks``.
    ``uniforms`` (iterations, padded_features) replaces PnP's RANSAC draw
    and, with ``config.mono_rotation``, ``ess_uniforms`` (200,
    padded_features) the essential RANSAC's (parity tests). Given a
    batched state, (B, H, W) frames and uniforms with a leading B, it is
    the batched step.

    The step is ``make_frontend_fn``'s half and then ``make_backend_fn``'s.
    ``config.mono_rotation`` takes the rotation from the essential matrix
    of L(t0) -> L(t1) (``find_essential_ransac``, the reference's optional
    branch, src/visualOdometry.cpp:152-157) and the translation from PnP.
    Each frame draws PnP's uniforms and then the essential RANSAC's from
    the sequence's generator, in that order. ``slot_devices`` splits the
    LK quad's slots over a mesh row's "model" devices (``make_frontend_fn``;
    ``parallel.batch`` passes them)."""
    dev = resolve_device(device)
    frontend = make_frontend_fn(config, dev, slot_devices)
    backend = make_backend_fn(config, intrinsics, dev)
    zero3 = torch.zeros(3, dtype=torch.float32, device=dev)

    def step(state: VOState, left_t1, right_t1, uniforms=None,
             ess_uniforms=None):
        lk_l1, lk_r1, bucketed, match, fallback = frontend(
            state.features, state.lk_l0, state.lk_r0, left_t1, right_t1)
        pnp, rvec_out, gate, accept, keep = backend(
            match.points_l0, match.points_r0, match.points_l1, match.valid,
            state.tvec, state.generator, uniforms, ess_uniforms)
        new_state = VOState(features=commit_tracked_state(match), lk_l0=lk_l1,
                            lk_r0=lk_r1,
                            tvec=torch.where(keep[..., None], pnp.tvec, zero3),
                            generator=state.generator)
        out = StepOutput(
            T_inv=gate.T_inv, accept=accept, scale=gate.scale,
            euler=gate.euler, rvec=rvec_out, tvec=pnp.tvec,
            num_inliers=pnp.num_inliers,
            num_matched=match.valid.sum(dim=-1).to(torch.int32),
            num_bucketed=bucketed.valid.sum(dim=-1).to(torch.int32),
            fallback=fallback)
        if with_tracks:
            return new_state, out, TrackSnapshot(
                points_l0=match.points_l0, points_r0=match.points_r0,
                points_l1=match.points_l1, points_r1=match.points_r1,
                ids=match.ids, valid=match.valid)
        return new_state, out

    return step


def chain_poses_host(T_inv: np.ndarray, accept: np.ndarray) -> np.ndarray:
    """Float64 pose chaining of fetched per-frame deltas; returns (N+1, 4, 4)
    including the identity start pose."""
    n = len(T_inv)
    poses = np.empty((n + 1, 4, 4))
    pose = np.eye(4)
    poses[0] = pose
    for i in range(n):
        if accept[i]:
            pose = pose @ np.asarray(T_inv[i], np.float64)
        poses[i + 1] = pose
    return poses


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _to_host(tensors) -> list:
    """Tensors (any device, dtype and shape) -> numpy arrays, in one
    device-to-host copy: their bytes are packed on the device, widest
    element first, so every array lies aligned in the fetched buffer."""
    if not tensors:
        return []
    order = sorted(range(len(tensors)),
                   key=lambda i: -tensors[i].element_size())
    buf = torch.cat([tensors[i].detach().reshape(-1).view(torch.uint8)
                     for i in order]).cpu().numpy()
    out = [None] * len(tensors)
    off = 0
    for i in order:
        t = tensors[i]
        n = t.numel() * t.element_size()
        dtype = torch.empty(0, dtype=t.dtype).numpy().dtype
        out[i] = buf[off:off + n].view(dtype).reshape(tuple(t.shape))
        off += n
    return out


def _fetch_many(outs) -> list:
    """NamedTuples of tensors -> the same NamedTuples of numpy arrays, in
    one device-to-host copy."""
    flat = iter(_to_host([x for o in outs for x in o]))
    return [type(o)(*(next(flat) for _ in o)) for o in outs]


def _fetch(out):
    return _fetch_many([out])[0]


def _fetch_chunks(outs) -> list:
    """Per-chunk tuples of output stacks on the device -> the same tuples of
    numpy stacks, in one device-to-host copy."""
    if not outs:
        return []
    k = len(outs[0])
    flat = _fetch_many([o for out in outs for o in out])
    return [tuple(flat[i:i + k]) for i in range(0, len(flat), k)]


def _concat(chunks) -> tuple:
    """Per-chunk tuples of numpy NamedTuple stacks -> one tuple of them,
    concatenated along the step axis."""
    return tuple(type(xs[0])(*(np.concatenate(f) for f in zip(*xs)))
                 for xs in zip(*chunks))


@functools.lru_cache(maxsize=8)
def _graphed_step(config: VOConfig, intrinsics: CameraIntrinsics,
                  with_tracks: bool, device: torch.device) -> GraphedStep:
    """The graphed step, one per (config, intrinsics, with_tracks, device)
    in a process: each captures its graphs once (``GraphedStep``)."""
    return GraphedStep(make_step_fn(config, intrinsics,
                                    with_tracks=with_tracks, device=device),
                       device)


def make_scan_step_fn(config: VOConfig, intrinsics: CameraIntrinsics,
                      with_tracks: bool = False, device=None, _graph=None):
    """Build ``scan_chunk(state, lefts, rights) -> (state, StepOutput
    stacked (k, ...))``, or ``(state, StepOutput, TrackSnapshot)`` stacked
    ``with_tracks``: the step over a chunk of k frames (numpy or tensors,
    each stack uploaded in one copy unless already on the device), with
    the outputs left on the device. The counterpart of the JAX package's
    jitted ``lax.scan`` over a chunk: k may be any length and no tail is
    padded. Frames (k, B, H, W) with a batched state step B sequences.

    On a card each frame is one replay of the step's CUDA graph
    (``utils.cudagraph.GraphedStep``, captured at the first chunk of each
    state and frame shape, once per (config, intrinsics, with_tracks,
    device) in a process); it gives the eager step's results bit for bit.
    The CPU has no graphs, so there the steps are eager launches.
    ``_graph``, the counterpart of the JAX step's private ``_jit``: None
    picks by device (``utils.cudagraph.use_graph``), False steps eagerly on
    a card too (the reference the graph is held to), True on the CPU raises.
    The doors that step through this function look it up when they are
    called."""
    dev = resolve_device(device)
    if use_graph(dev, _graph):
        return _graphed_step(config, intrinsics, with_tracks, dev).scan
    step = make_step_fn(config, intrinsics, with_tracks=with_tracks,
                        device=dev)

    def scan_chunk(state: VOState, lefts, rights):
        dl = torch.as_tensor(lefts).to(dev)
        dr = torch.as_tensor(rights).to(dev)
        outs = []
        for i in range(dl.shape[0]):
            state, *out = step(state, dl[i], dr[i])
            outs.append(out)
        return (state,) + tuple(type(o[0])(*(torch.stack(x)
                                             for x in zip(*o)))
                                for o in zip(*outs))

    return scan_chunk


def _frame_chunks(it, chunk: int):
    """Yield (lefts (k, H, W), rights (k, H, W), k) numpy stacks of up to
    ``chunk`` frames from an iterator of (left, right) frames. No frame is
    held once its chunk is stacked, so the host keeps O(chunk) frames
    whatever the consumer holds."""
    while True:
        frames = list(itertools.islice(it, chunk))
        if not frames:
            return
        lefts = np.stack([np.asarray(l) for l, _ in frames])
        rights = np.stack([np.asarray(r) for _, r in frames])
        n = len(frames)
        del frames
        yield lefts, rights, n


def _upload(host, dev: torch.device, stream) -> list:
    """Host arrays -> tensors on ``dev``. On a card they are copied from
    pinned memory on ``stream`` (the calling uploader thread's own), and the
    thread waits for its copies, so the tensors are whole when handed over.
    On the CPU they are the arrays themselves."""
    if dev.type != "cuda":
        return [torch.from_numpy(a) for a in host]
    with torch.cuda.stream(stream):
        out = [torch.from_numpy(a).pin_memory().to(dev, non_blocking=True)
               for a in host]
    done = torch.cuda.Event()
    done.record(stream)
    done.synchronize()
    return out


def _on_current_stream(x: torch.Tensor) -> torch.Tensor:
    """Mark an uploaded tensor as used by the current stream. It was
    allocated on an uploader's stream; without the mark the allocator would
    hand its block to the next upload as soon as the tensor is dropped,
    while the step's kernels may still be reading it."""
    if x.is_cuda:
        x.record_stream(torch.cuda.current_stream(x.device))
    return x


def _stream_for(dev: torch.device):
    return torch.cuda.Stream(dev) if dev.type == "cuda" else None


class _UploadStats(dict):
    """One uploader thread's ``stats_out`` keys, summed from its spans:
    ``decode_s`` (its ``upload.stack`` spans), ``upload_s`` (its
    ``upload.copy`` spans), ``upload_bytes``, ``chunks`` and
    ``thread_wall_s``, from its first span's start to its last one's
    end."""

    def __init__(self):
        super().__init__(decode_s=0.0, upload_s=0.0, upload_bytes=0,
                         thread_wall_s=0.0, chunks=0)
        self.first_ns = self.last_ns = None

    def add(self, sp, key: Optional[str] = None) -> None:
        if key is not None:
            self[key] += sp.seconds
        if self.first_ns is None:
            self.first_ns = sp.start_ns
        self.last_ns = sp.end_ns
        self["thread_wall_s"] = (self.last_ns - self.first_ns) / 1e9

    def busy_frac(self) -> float:
        busy = self["decode_s"] + self["upload_s"]
        return (busy / self["thread_wall_s"] if self["thread_wall_s"] > 0
                else 0.0)


def _mb_s(nbytes, seconds) -> float:
    return nbytes / 1e6 / seconds if seconds > 0 else 0.0


class _ParallelChunkUploader:
    """N threads that upload chunks and deliver them to the scan loop
    strictly in order.

    Each thread takes the next (seq, chunk) from the shared iterator under a
    lock, uploads it on its own stream and puts it in a stash keyed by seq;
    ``get`` pops by seq. A thread whose chunk would stand more than
    ``max_ahead`` chunks past the consumer waits, so host and device hold
    O(threads + max_ahead) chunks. Each thread records its spans as the
    single uploader's do, in the request of the caller that made the
    pool. ``stats_out`` gets the single uploader's keys summed over
    threads, ``threads``, ``pool_wall_s`` (from the threads' first span's
    start to their last one's end), ``per_thread`` rows, ``busy_frac``
    (the busiest thread's) and ``agg_upload_mb_s`` (bytes over the pool's
    wall: the concurrent upload rate).
    """

    def __init__(self, chunks, device: torch.device, threads: int = 3,
                 max_ahead: int = 3, stats_out: Optional[dict] = None):
        self._chunks = chunks
        self._dev = device
        self._lock = threading.Lock()        # the iterator and seq counter
        self._cond = threading.Condition()   # the stash and the cursors
        self._stash: dict = {}
        self._next_get = 0
        self._next_seq = 0
        self._eos_seq: Optional[int] = None  # seq after the last chunk
        self._max_ahead = max_ahead
        self._cancel = threading.Event()
        self._err: list = []
        self._stats_out = stats_out
        self._tstats: list = []
        self._request = profiling.current_request()
        self._threads = [threading.Thread(target=self._run, args=(k,),
                                          daemon=True, name=f"vo-upload-{k}")
                         for k in range(max(1, threads))]
        for t in self._threads:
            t.start()

    def _run(self, k: int):
        stats = _UploadStats()
        req = self._request
        try:
            stream = _stream_for(self._dev)
            while not self._cancel.is_set():
                with profiling.span("upload.stack", request=req) as sp:
                    with self._lock:
                        seq = self._next_seq
                        nxt = next(self._chunks, None)
                        if nxt is not None:
                            self._next_seq += 1
                stats.add(sp, "decode_s")
                if nxt is None:
                    with self._cond:
                        if self._eos_seq is None or seq < self._eos_seq:
                            self._eos_seq = seq
                        self._cond.notify_all()
                    return
                with profiling.span("upload.copy", request=req) as sp:
                    dl, dr = _upload(nxt[:2], self._dev, stream)
                stats.add(sp, "upload_s")
                stats["upload_bytes"] += nxt[0].nbytes + nxt[1].nbytes
                stats["chunks"] += 1
                with self._cond:
                    if seq - self._next_get >= self._max_ahead:
                        with profiling.span("upload.queue_full",
                                            request=req) as sp:
                            while (seq - self._next_get >= self._max_ahead
                                   and not self._cancel.is_set()):
                                self._cond.wait(timeout=0.2)
                        stats.add(sp)
                    if self._cancel.is_set():
                        return
                    self._stash[seq] = (dl, dr, nxt[2])
                    self._cond.notify_all()
        except BaseException as e:
            self._err.append(e)
            with self._cond:
                self._cond.notify_all()
        finally:
            self._tstats.append(stats)

    def get(self):
        with self._cond:
            while True:
                if self._err:
                    raise self._err[0]
                if self._next_get in self._stash:
                    item = self._stash.pop(self._next_get)
                    self._next_get += 1
                    self._cond.notify_all()
                    return item
                if (self._eos_seq is not None
                        and self._next_get >= self._eos_seq):
                    self._finalize_stats()
                    return None
                self._cond.wait(timeout=0.2)

    def cancel(self):
        self._cancel.set()
        with self._cond:
            self._stash.clear()
            self._cond.notify_all()
        for t in self._threads:
            t.join(timeout=30.0)

    def finish(self):
        for t in self._threads:
            t.join()
        if self._err:
            raise self._err[0]
        self._finalize_stats()

    def _finalize_stats(self):
        run = [s for s in self._tstats if s.first_ns is not None]
        if self._stats_out is None or not run:
            return
        wall = (max(s.last_ns for s in run)
                - min(s.first_ns for s in run)) / 1e9
        agg = {k: sum(s[k] for s in self._tstats)
               for k in ("decode_s", "upload_s", "upload_bytes", "chunks")}
        per_thread = [
            {**s, "busy_frac": s.busy_frac(),
             "upload_mb_s": _mb_s(s["upload_bytes"], s["upload_s"])}
            for s in self._tstats]
        self._stats_out.update(
            agg, threads=len(self._threads), pool_wall_s=wall,
            per_thread=per_thread,
            busy_frac=max(t["busy_frac"] for t in per_thread),
            # per-stream rate, and the concurrent rate over the pool's wall
            upload_mb_s=_mb_s(agg["upload_bytes"], agg["upload_s"]),
            agg_upload_mb_s=_mb_s(agg["upload_bytes"], wall))


class _ChunkUploader:
    """One background thread that uploads (lefts, rights, k) chunks from an
    iterator into a bounded queue (host memory stays O(chunk)); a None ends
    the stream.

    - Spans (``utils.profiling``), in the request of the caller that made
      the uploader: ``upload.stack`` (pulling and stacking a chunk's frames
      from the source), ``upload.copy`` (pinning, copying and waiting for
      the copies) and ``upload.queue_full`` (a put blocked on the full
      queue, i.e. on the step).
    - ``cancel()``: if the consumer dies mid-loop the thread must not sit on
      a full queue holding chunks: every put is a bounded retry under a
      cancellation flag, and cancel() drains the queue and joins.
    - ``stats_out``, from the spans: ``decode_s`` (Σ ``upload.stack``),
      ``upload_s`` (Σ ``upload.copy``), ``upload_bytes``,
      ``thread_wall_s`` (the first span's start to the last one's end),
      ``chunks``, ``busy_frac`` (the share of the thread's wall not spent
      waiting on a full queue, i.e. on the step) and ``upload_mb_s``.
    - ``finish()``: join, and re-raise the thread's error on the caller.
    """

    def __init__(self, chunks, device: torch.device, maxsize: int = 2,
                 stats_out: Optional[dict] = None):
        self.queue: queue.Queue = queue.Queue(maxsize=maxsize)
        self._chunks = chunks
        self._dev = device
        self._err: list = []
        self._cancel = threading.Event()
        self._stats_out = stats_out
        self._stats = _UploadStats()
        self._request = profiling.current_request()
        self._th = threading.Thread(target=self._run, daemon=True,
                                    name="vo-upload-0")
        self._th.start()

    def _put(self, item) -> bool:
        """Put ``item``, retrying while the queue is full (an
        ``upload.queue_full`` span) until it goes in or the uploader is
        cancelled; returns whether it went in."""
        if self._cancel.is_set():
            return False
        try:
            self.queue.put_nowait(item)
            return True
        except queue.Full:
            pass
        put = False
        with profiling.span("upload.queue_full",
                            request=self._request) as sp:
            while not put and not self._cancel.is_set():
                try:
                    self.queue.put(item, timeout=0.2)
                    put = True
                except queue.Full:
                    pass
        self._stats.add(sp)
        return put

    def _next(self):
        with profiling.span("upload.stack", request=self._request) as sp:
            nxt = next(self._chunks, None)
        self._stats.add(sp, "decode_s")
        return nxt

    def _run(self):
        stats = self._stats
        try:
            stream = _stream_for(self._dev)
            nxt = self._next()
            while nxt is not None and not self._cancel.is_set():
                with profiling.span("upload.copy",
                                    request=self._request) as sp:
                    dl, dr = _upload(nxt[:2], self._dev, stream)
                stats.add(sp, "upload_s")
                stats["upload_bytes"] += nxt[0].nbytes + nxt[1].nbytes
                stats["chunks"] += 1
                if not self._put((dl, dr, nxt[2])):
                    return
                nxt = self._next()
        except BaseException as e:
            self._err.append(e)
        finally:
            if self._stats_out is not None:
                self._stats_out.update(
                    stats, busy_frac=stats.busy_frac(),
                    upload_mb_s=_mb_s(stats["upload_bytes"],
                                      stats["upload_s"]))
            self._put(None)

    def get(self):
        return self.queue.get()

    def cancel(self):
        self._cancel.set()
        try:
            while True:
                self.queue.get_nowait()
        except queue.Empty:
            pass
        self._th.join(timeout=30.0)

    def finish(self):
        self._th.join()
        if self._err:
            raise self._err[0]


def _uploader(chunks, dev: torch.device, threads: int,
              stats_out: Optional[dict], maxsize: int = 2):
    if threads > 1:
        return _ParallelChunkUploader(chunks, dev, threads=threads,
                                      stats_out=stats_out)
    return _ChunkUploader(chunks, dev, maxsize=maxsize, stats_out=stats_out)


def run_sequence_scan(frames, config: VOConfig, intrinsics: CameraIntrinsics,
                      seed: int = 0, chunk: int = 32, warmup: bool = True,
                      preupload: bool = False,
                      stats_out: Optional[dict] = None,
                      collect_tracks: bool = False, upload_threads: int = 1,
                      device=None):
    """Chunked sequence runner, the throughput front door.

    ``frames`` is any iterable of (left, right) uint8 images; host memory
    holds O(chunk) frames. The first chunk is uploaded before any uploader
    thread starts (``stats_out`` counts the others); the rest are uploaded
    by one background thread, or by ``upload_threads`` > 1 threads
    delivering in order, or, with ``preupload``, all before the loop. The
    loop dispatches every chunk and keeps its outputs on the device: the
    wall stops once the last chunk's outputs are fetched, which waits for
    the device, and the other chunks' are fetched after it in one copy. A
    failure in the loop cancels the uploader and re-raises.

    Returns (poses (N+1, 4, 4) f64, fetched StepOutput of numpy arrays,
    wall_seconds, frames_processed). ``wall_seconds`` covers the
    steady-state loop (uploads included unless ``preupload``); with
    ``warmup`` the first chunk runs once on a throwaway state first, so
    one-time costs (kernel build and load, CUDA library initialisation)
    stay out of it. With ``collect_tracks``, a fifth element: the per-frame
    TrackSnapshot list (numpy, frame i+1's snapshot at index i, the
    ``ba.window.smooth_trajectory_ba`` input). On a card each frame is a
    replay of the step's CUDA graph (``make_scan_step_fn``).
    """
    dev = resolve_device(device)
    it = iter(frames)
    try:
        frame0 = next(it)
    except StopIteration:
        raise ValueError("run_sequence_scan needs at least one frame") from None
    scan_chunk = make_scan_step_fn(config, intrinsics,
                                   with_tracks=collect_tracks, device=dev)
    chunks = _frame_chunks(it, chunk)
    first = next(chunks, None)
    if first is None:
        return np.eye(4)[None].astype(np.float64), None, 0.0, 0
    first = (torch.as_tensor(first[0]).to(dev),
             torch.as_tensor(first[1]).to(dev), first[2])

    if warmup:
        wstate = init_vo_state(config, intrinsics, *frame0, seed=seed,
                               device=dev)
        scan_chunk(wstate, first[0], first[1])
        _sync(dev)

    state = init_vo_state(config, intrinsics, *frame0, seed=seed, device=dev)
    up = _uploader(chunks, dev, 1 if preupload else upload_threads,
                   stats_out, maxsize=0 if preupload else 2)
    if preupload:
        up.finish()         # every chunk is on the device before the wall
    _sync(dev)
    outs, n = [], 0
    try:
        t0 = time.perf_counter()
        for dl, dr, n_real in itertools.chain([first], iter(up.get, None)):
            state, *out = scan_chunk(state, _on_current_stream(dl),
                                     _on_current_stream(dr))
            outs.append(out)
            n += n_real
        last = _fetch_chunks(outs[-1:])
        wall = time.perf_counter() - t0
    except BaseException:
        up.cancel()
        raise
    up.finish()

    fetched, *tracks = _concat(_fetch_chunks(outs[:-1]) + last)
    poses = chain_poses_host(fetched.T_inv, fetched.accept)
    if collect_tracks:
        return poses, fetched, wall, n, [
            TrackSnapshot(*(x[i] for x in tracks[0])) for i in range(n)]
    return poses, fetched, wall, n


def restore_scan_state(config: VOConfig, intrinsics: CameraIntrinsics,
                       ckpt: dict, left_t0, right_t0, device=None) -> VOState:
    """A ``VOState`` from a scan snapshot and the checkpointed frame's
    images: the pyramids are rebuilt from frame t0 as the step builds them,
    and the RANSAC generator takes the stored state (on ``device``, the
    device it was saved from). A batched snapshot (arrays with a leading B,
    ``gen_state`` (B, bytes)) and (B, H, W) images give the batched state,
    sequence b's generator from row b."""
    dev = resolve_device(device)

    def t(k, dtype):
        return torch.tensor(np.asarray(ckpt[k]), dtype=dtype, device=dev)

    def generator(state):
        gen = torch.Generator(device=dev)
        gen.set_state(torch.from_numpy(np.ascontiguousarray(state)))
        return gen

    gen_state = np.asarray(ckpt["gen_state"], np.uint8)
    gen = (tuple(generator(g) for g in gen_state) if gen_state.ndim == 2
           else generator(gen_state))
    return VOState(
        features=FeatureState(
            points=t("points", torch.float32), ages=t("ages", torch.int32),
            valid=t("valid", torch.bool), ids=t("ids", torch.int32),
            next_id=t("next_id", torch.int32), flow=t("flow", torch.float32),
            disp=t("disp", torch.float32)),
        lk_l0=prep_image(left_t0, config, dev),
        lk_r0=prep_image(right_t0, config, dev),
        tvec=t("tvec", torch.float32), generator=gen)


def state_arrays(state: VOState) -> dict:
    """The state's resumable arrays (``utils.checkpoint.STATE_KEYS``) on the
    host: the feature arrays and the warm start in one device-to-host copy,
    and the generator's state (which lives on the host) beside them; for a
    batched state, every array with its leading B and one generator state
    per row."""
    f = state.features
    names = ("points", "ages", "valid", "ids", "next_id", "flow", "disp")
    host = _to_host([getattr(f, k) for k in names] + [state.tvec])
    arrays = dict(zip(names + ("tvec",), host))
    gens = state.generator
    arrays["gen_state"] = (np.stack([g.get_state().numpy() for g in gens])
                           if isinstance(gens, tuple)
                           else gens.get_state().numpy())
    return arrays


def run_sequence_scan_resumable(seq, config: VOConfig,
                                intrinsics: CameraIntrinsics,
                                checkpoint_path: str,
                                checkpoint_every: int = 256, chunk: int = 64,
                                seed: int = 0, max_frames: int = 0,
                                warmup: bool = True, verbose: bool = False,
                                stats_out: Optional[dict] = None,
                                upload_threads: int = 1,
                                collect_tracks: bool = False,
                                snapshot_stats: Optional[list] = None,
                                device=None):
    """The chunked runner with chunk-boundary checkpoints and crash resume.

    ``seq`` is random access (``len`` and ``.frame(i)``): a snapshot stores
    no image, and frame t0's pyramids are rebuilt from
    ``seq.frame(frames_done)`` at resume. Frames are read and uploaded by
    ``run_sequence_scan``'s uploaders (``upload_threads``, ``stats_out``).
    A snapshot is written every ``checkpoint_every`` steps, rounded up to a
    whole number of chunks, so a resumed run's chunks line up with an
    uninterrupted one's; each is the state's arrays in one device-to-host
    copy, the generator's state, and the outputs (and, ``collect_tracks``,
    the track snapshots) so far, fetched in one copy with the chunks not
    yet fetched, written atomically. An existing snapshot at
    ``checkpoint_path`` is resumed from; one that already covers the run
    returns its outputs and reads no frame. A snapshot that cannot be
    trusted (torn, a key missing, a cursor past the end, no tracks for a
    ``collect_tracks`` run) is rejected with a warning on stderr and the run
    starts fresh.

    Returns (poses (N+1, 4, 4) f64, fetched StepOutput stack (numpy),
    wall_seconds, steps processed by this call) and, ``collect_tracks``,
    the per-frame TrackSnapshot list. The wall covers this call's loop,
    snapshots included. ``snapshot_stats``, a list, gets one
    ``{"step", "ms", "bytes"}`` per snapshot written (copies and write).
    On a card the chunks replay the step's CUDA graph
    (``make_scan_step_fn``).
    """
    dev = resolve_device(device)
    n_total = len(seq) if not max_frames else min(len(seq), max_frames)
    n_steps = n_total - 1
    ck_chunks = max(1, -(-checkpoint_every // chunk))

    start_step, prev, state = 0, None, None
    if checkpoint_path and os.path.exists(checkpoint_path):
        try:
            ck = load_scan_checkpoint(checkpoint_path)
            start_step = int(ck["frames_done"])
            if start_step > n_steps:
                raise CorruptCheckpoint(
                    f"cursor {start_step} beyond sequence ({n_steps} steps)")
            prev = (StepOutput(**{k: ck["out_" + k]
                                  for k in StepOutput._fields}),)
            if collect_tracks:
                missing = [k for k in TrackSnapshot._fields
                           if "trk_" + k not in ck]
                if missing:
                    raise CorruptCheckpoint(
                        f"snapshot carries no track snapshots (missing "
                        f"trk_{missing[0]}): cannot resume a collect_tracks "
                        f"run from it")
                prev += (TrackSnapshot(**{k: ck["trk_" + k]
                                          for k in TrackSnapshot._fields}),)
            if start_step < n_steps:
                state = restore_scan_state(config, intrinsics, ck,
                                           *seq.frame(start_step), device=dev)
            if verbose:
                print(f"resumed scan from {checkpoint_path} at step "
                      f"{start_step}")
        except CorruptCheckpoint as e:
            print(f"warning: rejecting corrupt checkpoint: {e}",
                  file=sys.stderr)
            start_step, prev, state = 0, None, None

    def finish(parts, wall, processed):
        fetched = parts[0]
        poses = chain_poses_host(fetched.T_inv, fetched.accept)
        if collect_tracks:
            tracks = parts[1]
            return poses, fetched, wall, processed, [
                TrackSnapshot(*(x[i] for x in tracks))
                for i in range(len(tracks.valid))]
        return poses, fetched, wall, processed

    if start_step >= n_steps and prev is not None:
        return finish(prev, 0.0, 0)
    if n_steps < 1:
        raise ValueError("run_sequence_scan_resumable needs at least two "
                         "frames")
    if state is None:
        state = init_vo_state(config, intrinsics, *seq.frame(0), seed=seed,
                              device=dev)
    scan_chunk = make_scan_step_fn(config, intrinsics,
                                   with_tracks=collect_tracks, device=dev)
    if warmup:
        # One step on a throwaway state: kernel build and load, library
        # initialisation. The run's own generator is not touched.
        lw, rw = seq.frame(start_step + 1)
        wstate = init_vo_state(config, intrinsics, lw, rw, seed=seed,
                               device=dev)
        scan_chunk(wstate, np.asarray(lw)[None], np.asarray(rw)[None])
        _sync(dev)

    done = [prev] if prev is not None else []   # fetched, per chunk
    pending = []                                # on the device
    frames = (seq.frame(i) for i in range(start_step + 1, n_total))
    up = _uploader(_frame_chunks(frames, chunk), dev, upload_threads,
                   stats_out)
    steps_done = start_step
    full_chunks = 0
    try:
        t0 = time.perf_counter()
        for dl, dr, n_real in iter(up.get, None):
            state, *out = scan_chunk(state, _on_current_stream(dl),
                                     _on_current_stream(dr))
            pending.append(out)
            steps_done += n_real
            if n_real != chunk:
                continue
            full_chunks += 1
            if checkpoint_path and full_chunks % ck_chunks == 0:
                ts = time.perf_counter()
                arrays = state_arrays(state)
                done += _fetch_chunks(pending)
                pending.clear()
                size = save_scan_checkpoint(checkpoint_path, steps_done,
                                            arrays, *_concat(done))
                if snapshot_stats is not None:
                    snapshot_stats.append({
                        "step": steps_done, "bytes": size,
                        "ms": 1e3 * (time.perf_counter() - ts)})
                if verbose:
                    print(f"checkpoint @ step {steps_done}")
        done += _fetch_chunks(pending)
        wall = time.perf_counter() - t0
    except BaseException:
        up.cancel()
        raise
    up.finish()
    return finish(_concat(done), wall, steps_done - start_step)


class OutputBuffers(NamedTuple):
    """Preallocated per-frame outputs on the device. Each buffered step
    writes its outputs at ``idx`` and advances it on the device, so the
    frame loop never waits for the device; the host fetches the buffers
    once at the end and chains poses in float64 after (composition is
    associative, so deferred chaining is exact)."""

    T_inv: torch.Tensor        # (N, 4, 4)
    accept: torch.Tensor       # (N,) bool
    scale: torch.Tensor        # (N,)
    euler: torch.Tensor        # (N, 3)
    tvec: torch.Tensor         # (N, 3)
    num_inliers: torch.Tensor  # (N,) int32
    num_matched: torch.Tensor  # (N,) int32
    num_bucketed: torch.Tensor  # (N,) int32
    idx: torch.Tensor          # (1,) int64 next write position, on the
                               # device: a Python int would cost a copy
                               # a frame, and reading it back a sync


def make_output_buffers(n: int, device=None) -> OutputBuffers:
    dev = resolve_device(device)

    def zeros(*shape, dtype=torch.float32):
        return torch.zeros((n,) + shape, dtype=dtype, device=dev)

    return OutputBuffers(
        T_inv=torch.eye(4, device=dev).repeat(n, 1, 1),
        accept=zeros(dtype=torch.bool), scale=zeros(), euler=zeros(3),
        tvec=zeros(3), num_inliers=zeros(dtype=torch.int32),
        num_matched=zeros(dtype=torch.int32),
        num_bucketed=zeros(dtype=torch.int32),
        idx=torch.zeros(1, dtype=torch.int64, device=dev))


def _make_raw_step(config: VOConfig, intrinsics: CameraIntrinsics,
                   device=None):
    """The (state, left, right) -> (state, StepOutput) step shared by the
    interactive and buffered front doors."""
    return make_step_fn(config, intrinsics, with_tracks=False, device=device)


def make_buffered_step_fn(config: VOConfig, intrinsics: CameraIntrinsics,
                          device=None):
    """``step(state, left, right, bufs) -> (state, bufs)``: the step, its
    outputs written into ``bufs`` at ``bufs.idx`` (``index_copy_`` at the
    device-side cursor, which then advances on the device): no host sync
    inside the frame loop. The buffers are updated in place. On a card the
    step is one replay of its CUDA graph (``GraphedStep.__call__``) and
    the outputs are copied into ``bufs`` straight after it
    (``utils.cudagraph.use_graph`` picks)."""
    dev = resolve_device(device)
    base = (_graphed_step(config, intrinsics, False, dev)
            if use_graph(dev)
            else _make_raw_step(config, intrinsics, device=dev))
    fields = OutputBuffers._fields[:-1]

    def step(state: VOState, left_t1, right_t1, bufs: OutputBuffers):
        new_state, out = base(state, left_t1, right_t1)
        for k in fields:
            getattr(bufs, k).index_copy_(0, bufs.idx, getattr(out, k)[None])
        bufs.idx.add_(1)
        return new_state, bufs

    return step


def run_sequence_buffered(frames, config: VOConfig,
                          intrinsics: CameraIntrinsics, seed: int = 0,
                          preupload: bool = True, device=None):
    """Sequence runner with no host fetch until the end.

    Returns (poses (N+1, 4, 4) f64, fetched OutputBuffers as numpy,
    wall_seconds): the wall covers the frame loop and the wait for the
    device after it; with ``preupload`` every frame is on the device before
    it starts, so it excludes the uploads. The buffers come back in one
    device-to-host copy. On a card each frame is one replay of the step's
    CUDA graph (``make_buffered_step_fn``), captured before the wall when
    it is not yet.
    """
    dev = resolve_device(device)
    frames = list(frames)
    n = len(frames) - 1
    step = make_buffered_step_fn(config, intrinsics, device=dev)
    if preupload:
        frames = [(torch.as_tensor(l).to(dev), torch.as_tensor(r).to(dev))
                  for l, r in frames]
    state = init_vo_state(config, intrinsics, *frames[0], seed=seed,
                          device=dev)
    bufs = make_output_buffers(n, device=dev)
    if n and use_graph(dev):
        # Capture before the wall (a no-op once captured), as the scan's
        # warm-up does; the capture steps copies, not ``state``.
        _graphed_step(config, intrinsics, False, dev).capture(
            state, *(torch.as_tensor(x) for x in frames[1]))
    _sync(dev)
    t0 = time.perf_counter()
    for left, right in frames[1:]:
        state, bufs = step(state, left, right, bufs)
    _sync(dev)
    wall = time.perf_counter() - t0
    fetched = _fetch(bufs)
    return chain_poses_host(fetched.T_inv, fetched.accept), fetched, wall


class FrameResult(NamedTuple):
    """Host-side result of one processed frame."""

    frame_id: int
    pose: np.ndarray          # (4, 4) float64 integrated world pose
    accept: bool
    scale: float
    num_inliers: int
    num_matched: int
    num_bucketed: int
    frame_time_ms: float      # its vo.process_frame span


class VisualOdometry:
    """Stateful host driver: feed stereo frames, get integrated poses.

    Usage:
        vo = VisualOdometry(config, intrinsics)
        vo.initialize(left0, right0)
        for left, right in frames:
            result = vo.process_frame(left, right)

    Each frame waits for the device once: its outputs (and, ``with_tracks``,
    its track snapshot, kept as numpy in ``last_tracks``) come back in one
    device-to-host copy. The pose chains ``frame_pose @ T_inv`` in float64,
    as ``chain_poses_host`` does.

    On a card each frame is one replay of the step's CUDA graph
    (``GraphedStep.fetched``: the frame pair copied into the graph's
    buffers, the replay, the state handed out as one copy, the outputs'
    row fetched in the frame's one copy), bit for bit the eager step.
    ``state`` is the caller's to read and set (``save_checkpoint``,
    ``restore_vo``): a state set from outside is loaded into the graph's
    buffers at the next frame. ``_graph`` as ``make_scan_step_fn``'s: None
    picks by device, False steps eagerly on a card, True on the CPU
    raises.

    Spans (``utils.profiling``): each frame is a ``vo.process_frame`` span,
    whose length is its ``frame_time_ms``; inside it, on a card, the
    graph's ``graph.input``, ``graph.replay``, ``graph.fetch`` and
    ``graph.snapshot`` spans, then ``vo.chain`` (the float64 pose).
    ``initialize`` is a ``vo.initialize`` span.
    """

    def __init__(self, config: VOConfig, intrinsics: CameraIntrinsics,
                 seed: int = 0, with_tracks: bool = False, device=None,
                 _graph=None):
        self.config = config
        self.intrinsics = intrinsics
        self.with_tracks = with_tracks
        self.device = resolve_device(device)
        self._graphed = (_graphed_step(config, intrinsics, with_tracks,
                                       self.device)
                         if use_graph(self.device, _graph) else None)
        self._step = (None if self._graphed is not None else
                      make_step_fn(config, intrinsics, with_tracks,
                                   device=self.device))
        self._seed = seed
        self.frame_pose = np.eye(4)  # float64 world pose (reference frame_pose)
        self.frame_id = 0
        self.state: Optional[VOState] = None
        self.last_tracks: Optional[TrackSnapshot] = None

    def initialize(self, left0, right0) -> None:
        """Load frame 0 (reference src/main.cpp:110-113)."""
        with profiling.span("vo.initialize"):
            self.state = init_vo_state(self.config, self.intrinsics, left0,
                                       right0, seed=self._seed,
                                       device=self.device)
            self.frame_pose = np.eye(4)
            self.frame_id = 0

    def process_frame(self, left, right) -> FrameResult:
        if self.state is None:
            raise RuntimeError("call initialize(left0, right0) first")
        with profiling.span("vo.process_frame") as frame:
            self.frame_id += 1
            if self._graphed is not None:
                self.state, out, *tracks = self._graphed.fetched(
                    self.state, left, right)
            else:
                self.state, *outs = self._step(self.state, left, right)
                out, *tracks = _fetch_many(outs)
            if self.with_tracks:
                self.last_tracks = tracks[0]
            with profiling.span("vo.chain"):
                accept = bool(out.accept)
                if accept:
                    self.frame_pose = self.frame_pose @ np.asarray(
                        out.T_inv, np.float64)
                fields = dict(frame_id=self.frame_id,
                              pose=self.frame_pose.copy(), accept=accept,
                              scale=float(out.scale),
                              num_inliers=int(out.num_inliers),
                              num_matched=int(out.num_matched),
                              num_bucketed=int(out.num_bucketed))
        return FrameResult(**fields, frame_time_ms=frame.seconds * 1e3)


def _print_frame(r: FrameResult) -> None:
    print(f"frame {r.frame_id}: matched={r.num_matched} "
          f"inliers={r.num_inliers} scale={r.scale:.3f} "
          f"accept={r.accept} {r.frame_time_ms:.1f}ms")


def run_sequence(frames, config: VOConfig, intrinsics: CameraIntrinsics,
                 seed: int = 0, metrics_path: Optional[str] = None,
                 poses_path: Optional[str] = None, verbose: bool = False,
                 tracks_dir: Optional[str] = None, tracks_every: int = 50,
                 collect_tracks: bool = False, live=None, device=None):
    """Run ``VisualOdometry`` over an iterable of (left, right) frames.

    Returns ((N, 4, 4) float64 poses including identity frame 0, the
    per-frame ``FrameResult`` list) and, ``collect_tracks``, the per-frame
    TrackSnapshots (numpy) as a third element, the input to windowed-BA
    smoothing. ``metrics_path`` gets one JSONL line a frame,
    ``poses_path`` the poses as KITTI rows (identity first) as they come,
    ``tracks_dir`` a displayTracking-style overlay PNG (reference
    src/visualOdometry.cpp:195-224) at frame 1 and every ``tracks_every``
    frames; ``live`` (an ``eval.plot.LiveDisplay``) is updated every frame
    and closed at the end.
    """
    it = iter(frames)
    left0, right0 = next(it)
    vo = VisualOdometry(config, intrinsics, seed=seed,
                        with_tracks=bool(tracks_dir) or collect_tracks
                        or live is not None, device=device)
    vo.initialize(left0, right0)
    if tracks_dir:
        os.makedirs(tracks_dir, exist_ok=True)
    logger = MetricsLogger(metrics_path) if metrics_path else None
    writer = PoseWriter(poses_path) if poses_path else None
    poses, results, snapshots = [np.eye(4)], [], []
    try:
        if writer:
            writer.append(np.eye(4))
        for left, right in it:
            r = vo.process_frame(left, right)
            poses.append(r.pose)
            results.append(r)
            tr = vo.last_tracks
            if collect_tracks:
                snapshots.append(tr)
            if live is not None:
                live.update(r.pose, np.asarray(left), tr)
            if tracks_dir and (r.frame_id % tracks_every == 0
                               or r.frame_id == 1):
                save_png(f"{tracks_dir}/tracks_{r.frame_id:06d}.png",
                         render_tracks(np.asarray(left), tr.points_l0,
                                       tr.points_l1, tr.valid))
            if writer:
                writer.append(r.pose)
            if logger:
                logger.log(r._asdict() | {"pose": None})
            if verbose:
                _print_frame(r)
    finally:
        for closing in (writer, logger, live):
            if closing is not None:
                closing.close()
    if collect_tracks:
        return np.asarray(poses), results, snapshots
    return np.asarray(poses), results


def run_sequence_resumable(seq, config: VOConfig,
                           intrinsics: CameraIntrinsics,
                           checkpoint_path: str, checkpoint_every: int = 100,
                           seed: int = 0, max_frames: int = 0,
                           metrics_path: Optional[str] = None,
                           poses_path: Optional[str] = None,
                           verbose: bool = False,
                           snapshot_stats: Optional[list] = None,
                           device=None):
    """``run_sequence`` over a random-access sequence (``len`` and
    ``.frame(i)``) with periodic snapshots and crash resume.

    A snapshot (``utils.checkpoint.save_checkpoint``: the state's arrays,
    the generator's state, the integrated pose and the pose trail as
    ``extra_poses``) is written after frame i when ``i % checkpoint_every
    == 0`` and after the last frame, so a resumed run reproduces an
    uninterrupted one bit for bit. An existing snapshot is resumed from;
    a corrupt one is rejected with a warning on stderr and the run starts
    fresh. ``poses_path`` gets the whole trail as KITTI rows at the end;
    ``snapshot_stats``, a list, one ``{"frame", "ms", "bytes"}`` per
    snapshot. Returns ((N, 4, 4) poses, the ``FrameResult`` list of the
    frames this call processed).
    """
    n = len(seq) if not max_frames else min(len(seq), max_frames)
    vo = VisualOdometry(config, intrinsics, seed=seed, device=device)
    start, poses, resumed = 1, [np.eye(4)], False
    if checkpoint_path and os.path.exists(checkpoint_path):
        try:
            ckpt = load_checkpoint(checkpoint_path)
            k = int(ckpt["frame_id"])
            start = restore_vo(vo, ckpt, *seq.frame(k))
            poses = list(np.asarray(ckpt["extra_poses"]))
            resumed = True
            if verbose:
                print(f"resumed from {checkpoint_path} at frame {k}")
        except CorruptCheckpoint as e:
            print(f"warning: rejecting corrupt checkpoint: {e}",
                  file=sys.stderr)
    if not resumed:
        vo.initialize(*seq.frame(0))

    logger = MetricsLogger(metrics_path) if metrics_path else None
    results: list[FrameResult] = []
    try:
        for i in range(start, n):
            r = vo.process_frame(*seq.frame(i))
            poses.append(r.pose)
            results.append(r)
            if logger:
                logger.log(r._asdict() | {"pose": None})
            if verbose:
                _print_frame(r)
            if checkpoint_path and checkpoint_every and (
                    i % checkpoint_every == 0 or i == n - 1):
                ts = time.perf_counter()
                size = save_checkpoint(checkpoint_path, vo,
                                       extra={"poses": np.stack(poses)})
                if snapshot_stats is not None:
                    snapshot_stats.append({
                        "frame": i, "bytes": size,
                        "ms": 1e3 * (time.perf_counter() - ts)})
    finally:
        if logger:
            logger.close()
    arr = np.asarray(poses)
    if poses_path:
        save_poses_kitti(poses_path, arr)
    return arr, results
