"""The VO pipeline: the per-frame step and the chunked sequence runner.

Port of ``visual_odom_tpu/runner/pipeline.py`` (``VOState``,
``StepOutput``, ``TrackSnapshot``, ``make_step_fn``, ``init_vo_state``,
``run_sequence_scan``, ``chain_poses_host``, and the scan's checkpoints:
``restore_scan_state``, ``run_sequence_scan_resumable``). One step takes
the new stereo pair to the 4x4 frame delta: pyramids of the new pair (reused as t0 next
frame), FAST + bucketing on L(t0), the circular LK match under the adaptive
skip policy (on the route ``config.lk_backend`` picks: quad launches or
per-leg level launches), triangulation, PnP-RANSAC, and the rotation /
scale / inlier-floor gates.
Everything stays on the device; the runner fetches outputs once per chunk
and chains poses in float64 on the host.

The step is written over an optional leading batch dim: given a batched
state (``parallel.batch.batched_init_state``) and (B, H, W) frames it
advances B sequences in lockstep, the counterpart of the JAX package's
``jax.vmap`` of its step (``parallel/batch.py``); a single sequence is the
case without that dim. Each module keeps the batch dim through to the LK
kernels, each launch covering all B sequences.

The entry points run on CUDA unless ``device="cpu"`` is passed, and raise
when CUDA is asked for and absent.
"""

from __future__ import annotations

import itertools
import os
import sys
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
from visual_odom_tpu_torch.frontend.bucketing import detect_and_bucket
from visual_odom_tpu_torch.frontend.featureset import (FeatureState,
                                                       empty_feature_state)
from visual_odom_tpu_torch.frontend.matching import (commit_tracked_state,
                                                     skip_mode_match)
from visual_odom_tpu_torch.ops.lk import LKImage, LKParams, prepare_lk_image
from visual_odom_tpu_torch.utils.checkpoint import (CorruptCheckpoint,
                                                    load_scan_checkpoint,
                                                    save_scan_checkpoint)


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


def _prep_image(img, config: VOConfig, device: torch.device) -> LKImage:
    img = torch.as_tensor(img).to(device=device, dtype=torch.float32)
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
        lk_l0=_prep_image(left0, config, dev),
        lk_r0=_prep_image(right0, config, dev),
        tvec=torch.zeros(3, dtype=torch.float32, device=dev),
        generator=seeded_generator(seed, dev))


def make_step_fn(config: VOConfig, intrinsics: CameraIntrinsics,
                 with_tracks: bool = False, device=None):
    """Build the per-frame step ``step(state, left_t1, right_t1,
    uniforms=None, ess_uniforms=None) -> (new_state, StepOutput)``, or
    ``(new_state, StepOutput, TrackSnapshot)`` ``with_tracks``.
    ``uniforms`` (iterations, padded_features) replaces PnP's RANSAC draw
    and, with ``config.mono_rotation``, ``ess_uniforms`` (200,
    padded_features) the essential RANSAC's (parity tests). Given a
    batched state, (B, H, W) frames and uniforms with a leading B, it is
    the batched step.

    ``config.mono_rotation`` takes the rotation from the essential matrix
    of L(t0) -> L(t1) (``find_essential_ransac``, the reference's optional
    branch, src/visualOdometry.cpp:152-157) and the translation from PnP.
    Each frame draws PnP's uniforms and then the essential RANSAC's from
    the sequence's generator, in that order."""
    dev = resolve_device(device)
    P_l = torch.as_tensor(intrinsics.proj_left(), device=dev)
    P_r = torch.as_tensor(intrinsics.proj_right(), device=dev)
    K = torch.as_tensor(intrinsics.intrinsic_matrix(), device=dev)
    params = _lk_params(config)
    floor = config.resolved_min_accept_inliers()
    zero3 = torch.zeros(3, dtype=torch.float32, device=dev)
    safe3d = torch.tensor([0.0, 0.0, 10.0], dtype=torch.float32, device=dev)

    def step(state: VOState, left_t1, right_t1, uniforms=None,
             ess_uniforms=None):
        lk_l1 = _prep_image(left_t1, config, dev)
        lk_r1 = _prep_image(right_t1, config, dev)

        pad = state.lk_l0.pad
        h, w = state.lk_l0.shapes[0]
        raw_l0 = state.lk_l0.pyramid[0][..., pad:pad + h, pad:pad + w]
        bucketed = detect_and_bucket(raw_l0, state.features, config)

        match, fallback = skip_mode_match(state.lk_l0, state.lk_r0, lk_l1,
                                          lk_r1, bucketed, params, config)

        pts3d = triangulate_points(P_l, P_r, match.points_l0, match.points_r0)
        pts3d = torch.where(match.valid[..., None], pts3d, safe3d)

        pnp = pnp_ransac(pts3d, match.points_l1, match.valid, K, zero3,
                         state.tvec, generator=state.generator,
                         iterations=config.ransac_iterations,
                         reproj_threshold=config.ransac_reproj_threshold,
                         sample_size=config.ransac_sample_size,
                         refine_iters=config.pnp_refine_iters,
                         uniforms=uniforms)

        rvec_out = pnp.rvec
        if config.mono_rotation:
            ess = find_essential_ransac(
                match.points_l0, match.points_l1, match.valid,
                float(intrinsics.fx), (float(intrinsics.cx),
                                       float(intrinsics.cy)),
                generator=state.generator, uniforms=ess_uniforms)
            rvec_out = rodrigues_inverse(ess.R)

        gate = gate_and_integrate(rvec_out, pnp.tvec)
        accept = gate.accept
        if floor > 0:
            # Beyond-reference scene-cut / tracking-loss floor.
            accept = accept & (pnp.num_inliers >= floor)
        # Only an accepted solution may seed the next solve.
        keep = accept & config.use_extrinsic_guess
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


def _frame_chunks(it, chunk: int):
    """Yield (lefts (k, H, W), rights (k, H, W), k) numpy stacks of up to
    ``chunk`` frames from an iterator of (left, right) frames."""
    while True:
        frames = list(itertools.islice(it, chunk))
        if not frames:
            return
        yield (np.stack([np.asarray(l) for l, _ in frames]),
               np.stack([np.asarray(r) for _, r in frames]), len(frames))


def _run_chunk(step, state: VOState, lefts, rights, device):
    """Step over one chunk of frames (numpy or tensors, uploaded in one copy
    each); outputs stay on the device, stacked: (state, StepOutput) or, for
    a step made ``with_tracks``, (state, StepOutput, TrackSnapshot)."""
    dl = torch.as_tensor(lefts).to(device)
    dr = torch.as_tensor(rights).to(device)
    outs = []
    for i in range(dl.shape[0]):
        state, *out = step(state, dl[i], dr[i])
        outs.append(out)
    return (state,) + tuple(type(o[0])(*(torch.stack(x) for x in zip(*o)))
                            for o in zip(*outs))


def _fetch(out):
    return type(out)(*(x.cpu().numpy() for x in out))


def run_sequence_scan(frames, config: VOConfig, intrinsics: CameraIntrinsics,
                      seed: int = 0, chunk: int = 32, warmup: bool = True,
                      collect_tracks: bool = False, device=None):
    """Chunked sequence runner, the throughput front door.

    ``frames`` is any iterable of (left, right) uint8 images; host memory
    holds one chunk at a time. Each chunk is uploaded in one copy, stepped
    frame by frame on the device, and its outputs are fetched once.

    Returns (poses (N+1, 4, 4) f64, fetched StepOutput of numpy arrays,
    wall_seconds, frames_processed). ``wall_seconds`` covers the steady-state
    loop (uploads included); with ``warmup`` the first chunk runs once on a
    throwaway state first, so one-time costs (kernel build and load, CUDA
    library initialisation) stay out of it.
    With ``collect_tracks``, a fifth element: the per-frame TrackSnapshot
    list (numpy, frame i+1's snapshot at index i, the
    ``ba.window.smooth_trajectory_ba`` input), stacked on the device per
    chunk and fetched with the chunk's outputs.
    """
    dev = resolve_device(device)
    it = iter(frames)
    try:
        frame0 = next(it)
    except StopIteration:
        raise ValueError("run_sequence_scan needs at least one frame") from None
    step = make_step_fn(config, intrinsics, with_tracks=collect_tracks,
                        device=dev)
    chunks = _frame_chunks(it, chunk)
    first = next(chunks, None)
    if first is None:
        return np.eye(4)[None].astype(np.float64), None, 0.0, 0

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    if warmup:
        wstate = init_vo_state(config, intrinsics, *frame0, seed=seed, device=dev)
        _fetch(_run_chunk(step, wstate, first[0], first[1], dev)[1])

    state = init_vo_state(config, intrinsics, *frame0, seed=seed, device=dev)
    sync()
    t0 = time.perf_counter()
    fetched_list = []
    n = 0
    cur = first
    while cur is not None:
        lefts, rights, n_real = cur
        state, *outs = _run_chunk(step, state, lefts, rights, dev)
        fetched_list.append([_fetch(o) for o in outs])
        n += n_real
        cur = next(chunks, None)
    wall = time.perf_counter() - t0

    fetched, *tracks = (type(xs[0])(*(np.concatenate(x) for x in zip(*xs)))
                        for xs in zip(*fetched_list))
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
    device it was saved from)."""
    dev = resolve_device(device)

    def t(k, dtype):
        return torch.tensor(np.asarray(ckpt[k]), dtype=dtype, device=dev)

    gen = torch.Generator(device=dev)
    gen.set_state(torch.from_numpy(np.asarray(ckpt["gen_state"], np.uint8)))
    return VOState(
        features=FeatureState(
            points=t("points", torch.float32), ages=t("ages", torch.int32),
            valid=t("valid", torch.bool), ids=t("ids", torch.int32),
            next_id=t("next_id", torch.int32), flow=t("flow", torch.float32),
            disp=t("disp", torch.float32)),
        lk_l0=_prep_image(left_t0, config, dev),
        lk_r0=_prep_image(right_t0, config, dev),
        tvec=t("tvec", torch.float32), generator=gen)


def _make_snapshot_packer(config: VOConfig):
    """VOState -> (f32 vector, i32 vector) on the device, so a snapshot's
    device-to-host traffic is two copies and not eight; the generator's
    state travels beside them (it lives on the host)."""

    def pack(state: VOState):
        f = state.features
        f32 = torch.cat([f.points.reshape(-1), f.flow.reshape(-1),
                         f.disp.reshape(-1), state.tvec.to(torch.float32)])
        i32 = torch.cat([f.ages.to(torch.int32), f.valid.to(torch.int32),
                         f.ids.to(torch.int32),
                         f.next_id.reshape(1).to(torch.int32)])
        return f32, i32

    return pack


def _unpack_snapshot(config: VOConfig, f32: np.ndarray, i32: np.ndarray,
                     gen_state: np.ndarray) -> dict:
    """Host-side inverse of ``_make_snapshot_packer``'s layout."""
    P = config.padded_features
    return {
        "points": f32[:2 * P].reshape(P, 2),
        "flow": f32[2 * P:4 * P].reshape(P, 2),
        "disp": f32[4 * P:6 * P].reshape(P, 2),
        "tvec": f32[6 * P:6 * P + 3],
        "ages": i32[:P],
        "valid": i32[P:2 * P] != 0,
        "ids": i32[2 * P:3 * P],
        "next_id": i32[3 * P],
        "gen_state": np.asarray(gen_state, np.uint8),
    }


def run_sequence_scan_resumable(seq, config: VOConfig,
                                intrinsics: CameraIntrinsics,
                                checkpoint_path: str,
                                checkpoint_every: int = 256, chunk: int = 64,
                                seed: int = 0, max_frames: int = 0,
                                warmup: bool = True, verbose: bool = False,
                                collect_tracks: bool = False,
                                snapshot_stats: Optional[list] = None,
                                device=None):
    """The chunked runner with chunk-boundary checkpoints and crash resume.

    ``seq`` is random access (``len`` and ``.frame(i)``): a snapshot stores
    no image, and frame t0's pyramids are rebuilt from
    ``seq.frame(frames_done)`` at resume. A snapshot is written every
    ``checkpoint_every`` steps, rounded up to a whole number of chunks, so
    a resumed run's chunks line up with an uninterrupted one's; each is the
    state packed into two device-to-host copies, the generator's state,
    and the outputs (and, ``collect_tracks``, the track snapshots) so far,
    written atomically. An existing snapshot at ``checkpoint_path`` is
    resumed from; one that already covers the run returns its outputs and
    reads no frame. A snapshot that cannot be trusted (torn, a key missing,
    a cursor past the end, no tracks for a ``collect_tracks`` run) is
    rejected with a warning on stderr and the run starts fresh.

    Returns (poses (N+1, 4, 4) f64, fetched StepOutput stack (numpy),
    wall_seconds, steps processed by this call) and, ``collect_tracks``,
    the per-frame TrackSnapshot list. The wall covers this call's loop,
    snapshots included. ``snapshot_stats``, a list, gets one
    ``{"step", "ms", "bytes"}`` per snapshot written (pack, copies and
    write).
    """
    dev = resolve_device(device)
    n_total = len(seq) if not max_frames else min(len(seq), max_frames)
    n_steps = n_total - 1
    ck_chunks = max(1, -(-checkpoint_every // chunk))

    start_step, prev_fetched, prev_tracks, state = 0, None, None, None
    if checkpoint_path and os.path.exists(checkpoint_path):
        try:
            ck = load_scan_checkpoint(checkpoint_path)
            start_step = int(ck["frames_done"])
            if start_step > n_steps:
                raise CorruptCheckpoint(
                    f"cursor {start_step} beyond sequence ({n_steps} steps)")
            prev_fetched = StepOutput(**{k: ck["out_" + k]
                                         for k in StepOutput._fields})
            if collect_tracks:
                missing = [k for k in TrackSnapshot._fields
                           if "trk_" + k not in ck]
                if missing:
                    raise CorruptCheckpoint(
                        f"snapshot carries no track snapshots (missing "
                        f"trk_{missing[0]}): cannot resume a collect_tracks "
                        f"run from it")
                prev_tracks = TrackSnapshot(**{k: ck["trk_" + k]
                                               for k in TrackSnapshot._fields})
            if start_step < n_steps:
                state = restore_scan_state(config, intrinsics, ck,
                                           *seq.frame(start_step), device=dev)
            if verbose:
                print(f"resumed scan from {checkpoint_path} at step "
                      f"{start_step}")
        except CorruptCheckpoint as e:
            print(f"warning: rejecting corrupt checkpoint: {e}",
                  file=sys.stderr)
            start_step, prev_fetched, prev_tracks, state = 0, None, None, None

    def finish(fetched, tracks, wall, processed):
        poses = chain_poses_host(fetched.T_inv, fetched.accept)
        if collect_tracks:
            return poses, fetched, wall, processed, [
                TrackSnapshot(*(x[i] for x in tracks))
                for i in range(len(tracks.valid))]
        return poses, fetched, wall, processed

    if start_step >= n_steps and prev_fetched is not None:
        return finish(prev_fetched, prev_tracks, 0.0, 0)
    if n_steps < 1:
        raise ValueError("run_sequence_scan_resumable needs at least two "
                         "frames")
    if state is None:
        state = init_vo_state(config, intrinsics, *seq.frame(0), seed=seed,
                              device=dev)
    step = make_step_fn(config, intrinsics, with_tracks=collect_tracks,
                        device=dev)
    pack = _make_snapshot_packer(config)
    if warmup:
        # One step on a throwaway state: kernel build and load, library
        # initialisation. The run's own generator is not touched.
        lw, rw = seq.frame(start_step + 1)
        wstate = init_vo_state(config, intrinsics, lw, rw, seed=seed,
                               device=dev)
        _fetch(_run_chunk(step, wstate, np.asarray(lw)[None],
                          np.asarray(rw)[None], dev)[1])

    parts = [[prev_fetched] if prev_fetched is not None else [],
             [prev_tracks] if prev_tracks is not None else []]

    def stacked(k):
        xs = parts[k]
        return type(xs[0])(*(np.concatenate(x) for x in zip(*xs)))

    frames = (seq.frame(i) for i in range(start_step + 1, n_total))
    steps_done = start_step
    full_chunks = 0
    t0 = time.perf_counter()
    for lefts, rights, n_real in _frame_chunks(frames, chunk):
        state, *outs = _run_chunk(step, state, lefts, rights, dev)
        for k, o in enumerate(outs):
            parts[k].append(_fetch(o))
        steps_done += n_real
        if n_real != chunk:
            continue
        full_chunks += 1
        if checkpoint_path and full_chunks % ck_chunks == 0:
            ts = time.perf_counter()
            f32, i32 = pack(state)
            arrays = _unpack_snapshot(config, f32.cpu().numpy(),
                                      i32.cpu().numpy(),
                                      state.generator.get_state().numpy())
            size = save_scan_checkpoint(
                checkpoint_path, steps_done, arrays, stacked(0),
                tracks=stacked(1) if collect_tracks else None)
            if snapshot_stats is not None:
                snapshot_stats.append({
                    "step": steps_done, "bytes": size,
                    "ms": 1e3 * (time.perf_counter() - ts)})
            if verbose:
                print(f"checkpoint @ step {steps_done}")
    wall = time.perf_counter() - t0
    return finish(stacked(0), stacked(1) if collect_tracks else None, wall,
                  steps_done - start_step)
