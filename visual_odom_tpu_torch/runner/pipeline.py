"""The VO pipeline: the per-frame step and the chunked sequence runner.

Port of ``visual_odom_tpu/runner/pipeline.py`` (``VOState``,
``StepOutput``, ``make_step_fn``, ``init_vo_state``, ``run_sequence_scan``,
``chain_poses_host``). One step takes the new stereo pair to the 4x4 frame
delta: pyramids of the new pair (reused as t0 next frame), FAST + bucketing
on L(t0), the circular LK quad under the adaptive skip policy,
triangulation, PnP-RANSAC, and the rotation / scale / inlier-floor gates.
Everything stays on the device; the runner fetches outputs once per chunk
and chains poses in float64 on the host.

The entry points run on CUDA unless ``device="cpu"`` is passed, and raise
when CUDA is asked for and absent.
"""

from __future__ import annotations

import itertools
import time
from typing import NamedTuple

import numpy as np
import torch

from visual_odom_tpu_torch import resolve_device
from visual_odom_tpu_torch.backend.integrate import gate_and_integrate
from visual_odom_tpu_torch.backend.pnp import pnp_ransac
from visual_odom_tpu_torch.config import CameraIntrinsics, VOConfig
from visual_odom_tpu_torch.core.triangulate import triangulate_points
from visual_odom_tpu_torch.frontend.bucketing import detect_and_bucket
from visual_odom_tpu_torch.frontend.featureset import (FeatureState,
                                                       empty_feature_state)
from visual_odom_tpu_torch.frontend.matching import (commit_tracked_state,
                                                     skip_mode_match)
from visual_odom_tpu_torch.ops.lk import LKImage, LKParams, prepare_lk_image


class VOState(NamedTuple):
    """Device-resident state carried across frames."""

    features: FeatureState     # tracked features, positions in L(t0)
    lk_l0: LKImage             # prepared pyramid of L(t0)
    lk_r0: LKImage             # prepared pyramid of R(t0)
    tvec: torch.Tensor         # (3,) warm-start translation
    generator: torch.Generator  # RANSAC sampling


class StepOutput(NamedTuple):
    """Small per-frame outputs."""

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


def _lk_params(config: VOConfig) -> LKParams:
    return LKParams(window=config.lk_window, levels=config.lk_levels,
                    max_iters=config.lk_max_iters, eps=config.lk_eps,
                    min_eig_threshold=config.lk_min_eig_threshold)


def _prep_image(img, config: VOConfig, device: torch.device) -> LKImage:
    img = torch.as_tensor(img).to(device=device, dtype=torch.float32)
    return prepare_lk_image(img, _lk_params(config))


def init_vo_state(config: VOConfig, intrinsics: CameraIntrinsics, left0,
                  right0, seed: int = 0, device=None) -> VOState:
    """State from frame 0: no features, frame 0's pyramids, zero warm start
    and a RANSAC generator seeded with ``seed``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return VOState(
        features=empty_feature_state(config.padded_features, device=dev),
        lk_l0=_prep_image(left0, config, dev),
        lk_r0=_prep_image(right0, config, dev),
        tvec=torch.zeros(3, dtype=torch.float32, device=dev),
        generator=gen)


def make_step_fn(config: VOConfig, intrinsics: CameraIntrinsics, device=None):
    """Build the per-frame step ``step(state, left_t1, right_t1,
    uniforms=None) -> (new_state, StepOutput)``. ``uniforms`` (iterations,
    padded_features) replaces the RANSAC draw (parity tests)."""
    dev = resolve_device(device)
    if config.mono_rotation:
        raise NotImplementedError("mono_rotation is not ported")
    P_l = torch.as_tensor(intrinsics.proj_left(), device=dev)
    P_r = torch.as_tensor(intrinsics.proj_right(), device=dev)
    K = torch.as_tensor(intrinsics.intrinsic_matrix(), device=dev)
    params = _lk_params(config)
    floor = config.resolved_min_accept_inliers()
    zero3 = torch.zeros(3, dtype=torch.float32, device=dev)
    safe3d = torch.tensor([0.0, 0.0, 10.0], dtype=torch.float32, device=dev)

    def step(state: VOState, left_t1, right_t1, uniforms=None):
        lk_l1 = _prep_image(left_t1, config, dev)
        lk_r1 = _prep_image(right_t1, config, dev)

        pad = state.lk_l0.pad
        h, w = state.lk_l0.shapes[0]
        raw_l0 = state.lk_l0.pyramid[0][pad:pad + h, pad:pad + w]
        bucketed = detect_and_bucket(raw_l0, state.features, config)

        match, fallback = skip_mode_match(state.lk_l0, state.lk_r0, lk_l1,
                                          lk_r1, bucketed, params, config)

        pts3d = triangulate_points(P_l, P_r, match.points_l0, match.points_r0)
        pts3d = torch.where(match.valid[:, None], pts3d, safe3d)

        pnp = pnp_ransac(pts3d, match.points_l1, match.valid, K, zero3,
                         state.tvec, generator=state.generator,
                         iterations=config.ransac_iterations,
                         reproj_threshold=config.ransac_reproj_threshold,
                         sample_size=config.ransac_sample_size,
                         refine_iters=config.pnp_refine_iters,
                         uniforms=uniforms)

        gate = gate_and_integrate(pnp.rvec, pnp.tvec)
        accept = gate.accept
        if floor > 0:
            # Beyond-reference scene-cut / tracking-loss floor.
            accept = accept & (pnp.num_inliers >= floor)
        # Only an accepted solution may seed the next solve.
        keep = accept & config.use_extrinsic_guess
        new_state = VOState(features=commit_tracked_state(match), lk_l0=lk_l1,
                            lk_r0=lk_r1, tvec=torch.where(keep, pnp.tvec, zero3),
                            generator=state.generator)
        out = StepOutput(
            T_inv=gate.T_inv, accept=accept, scale=gate.scale,
            euler=gate.euler, rvec=pnp.rvec, tvec=pnp.tvec,
            num_inliers=pnp.num_inliers,
            num_matched=match.valid.sum().to(torch.int32),
            num_bucketed=bucketed.valid.sum().to(torch.int32),
            fallback=fallback)
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
    """Step over one uploaded chunk; outputs stay on the device, stacked."""
    dl = torch.from_numpy(lefts).to(device)
    dr = torch.from_numpy(rights).to(device)
    outs = []
    for i in range(dl.shape[0]):
        state, out = step(state, dl[i], dr[i])
        outs.append(out)
    return state, StepOutput(*(torch.stack(x) for x in zip(*outs)))


def _fetch(out: StepOutput) -> StepOutput:
    return StepOutput(*(x.cpu().numpy() for x in out))


def run_sequence_scan(frames, config: VOConfig, intrinsics: CameraIntrinsics,
                      seed: int = 0, chunk: int = 32, warmup: bool = True,
                      device=None):
    """Chunked sequence runner, the throughput front door.

    ``frames`` is any iterable of (left, right) uint8 images; host memory
    holds one chunk at a time. Each chunk is uploaded in one copy, stepped
    frame by frame on the device, and its outputs are fetched once.

    Returns (poses (N+1, 4, 4) f64, fetched StepOutput of numpy arrays,
    wall_seconds, frames_processed). ``wall_seconds`` covers the steady-state
    loop (uploads included); with ``warmup`` the first chunk runs once on a
    throwaway state first, so one-time costs (kernel build and load, CUDA
    library initialisation) stay out of it.
    """
    dev = resolve_device(device)
    it = iter(frames)
    try:
        frame0 = next(it)
    except StopIteration:
        raise ValueError("run_sequence_scan needs at least one frame") from None
    step = make_step_fn(config, intrinsics, device=dev)
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
        state, out = _run_chunk(step, state, lefts, rights, dev)
        fetched_list.append(_fetch(out))
        n += n_real
        cur = next(chunks, None)
    wall = time.perf_counter() - t0

    fetched = StepOutput(*(np.concatenate(xs) for xs in zip(*fetched_list)))
    poses = chain_poses_host(fetched.T_inv, fetched.accept)
    return poses, fetched, wall, n
