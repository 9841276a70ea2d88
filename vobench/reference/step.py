"""The plain VO step and a runner that steps whole clips through it.

Frozen copy of the eager step of ``visual_odom_tpu_torch/runner/
pipeline.py`` at commit 245329126dfa (``VOState``, ``StepOutput``,
``prep_image``, ``init_vo_state`` in its batched form,
``make_frontend_fn``, ``make_backend_fn``, ``make_step_fn``,
``chain_poses_host``), on the plain LK quad (``reference.lk``). The state
always carries a leading B (one clip is B = 1).

``run_clips`` is this package's own: it steps B clips from their first
frame, each with its own seeded RANSAC generator, drawn in the
program's order (PnP's (iterations, N) uniforms, then, with
``mono_rotation``, the essential RANSAC's (200, N)). On a card the step is
captured once as a CUDA graph (the draws are made eagerly and handed in),
so the reference takes a fraction of the eager time; on the CPU it steps
eagerly.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from vobench.reference.config import CameraIntrinsics, VOConfig
from vobench.reference.bucketing import detect_and_bucket
from vobench.reference.essential import find_essential_ransac
from vobench.reference.featureset import FeatureState, empty_feature_state
from vobench.reference.integrate import gate_and_integrate
from vobench.reference.lie import rodrigues_inverse
from vobench.reference.lk import LKImage, LKParams, prepare_lk_image
from vobench.reference.matching import (commit_tracked_state, skip_mode_back,
                                        skip_mode_front)
from vobench.reference.pnp import pnp_ransac
from vobench.reference.triangulate import triangulate_points

#: the essential RANSAC's hypotheses a frame (``find_essential_ransac``)
ESSENTIAL_ITERATIONS = 200


class VOState(NamedTuple):
    features: FeatureState
    lk_l0: LKImage
    lk_r0: LKImage
    tvec: torch.Tensor         # (B, 3) warm-start translation


class StepOutput(NamedTuple):
    T_inv: torch.Tensor         # (B, 4, 4) frame delta inverse (f32)
    accept: torch.Tensor        # (B,) bool
    num_inliers: torch.Tensor   # (B,) int32
    num_matched: torch.Tensor   # (B,) int32
    fallback: torch.Tensor      # (B,) bool, re-tracked at the safe level


def lk_params(config: VOConfig) -> LKParams:
    return LKParams(window=config.lk_window, levels=config.lk_levels,
                    max_iters=config.lk_max_iters, eps=config.lk_eps,
                    min_eig_threshold=config.lk_min_eig_threshold)


def prep_image(img, config: VOConfig, device) -> LKImage:
    img = torch.as_tensor(img).to(device=device, dtype=torch.float32)
    return prepare_lk_image(img, lk_params(config))


def init_state(config: VOConfig, lefts, rights, device) -> VOState:
    """State from (B, H, W) first frames: no features, their pyramids and
    zero warm starts."""
    B = lefts.shape[0]
    return VOState(
        features=empty_feature_state(config.padded_features, batch=(B,),
                                     device=device),
        lk_l0=prep_image(lefts, config, device),
        lk_r0=prep_image(rights, config, device),
        tvec=torch.zeros((B, 3), dtype=torch.float32, device=device))


class Step(NamedTuple):
    """The step in two halves, ``front(state, lefts, rights) -> ctx`` and
    ``back(state, ctx, uniforms, ess_uniforms, safe) -> (state,
    StepOutput)``; ``ctx.aliased`` (None in the "fixed" skip mode) says
    whether ``back`` needs the safe quad (``safe``)."""

    front: object
    back: object

    def __call__(self, state, lefts, rights, uniforms, ess_uniforms=None):
        ctx = self.front(state, lefts, rights)
        return self.back(state, ctx, uniforms, ess_uniforms,
                         needs_safe(ctx))


class Ctx(NamedTuple):
    lk_l1: LKImage
    lk_r1: LKImage
    bucketed: FeatureState
    match: object              # matching.CircularMatchResult
    aliased: object            # (B,) bool, or None


def needs_safe(ctx: Ctx) -> bool:
    """Whether any sequence is aliased (a host read)."""
    return ctx.aliased is not None and bool(ctx.aliased.any())


def make_step_fn(config: VOConfig, intrinsics: CameraIntrinsics, device,
                 recorder=None) -> Step:
    """The step over (B, H, W) frames, ``uniforms`` (B, iterations, N)
    being PnP's draws and ``ess_uniforms`` (B, 200, N) the essential
    RANSAC's (None without ``mono_rotation``)."""
    params = lk_params(config)
    P_l = torch.as_tensor(intrinsics.proj_left(), device=device)
    P_r = torch.as_tensor(intrinsics.proj_right(), device=device)
    K = torch.as_tensor(intrinsics.intrinsic_matrix(), device=device)
    floor = config.resolved_min_accept_inliers()
    zero3 = torch.zeros(3, dtype=torch.float32, device=device)
    safe3d = torch.tensor([0.0, 0.0, 10.0], dtype=torch.float32,
                          device=device)

    def front(state: VOState, lefts, rights) -> Ctx:
        lk_l1 = prep_image(lefts, config, device)
        lk_r1 = prep_image(rights, config, device)
        pad = state.lk_l0.pad
        h, w = state.lk_l0.shapes[0]
        raw_l0 = state.lk_l0.pyramid[0][..., pad:pad + h, pad:pad + w]
        bucketed = detect_and_bucket(raw_l0, state.features, config)
        match, aliased = skip_mode_front(state.lk_l0, state.lk_r0, lk_l1,
                                         lk_r1, bucketed, params, config,
                                         recorder=recorder)
        return Ctx(lk_l1, lk_r1, bucketed, match, aliased)

    def back(state: VOState, ctx: Ctx, uniforms, ess_uniforms, safe: bool):
        match, fallback = skip_mode_back(
            state.lk_l0, state.lk_r0, ctx.lk_l1, ctx.lk_r1, ctx.bucketed,
            params, config, ctx.match, ctx.aliased, safe, recorder=recorder)
        pts3d = triangulate_points(P_l, P_r, match.points_l0,
                                   match.points_r0)
        pts3d = torch.where(match.valid[..., None], pts3d, safe3d)
        pnp = pnp_ransac(pts3d, match.points_l1, match.valid, K, zero3,
                         state.tvec, iterations=config.ransac_iterations,
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
                iterations=ESSENTIAL_ITERATIONS, uniforms=ess_uniforms)
            rvec_out = rodrigues_inverse(ess.R)
        gate = gate_and_integrate(rvec_out, pnp.tvec)
        accept = gate.accept
        if floor > 0:
            accept = accept & (pnp.num_inliers >= floor)
        keep = accept & config.use_extrinsic_guess
        new_state = VOState(features=commit_tracked_state(match),
                            lk_l0=ctx.lk_l1, lk_r0=ctx.lk_r1,
                            tvec=torch.where(keep[..., None], pnp.tvec,
                                             zero3))
        out = StepOutput(
            T_inv=gate.T_inv, accept=accept, num_inliers=pnp.num_inliers,
            num_matched=match.valid.sum(dim=-1).to(torch.int32),
            fallback=fallback)
        return new_state, out

    return Step(front, back)


def chain_poses(T_inv: np.ndarray, accept: np.ndarray) -> np.ndarray:
    """Float64 chaining of per-frame deltas; (N+1, 4, 4) with the identity
    start pose."""
    poses = np.empty((len(T_inv) + 1, 4, 4))
    pose = np.eye(4)
    poses[0] = pose
    for i in range(len(T_inv)):
        if accept[i]:
            pose = pose @ np.asarray(T_inv[i], np.float64)
        poses[i + 1] = pose
    return poses


class QuadRecord(NamedTuple):
    """One circular quad of a step, as the LK work count reads it."""

    shapes: tuple               # level -> (H_l, W_l)
    pad: int
    pts: torch.Tensor           # (B, n, 2) quad start points
    valid: torch.Tensor         # (B, n)
    out: torch.Tensor           # (4, B, n, 2) per-leg positions
    iters: torch.Tensor         # (B, 4, levels, n) updates
    start_level: int


class _Draws:
    """Each clip's generator, drawn in the program's order each step."""

    def __init__(self, config: VOConfig, seeds, device):
        self.config = config
        self.device = device
        self.gens = []
        for s in seeds:
            g = torch.Generator(device=device)
            g.manual_seed(s)
            self.gens.append(g)

    def __call__(self, n: int):
        dev = self.device
        u = torch.stack([torch.rand((self.config.ransac_iterations, n),
                                    generator=g, device=dev)
                         for g in self.gens])
        e = (torch.stack([torch.rand((ESSENTIAL_ITERATIONS, n), generator=g,
                                     device=dev) for g in self.gens])
             if self.config.mono_rotation else None)
        return u, e


def _tensors(tree) -> list:
    """The tensors of a state or output tree, in a fixed order."""
    out = []
    for x in tree:
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (tuple, list)):
            out.extend(_tensors(x))
    return out


def run_clips(config: VOConfig, intrinsics: CameraIntrinsics, lefts, rights,
              seeds, device, record_steps=()):
    """Step B clips (``lefts``, ``rights``: (B, T, H, W) uint8 arrays or
    tensors) from their first frame through all T - 1 steps, clip b's
    RANSAC generator seeded ``seeds[b]``.

    Returns (per-step numpy ``StepOutput`` stacked (T - 1, B, ...), LK
    records): at each step named in ``record_steps`` (1-based frame
    indices) every quad of the step adds a (step, ``QuadRecord``) pair,
    for the LK work count. On a card the steps replay one CUDA graph."""
    device = torch.device(device)
    lefts = torch.as_tensor(lefts)
    rights = torch.as_tensor(rights)
    B, T = lefts.shape[:2]
    draws = _Draws(config, seeds, device)
    n = config.padded_features
    record_steps = set(record_steps)
    records = []
    captured = []

    def recorder(images, pts, valid, out, iters, sl):
        captured.append((images, pts, valid, out, iters, sl))

    step = make_step_fn(config, intrinsics, device, recorder=recorder)
    dev_l = lefts.to(device)
    dev_r = rights.to(device)
    state = init_state(config, dev_l[:, 0], dev_r[:, 0], device)
    outs = []

    def keep_records(i, quads):
        for images, pts, valid, out, iters, sl in quads:
            records.append((i, QuadRecord(
                images[0].shapes, images[0].pad, pts.clone(), valid.clone(),
                out.clone(), iters.clone(), sl)))

    if device.type != "cuda":
        for i in range(1, T):
            captured.clear()
            u, e = draws(n)
            state, out = step(state, dev_l[:, i], dev_r[:, i], u, e)
            outs.append(out)
            if i in record_steps:
                keep_records(i, captured)
        return _stack(outs), records

    # CUDA graphs: the front half, then the back half with the safe quad
    # and without it, picked per step by a host read of ``aliased``. The
    # state, frames and draws sit in static buffers. Each half runs
    # eagerly once on a side stream first (it builds the cached band
    # matrices and tables); the recorder's quads are the graphs' static
    # tensors, cloned after each recorded replay.
    u, e = draws(n)
    s_state = [x.clone() for x in _tensors(state)]
    s_l = dev_l[:, 1].clone()
    s_r = dev_r[:, 1].clone()
    s_u = u.clone()
    s_e = None if e is None else e.clone()
    s_tree = _rebuild(state, s_state)
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        ctx = step.front(s_tree, s_l, s_r)
        for safe in (True, False):
            step.back(s_tree, ctx, s_u, s_e, safe)
    torch.cuda.current_stream(device).wait_stream(side)

    def capture(fn):
        captured.clear()
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g, capture_error_mode="thread_local"):
            res = fn()
        return g, res, list(captured)

    g_front, ctx, q_front = capture(lambda: step.front(s_tree, s_l, s_r))
    backs = {safe: capture(lambda: step.back(s_tree, ctx, s_u, s_e, safe))
             for safe in (True, False)}
    for i in range(1, T):
        if i > 1:
            u, e = draws(n)
        s_u.copy_(u)
        if s_e is not None:
            s_e.copy_(e)
        s_l.copy_(dev_l[:, i])
        s_r.copy_(dev_r[:, i])
        g_front.replay()
        g_back, (g_state, g_out), q_back = backs[needs_safe(ctx)]
        g_back.replay()
        outs.append(StepOutput(*(x.clone() for x in g_out)))
        if i in record_steps:
            keep_records(i, q_front + q_back)
        for dst, src in zip(s_state, _tensors(g_state)):
            dst.copy_(src)
    torch.cuda.synchronize(device)
    del g_front, backs
    return _stack(outs), records


def _rebuild(tree, flat: list):
    """``tree`` (a state NamedTuple) with its tensors replaced, in
    ``_tensors`` order, by ``flat``."""
    it = iter(flat)

    def walk(x):
        if isinstance(x, torch.Tensor):
            return next(it)
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            return type(x)(*(walk(y) for y in x))
        if isinstance(x, (tuple, list)):
            return type(x)(walk(y) for y in x)
        return x

    return walk(tree)


def _stack(outs) -> StepOutput:
    return StepOutput(*(torch.stack(xs).cpu().numpy() for xs in zip(*outs)))
