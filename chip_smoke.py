#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one GPU and check it.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an NVIDIA Hopper card and
the CUDA toolkit. Phases (each raises on failure; nothing is caught):

1. Print the card's name and power limit (nvidia-smi).
2. Build the CUDA kernel from ``visual_odom_tpu_torch/csrc`` with nvcc and
   print the build seconds and the ptxas report.
3. Hold the LK quad kernel against its plain PyTorch version at KITTI size
   (1241x376) on the inputs the main path gives it: the fast quad (start
   level 1, 384 slots), the probe (start level 2, 64 slots), the safe quad
   (start level 2, 384 slots) and the safe quad as the adaptive policy
   launches it on a frame that is not aliased (all slots masked off).
   Statuses may differ on at most STATUS_MISMATCH_MAX features, tracks that
   agree within PT_TOL px. Times the kernel's device work (CUDA events
   around a batch of calls queued behind a sleep kernel), one wrapper call
   with the host's time included, and the plain version.
4. Run the main path, ``run_sequence_scan``, at 1241x376: 64 steps of the
   "straight" course and 160 steps of "straight" with the periodic "checker"
   texture (which exercises the adaptive fallback). Assert the bench gates
   (accept >= 0.9, ATE <= 1% of course length) and that the kernel ran
   LAUNCHES_PER_FRAME times per frame. The checker course runs at the
   length the JAX package's texture ablation was gated at
   (TEXTURE_ABLATION_r05.json, adaptive row: 0.834 m of 1.28 m): at 32
   steps the JAX package misses the ATE budget too (0.508 m of 0.256 m on
   the CPU: ``python tests/test_torch_pipeline.py lockstep 32``).
5. Hold the card's step against the port's CPU step (the plain version,
   itself held to the JAX package by the CPU tests) on a small course fed
   the same RANSAC draws.
6. Check that a main-path step never synchronises with the host (CUDA sync
   debug mode "error"), then profile a few frames: device time by kernel,
   device ops per frame and the device's busy share.

Prints the ``{"kernels": [...]}`` line, the card line, and last
``{"ok": true, "device": {...}}``. Exits non-zero without a card, or when
the port is not beside this script.
"""

from __future__ import annotations

import concurrent.futures
import json
import os
import subprocess
import sys
import time

import numpy as np

H, W = 376, 1241
STRAIGHT_STEPS = 64
CHECKER_STEPS = 160
CHUNK = 32
LAUNCHES_PER_FRAME = 3        # fast quad + probe + safe quad (masked)
STATUS_MISMATCH_MAX = 2       # hard thresholds can flip a feature or two
PT_TOL = 1e-3                 # px, on tracks whose statuses agree
#: H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, fp32 non-tensor FLOP/s
PEAK_BYTES_S = 3.35e12
PEAK_FP32_FLOPS = 67e12
#: ~25 ms of torch.cuda._sleep at the H100's 1980 MHz boost clock: longer
#: than the host takes to issue a timed batch of kernel calls
SLEEP_CYCLES = 50_000_000
#: per-(feature, leg, level) template setup, as the plain version computes
#: it: separable Scharr (8 flops per px of the 22x24 vertical pass and of the
#: 22x22 horizontal pass), three 21x21 bilinears (7 flops/px), G (6
#: flops/px), the gate
SETUP_FLOPS = 8 * 22 * 24 + 8 * 22 * 22 + 441 * (3 * 7 + 6) + 30
#: per update: 21x21 bilinear (7), diff (1), b1 and b2 (4), reductions, 2x2
ITER_FLOPS = 441 * 12 + 100
#: side of the template superblock (21x21 window + bilinear + Scharr support)
BLOCK = 24
#: per-feature inputs (pts, flow, disp, valid) and outputs (4 legs, status)
FEATURE_BYTES = (2 + 2 + 2 + 1) * 4 + (4 * 2 + 1) * 4
REPLACES = "visual_odom_tpu/ops/lk_pallas.py:299"
SOURCE = "visual_odom_tpu_torch/csrc/lk_legs.cu"


def kitti_intrinsics(height: int, width: int):
    """The bench's camera: KITTI 00 focal length scaled to the width."""
    from visual_odom_tpu_torch.config import CameraIntrinsics

    s = width / 1241.0
    return CameraIntrinsics(fx=718.856 * s, fy=718.856 * s, cx=width / 2.0,
                            cy=height / 2.0, bf=-718.856 * s * 0.537,
                            width=width, height=height)


def render_courses(specs, height, width):
    """{(name, family): (frames, gt poses)}: each course is built once and
    its frames rendered on a thread pool (numpy releases the GIL)."""
    from visual_odom_tpu_torch.io.synthetic import make_course

    intr = kitti_intrinsics(height, width)
    out = {}
    with concurrent.futures.ThreadPoolExecutor(os.cpu_count() or 1) as ex:
        for name, family, n in specs:
            seq = make_course(name, intr, num_frames=n, texture_family=family)
            out[(name, family)] = (list(ex.map(seq.frame, range(n))), seq.poses)
    return out


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]


def time_ms(fn, reps: int, warm: int):
    """Median ms per call with CUDA events, after ``warm`` calls. The span
    includes the host's time to issue the call (and any sync inside it)."""
    import torch

    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def device_ms(fn, calls: int = 20, rounds: int = 7, warm: int = 3):
    """Median device ms per call of ``fn``, which must not sync: a sleep
    kernel holds the stream while the host issues ``calls`` calls between
    two events, so the events time the device's work alone."""
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        a.record()
        for _ in range(calls):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / calls)
    return float(np.median(times))


def quad_inputs(frames, config, intr, dev):
    """The quad inputs the main path gives the kernel on frame 2: state
    after one step, then detection + bucketing, priors clamped as
    circular_match clamps them."""
    import torch

    from visual_odom_tpu_torch.frontend.bucketing import detect_and_bucket
    from visual_odom_tpu_torch.runner import pipeline

    step = pipeline.make_step_fn(config, intr, device=dev)
    state = pipeline.init_vo_state(config, intr, *frames[0], device=dev)
    state, _ = step(state, torch.from_numpy(frames[1][0]).to(dev),
                    torch.from_numpy(frames[1][1]).to(dev))
    pad = state.lk_l0.pad
    raw = state.lk_l0.pyramid[0][pad:pad + H, pad:pad + W]
    feats = detect_and_bucket(raw, state.features, config)
    lk_l1 = pipeline._prep_image(frames[2][0], config, dev)
    lk_r1 = pipeline._prep_image(frames[2][1], config, dev)
    lim = torch.tensor([W / 4.0, H / 4.0], device=dev)
    flow = torch.maximum(torch.minimum(feats.flow, lim), -lim).contiguous()
    disp = torch.maximum(torch.minimum(feats.disp, lim), -lim).contiguous()
    images = (state.lk_l0, state.lk_r0, lk_r1, lk_l1)   # quad order
    return images, feats.points.contiguous(), feats.valid, flow, disp


def plane_bytes(images, out, pts, valid, sl, win):
    """Bytes of the pyramid planes the quad must read, each pixel once: the
    union over valid features of the BLOCK x BLOCK template superblocks,
    per (image, level), placed as the kernel places them. Leg k's template
    in image k sits at the chain point leg k-1 ended on (leg 1's at pts).
    Leg k's J window in image k+1 ends where leg k+1's template is taken
    (leg 4's returns to leg 1's), inside that superblock to within the
    finer levels' sub-pixel corrections, so it is not counted again: the
    count is a lower bound."""
    import torch

    pad = images[0].pad
    half = (win - 1) * 0.5
    r = torch.arange(BLOCK, device=pts.device)
    total = 0
    for k, chain in enumerate([pts] + [out[j] for j in range(3)]):
        c = chain[valid]
        for lv in range(sl + 1):
            rows, cols = images[k].shapes[lv]
            hp, wp = rows + 2 * pad, cols + 2 * pad
            ix = torch.floor(c / 2.0 ** lv - half).clamp(-1e9, 1e9).long() + pad
            sx = ix[:, 0].clamp(1, wp - win - 2) - 1
            sy = ix[:, 1].clamp(1, hp - win - 2) - 1
            seen = torch.zeros((hp, wp), dtype=torch.bool, device=pts.device)
            seen[(sy[:, None] + r)[:, :, None], (sx[:, None] + r)[:, None, :]] = True
            total += int(seen.sum())
    return total * 4


def compare_kernel(images, pts, valid, flow, disp, params, sl, label):
    """Kernel vs plain version on one input set; returns a result dict."""
    import torch

    from visual_odom_tpu_torch.ops import lk_cuda

    planes = [im.pyramid for im in images]
    shapes, pad = images[0].shapes, images[0].pad
    args = (planes, shapes, pad, pts, valid, flow, disp, params, sl)
    out_k, st_k = lk_cuda.lk_quad_cuda(*args)
    out_p, st_p, iters = lk_cuda.lk_quad_plain(*args)
    torch.cuda.synchronize()
    n_valid = int(valid.sum())
    mismatch = int((st_k != st_p).sum())
    both = st_k & st_p
    err = float((out_k - out_p).abs()[:, both].max()) if bool(both.any()) else 0.0
    # Invalid slots pass through in both.
    err_inv = float((out_k - out_p).abs()[:, ~valid].max()) if bool((~valid).any()) else 0.0
    if mismatch > STATUS_MISMATCH_MAX or err >= PT_TOL or err_inv != 0.0:
        raise AssertionError(f"{label}: kernel disagrees with plain version: "
                             f"{mismatch} status mismatches, max |dpt| {err}, "
                             f"invalid-slot |dpt| {err_inv}")
    ms = device_ms(lambda: lk_cuda.lk_quad_cuda(*args))
    call_ms = time_ms(lambda: lk_cuda.lk_quad_cuda(*args), reps=50, warm=5)
    # The plain version syncs once per iteration of its masked loop, so
    # its time is host and device together, as the main path would see it.
    plain_ms = time_ms(lambda: lk_cuda.lk_quad_plain(*args), reps=5, warm=1)
    n = pts.shape[0]
    setups = n_valid * 4 * (sl + 1)
    n_iter = int(iters.sum())
    flops = setups * SETUP_FLOPS + n_iter * ITER_FLOPS
    nbytes = (plane_bytes(images, out_k, pts, valid, sl, params.window)
              + n * FEATURE_BYTES)
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    res = dict(label=label, start_level=sl, n=n, valid=n_valid,
               tracked=int(st_k.sum()), status_mismatch=mismatch,
               max_abs_err=err, ms=ms, call_ms=call_ms, plain_ms=plain_ms,
               updates=n_iter,
               flops=flops, bytes=nbytes, bound_ms=max(t_bytes, t_ops),
               bound_by="bytes" if t_bytes >= t_ops else "operations")
    print("quad", json.dumps(res))
    return res


def gates(poses, gt, fetched):
    """The bench's accuracy gates (bench.py:145-150)."""
    err = np.linalg.norm(poses[:len(gt), :3, 3] - gt[:, :3, 3], axis=1)
    ate = float(np.sqrt(np.mean(err ** 2)))
    course_len = float(np.sum(np.linalg.norm(np.diff(gt[:, :3, 3], axis=0),
                                             axis=1)))
    accept = float(np.mean(fetched.accept))
    return accept, ate, 0.01 * course_len


def run_main_path(name, frames, gt, config, intr, dev):
    from visual_odom_tpu_torch.ops import lk_cuda
    from visual_odom_tpu_torch.runner import pipeline

    lk_cuda.lk_circular_quad.launches = 0
    poses, fetched, wall, n = pipeline.run_sequence_scan(
        frames, config, intr, chunk=CHUNK, warmup=False, device=dev)
    launches = lk_cuda.lk_circular_quad.launches
    accept, ate, budget = gates(poses, gt, fetched)
    res = dict(course=name, steps=n, wall_s=wall, fps=n / wall,
               ms_per_frame=1e3 * wall / n, accept=accept, ate_m=ate,
               ate_budget_m=budget, fallback_frames=int(fetched.fallback.sum()),
               rejected_frames=[int(i) + 1 for i in
                                np.flatnonzero(~np.asarray(fetched.accept, bool))],
               mean_bucketed=float(fetched.num_bucketed.mean()),
               mean_matched=float(fetched.num_matched.mean()),
               mean_inliers=float(fetched.num_inliers.mean()),
               kernel_launches=launches)
    print("main_path", json.dumps(res))
    if not (np.isfinite(fetched.T_inv).all() and fetched.T_inv.shape == (n, 4, 4)
            and len(poses) == n + 1 and np.isfinite(poses).all()):
        raise AssertionError(f"{name}: outputs not finite or of the wrong shape")
    if launches != LAUNCHES_PER_FRAME * n:
        raise AssertionError(f"{name}: {launches} kernel launches for {n} "
                             f"frames, expected {LAUNCHES_PER_FRAME} per frame")
    if not (accept >= 0.9 and ate <= budget):
        raise AssertionError(f"{name}: accuracy gates failed: accept {accept}, "
                             f"ATE {ate} m > budget {budget} m")
    return res


def small_reference(dev):
    """Card step vs the port's CPU step, same RANSAC draws, 120x160."""
    import torch

    from visual_odom_tpu_torch.config import CameraIntrinsics, VOConfig
    from visual_odom_tpu_torch.io.synthetic import SyntheticStereoSequence
    from visual_odom_tpu_torch.runner import pipeline

    h, w = 120, 160
    intr = CameraIntrinsics(fx=120.0, fy=120.0, cx=w / 2, cy=h / 2,
                            bf=-120.0 * 0.54, width=w, height=h)
    cfg = VOConfig.for_image(h, w, ransac_iterations=200)
    seq = SyntheticStereoSequence(intr, num_frames=6, seed=0, speed=0.5)
    frames = [seq.frame(i) for i in range(6)]
    runs = {}
    for d in ("cpu", dev):
        step = pipeline.make_step_fn(cfg, intr, device=d)
        st = pipeline.init_vo_state(cfg, intr, *frames[0], device=d)
        outs = []
        for i in range(1, 6):
            u = torch.from_numpy(np.random.default_rng(i).random(
                (200, cfg.padded_features), dtype=np.float32)).to(d)
            st, out = step(st, torch.from_numpy(frames[i][0]).to(d),
                           torch.from_numpy(frames[i][1]).to(d), uniforms=u)
            outs.append(pipeline.StepOutput(*(x.cpu().numpy() for x in out)))
        runs[str(d)] = outs
    worst = 0.0
    for ref, got in zip(runs["cpu"], runs[str(dev)]):
        if int(ref.num_bucketed) != int(got.num_bucketed):
            raise AssertionError("small reference: bucketed counts differ")
        for k in ("num_matched", "num_inliers"):
            r, g = int(getattr(ref, k)), int(getattr(got, k))
            if abs(g - r) > 0.03 * r:
                raise AssertionError(f"small reference: {k} {g} vs {r}")
        d = np.abs(got.T_inv - ref.T_inv)
        if d[:3, :3].max() >= 2e-3 or d[:3, 3].max() >= 2e-2:
            raise AssertionError(f"small reference: T_inv differs by {d.max()}")
        worst = max(worst, float(d.max()))
    print("small_reference", json.dumps({"frames": 5, "max_T_inv_diff": worst}))


def profile_frames(frames, config, intr, dev, steady_ms, n_frames=8):
    """Device time by kernel over a few main-path frames, under
    torch.profiler, after two steps that must not synchronise with the
    host. The busy share divides it by ``steady_ms``, the main path's
    ms/frame without the profiler (which slows the host)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from visual_odom_tpu_torch.runner import pipeline

    step = pipeline.make_step_fn(config, intr, device=dev)
    state = pipeline.init_vo_state(config, intr, *frames[0], device=dev)
    up = [(torch.from_numpy(l).to(dev), torch.from_numpy(r).to(dev))
          for l, r in frames[1:n_frames + 3]]
    # The step never waits for the device: any synchronising call raises.
    torch.cuda.set_sync_debug_mode("error")
    try:
        for l, r in up[:2]:
            state, _ = step(state, l, r)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for l, r in up[2:]:
            state, out = step(state, l, r)
        torch.cuda.synchronize()
    # Device-side events only (kernels, copies): the CPU-side aten ops carry
    # the same device time again.
    rows = sorted(((e.self_device_time_total, e.key, e.count)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA), reverse=True)
    if not rows:
        raise AssertionError("profile: the profiler saw no device time")
    device_ms = sum(r[0] for r in rows) / 1e3 / n_frames
    res = {"frames": n_frames, "device_ms_per_frame": device_ms,
           "device_ops_per_frame": sum(r[2] for r in rows) / n_frames,
           "steady_ms_per_frame": steady_ms,
           "device_busy_share": device_ms / steady_ms,
           "top_device_ops": [{"name": k[:90], "ms_per_frame": us / 1e3 / n_frames,
                               "calls_per_frame": c / n_frames}
                              for us, k, c in rows[:10]]}
    print("profile", json.dumps(res))
    return res


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's main path runs on the card",
              file=sys.stderr)
        return 2
    try:
        import visual_odom_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})",
              file=sys.stderr)
        return 2
    from visual_odom_tpu_torch.config import VOConfig
    from visual_odom_tpu_torch.ops import _nvcc
    from visual_odom_tpu_torch.ops.lk import LKParams

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    card = card_line()
    print("card:", card)
    print("torch", torch.__version__, "cuda", torch.version.cuda,
          "python", sys.version.split()[0])

    t = time.perf_counter()
    path = _nvcc.build("lk_legs")
    print(f"build: {time.perf_counter() - t:.2f} s")
    with open(path + ".log") as f:
        for line in f:
            if "registers" in line or "spill" in line:
                print("ptxas:", line.strip())

    t = time.perf_counter()
    courses = render_courses([("straight", "value", STRAIGHT_STEPS + 1),
                              ("straight", "checker", CHECKER_STEPS + 1)], H, W)
    print(f"render: {time.perf_counter() - t:.2f} s")

    config = VOConfig.for_image(H, W)
    intr = kitti_intrinsics(H, W)
    params = LKParams(window=config.lk_window, levels=config.lk_levels,
                      max_iters=config.lk_max_iters, eps=config.lk_eps,
                      min_eig_threshold=config.lk_min_eig_threshold)
    frames, gt = courses[("straight", "value")]

    # ---- phase 3: kernel vs plain at KITTI shapes ------------------------
    images, pts, valid, flow, disp = quad_inputs(frames, config, intr, dev)
    probe = torch.arange(0, pts.shape[0], pts.shape[0] // 64, device=dev)[:64]
    quads = [
        compare_kernel(images, pts, valid, flow, disp, params, 1,
                       "fast_sl1_n384"),
        compare_kernel(images, pts[probe].contiguous(), valid[probe],
                       flow[probe].contiguous(), disp[probe].contiguous(),
                       params, 2, "probe_sl2_n64"),
        compare_kernel(images, pts, valid, flow, disp, params, 2,
                       "safe_sl2_n384"),
        compare_kernel(images, pts, torch.zeros_like(valid), flow, disp,
                       params, 2, "safe_masked_sl2_n384"),
    ]

    # ---- phase 4: the main path -----------------------------------------
    runs = [run_main_path("straight", frames, gt, config, intr, dev)]
    cframes, cgt = courses[("straight", "checker")]
    runs.append(run_main_path("straight_checker", cframes, cgt, config, intr,
                              dev))
    launches = sum(r["kernel_launches"] for r in runs)

    # ---- phase 5: small input against the CPU reference -----------------
    small_reference(dev)

    # ---- phase 6: where the time goes -----------------------------------
    profile_frames(frames, config, intr, dev, runs[0]["ms_per_frame"])

    main_q = quads[0]
    print("total:", f"{time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [{
        "name": "lk_quad_kernel", "route": "cuda", "source": SOURCE,
        "replaces": REPLACES, "launches": launches,
        "max_abs_err": max(q["max_abs_err"] for q in quads),
        "ms": main_q["ms"], "plain_ms": main_q["plain_ms"],
        "bound_ms": main_q["bound_ms"], "bound_by": main_q["bound_by"],
        "library_ms": None}]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
