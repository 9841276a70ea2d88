"""Benchmark harness of the PyTorch/CUDA port: VO frames/s per card, LK
circular matches/s, and the accuracy gauntlet, at 1241x376 by default.

Port of the JAX package's ``bench.py``, with its flags, defaults, courses,
gates and keys:

    python -m visual_odom_tpu_torch.bench [--quick] [--frames N]
        [--height 376] [--width 1241]
        [--courses straight,turning,stress,long,loop] [--chunk 32]
        [--lk-seed-skip-levels K] [--device cuda]

It runs on the card unless ``--device cpu`` is given (the plain PyTorch
path, for tests at a tiny size); without a card it raises. Prints one
``[bench] <course>: {...}`` line per course on stderr, with the card's
name and power limit (``nvidia-smi``) before them, and ONE JSON line on
stdout:

  {"metric": "vo_fps_per_chip", "value": N, "unit": "frames/s",
   "vs_baseline": N / 80, ...extras}

80 frames/s is the reference C++ implementation's published CUDA figure,
60-80 frames/s end to end on KITTI-sized frames (reference README.md:41;
BASELINE.md's target). It is not a measurement of this card.

Accuracy gauntlet: the trajectory is scored against the rendering's exact
ground truth on every course: the gentle straight corridor, a turning
course whose peak per-frame yaw approaches the reference's 0.1 rad gate
(src/main.cpp:201-208), a stress course (exposure drift, sensor noise,
occluders, a low-texture stretch), the ~1.28 km ``long`` snake (devkit
segment errors for every length bucket) and the closed ``loop`` (loop
closure by the keyframe pose graph). ``accuracy_ok``, which gates
``vs_baseline``, requires accept ratio >= 0.9 AND ATE <= 1 % of course
length on EVERY course. The headline frames/s is the first course's
(``straight``), with its frames uploaded before the timed loop and the
outputs fetched once at its end (``run_sequence_scan(preupload=True)``);
one streamed rep (``upload_threads=4``) reports what the uploads cost.

Courses are rendered on a pool of spawned processes (a frame depends only
on its course and index, so the bytes do not depend on the pool) and
cached as ``.npz`` under ``VO_COURSE_CACHE`` (default
``<tempdir>/vo_course_cache``). The JAX bench's persistent compilation
cache has no counterpart: the port compiles nothing per run beyond the LK
kernels' library, which ``ops._nvcc`` builds once and reuses.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import os
import subprocess
import sys
import tempfile
import time
import zipfile

import numpy as np

#: per-course frame-count overrides: the endurance/devkit courses need
#: length, not the 161-frame gauntlet default. "long" at 1.25 m/frame x
#: 1024 steps = ~1.28 km -> every devkit segment-length bucket 100..800 m
#: has data; "loop" closes its square at frame 668.
COURSE_FRAMES = {"long": 1025, "loop": 705}

#: pixels a render worker should have before a pool pays for its start
#: (a spawned worker imports the port, ~2-3 s; a 1241x376 frame renders in
#: ~1 s on one core)
_PIXELS_PER_WORKER = 8 * 1241 * 376

#: the frames ``bench_lk`` tracks between (a temporal pair of ``straight``)
_LK_PAIR = (10, 11)


def course_cache_path(name: str, num_frames: int, height: int,
                      width: int) -> str:
    """Where ``render_course`` caches a course: ``lefts``, ``rights`` (n,
    H, W) uint8 and ``poses`` (n, 4, 4) in one ``.npz``."""
    cache = os.environ.get("VO_COURSE_CACHE",
                           os.path.join(tempfile.gettempdir(),
                                        "vo_course_cache"))
    return os.path.join(cache, f"{name}_{width}x{height}_{num_frames}_v3.npz")


def _kitti_intrinsics(height: int, width: int):
    """KITTI 00's focal length and baseline, scaled to the width."""
    from visual_odom_tpu_torch.config import CameraIntrinsics

    s = width / 1241.0
    return CameraIntrinsics(
        fx=718.856 * s, fy=718.856 * s, cx=width / 2.0, cy=height / 2.0,
        bf=-718.856 * s * 0.537, width=width, height=height,
    )


#: courses built in this render worker process, by their arguments
_WORKER_COURSES: dict = {}


def _render_frames(args):
    """Frames ``lo``..``hi`` of one course, in a render worker process."""
    from visual_odom_tpu_torch.io.synthetic import make_course

    name, num_frames, height, width, lo, hi = args
    key = (name, num_frames, height, width)
    if key not in _WORKER_COURSES:
        _WORKER_COURSES.clear()
        _WORKER_COURSES[key] = make_course(
            name, _kitti_intrinsics(height, width), num_frames=num_frames)
    seq = _WORKER_COURSES[key]
    return [seq.frame(i) for i in range(lo, hi)]


def _render(seq, name: str, num_frames: int, height: int, width: int):
    """Every frame of ``seq`` (course ``name``), on a pool of spawned
    processes when the course is large enough to pay for one (the renderer
    holds the GIL for much of a frame, so threads would not help)."""
    import multiprocessing

    workers = min(os.cpu_count() or 1,
                  num_frames * height * width // _PIXELS_PER_WORKER)
    if workers <= 1:
        return list(seq)
    cuts = np.linspace(0, num_frames,
                       min(num_frames, 2 * workers) + 1).astype(int)
    with concurrent.futures.ProcessPoolExecutor(
            workers, mp_context=multiprocessing.get_context("spawn")) as ex:
        futures = [ex.submit(_render_frames, (name, num_frames, height, width,
                                              int(lo), int(hi)))
                   for lo, hi in zip(cuts[:-1], cuts[1:]) if hi > lo]
        return [f for fu in futures for f in fu.result()]


def render_course(name: str, num_frames: int, height: int, width: int):
    """Render (or load from the npz cache) one gauntlet course.

    Returns (frames list[(L, R)], gt_poses, intrinsics). A corrupt cache
    file is rendered again; a new one is written whole or not at all.
    """
    from visual_odom_tpu_torch.io.synthetic import make_course

    intr = _kitti_intrinsics(height, width)
    path = course_cache_path(name, num_frames, height, width)
    if os.path.exists(path):
        try:
            with np.load(path) as z:
                lefts, rights, poses = z["lefts"], z["rights"], z["poses"]
            return ([(lefts[i], rights[i]) for i in range(len(lefts))],
                    poses, intr)
        except (OSError, ValueError, KeyError, EOFError, zipfile.BadZipFile):
            pass  # corrupt cache -> re-render
    seq = make_course(name, intr, num_frames=num_frames)
    frames = _render(seq, name, num_frames, height, width)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + f".tmp{os.getpid()}.npz"  # keep .npz: savez appends it else
    np.savez_compressed(
        tmp, lefts=np.stack([f[0] for f in frames]),
        rights=np.stack([f[1] for f in frames]), poses=seq.poses)
    os.replace(tmp, path)
    return frames, seq.poses, intr


def score_course(name: str, num_frames: int, poses, fetched, gt, frames,
                 cfg, intr, best_fps: float, stream_fps=None,
                 stream_stats=None, device=None) -> dict:
    """The bench's per-course metrics from a scan's chained ``poses``, its
    fetched outputs and the ground truth: frames/s, matches, accept ratio,
    ATE against its budget, the streamed rep's keys, devkit segment errors
    (courses of at least 100 m) and, on ``loop``, the closure before and
    after ``close_loops`` (which measures its edges from ``frames`` on
    ``device``). Keys and rounding are the JAX bench's."""
    accept = float(np.mean(fetched.accept))

    # Accuracy against the exact rendering ground truth.
    err = np.linalg.norm(poses[: len(gt), :3, 3] - gt[:, :3, 3], axis=1)
    ate_rmse = float(np.sqrt(np.mean(err**2)))
    course_len = float(np.sum(np.linalg.norm(
        np.diff(gt[:, :3, 3], axis=0), axis=1)))
    ate_budget = 0.01 * course_len  # 1% of distance traveled
    ok = (accept >= 0.9) and (ate_rmse <= ate_budget)
    m = {
        "fps": round(best_fps, 2),
        "mean_matched": round(float(np.mean(fetched.num_matched)), 1),
        "accept_ratio": round(accept, 4),
        "ate_rmse_m": round(ate_rmse, 4),
        "ate_budget_m": round(ate_budget, 3),
        "course_len_m": round(course_len, 1),
        "ok": ok,
    }
    if stream_fps is not None:
        m["fps_streamed"] = round(stream_fps, 2)
        if stream_stats:
            m["stream_upload_mb_s"] = round(stream_stats["upload_mb_s"], 1)
            m["stream_upload_busy_frac"] = round(stream_stats["busy_frac"], 3)
            m["stream_upload_s"] = round(stream_stats["upload_s"], 2)
            m["stream_decode_s"] = round(stream_stats["decode_s"], 2)
            if "agg_upload_mb_s" in stream_stats:
                agg = stream_stats["agg_upload_mb_s"]
                m["stream_agg_upload_mb_s"] = round(agg, 1)
                mb_per_frame = 2 * frames[0][0].nbytes / 1e6
                m["link_ceiling_fps"] = round(agg / mb_per_frame, 1)
                m["stream_threads"] = stream_stats["threads"]
    # KITTI-devkit segment errors (needs >= 100 m of path).
    if course_len >= 100.0:
        from visual_odom_tpu_torch.eval.kitti_eval import (
            calc_sequence_errors,
            evaluate_sequence,
        )

        score = evaluate_sequence(gt, poses[: len(gt)])
        if np.isfinite(score.get("t_err_pct", float("nan"))):
            m["t_err_pct"] = round(float(score["t_err_pct"]), 4)
            m["r_err_deg_per_m"] = round(float(score["r_err_deg_per_m"]), 5)
        # Per-segment-length devkit rows (reference evaluate_odometry.cpp
        # LENGTHS {100..800}): only courses >= 800 m fill all 8 buckets.
        segs = calc_sequence_errors(gt, poses[: len(gt)])
        per_len = {}
        for e in segs:
            d = per_len.setdefault(int(e.length), {"n": 0, "t": 0.0,
                                                   "r": 0.0})
            d["n"] += 1
            d["t"] += e.t_err
            d["r"] += e.r_err
        m["per_length"] = {
            str(k): {"n": v["n"],
                     "t_err_pct": round(100.0 * v["t"] / v["n"], 4),
                     "r_err_deg_per_m": round(
                         np.degrees(v["r"] / v["n"]), 5)}
            for k, v in sorted(per_len.items())}
    if name == "loop":
        from visual_odom_tpu_torch.io.synthetic import SyntheticStereoSequence

        lf = SyntheticStereoSequence._loop_schedule(num_frames)[2]
        if lf < len(poses):
            # The estimate's failure to return to its own origin: a GT-free
            # end-to-end self-check (the ground truth closes by
            # construction to ~0.4 m of lateral wobble).
            m["loop_closure_est_m"] = round(float(np.linalg.norm(
                poses[lf][:3, 3] - poses[0][:3, 3])), 3)
            m["loop_closure_gt_m"] = round(float(np.linalg.norm(
                gt[lf][:3, 3] - gt[0][:3, 3])), 3)
            # Pose-graph loop closure: detect the revisit from the
            # ESTIMATE, measure the edge with real VO steps, solve the
            # keyframe graph, redistribute. Reported beside the raw chain
            # (the gauntlet gates stay on the raw trajectory).
            from visual_odom_tpu_torch.runner.loopclosure import close_loops

            pg_poses, info = close_loops(
                poses[: len(gt)], lambda i: frames[i], cfg, intr,
                gt_loop_pair=(0, lf), device=device)
            m["loop_edges"] = info.edges
            if info.edges:
                m["loop_closure_pg_m"] = round(info.closure_after_m, 3)
                err_pg = np.linalg.norm(
                    pg_poses[: len(gt), :3, 3] - gt[:, :3, 3], axis=1)
                m["ate_rmse_pg_m"] = round(
                    float(np.sqrt(np.mean(err_pg ** 2))), 4)
    return m


def bench_course(name: str, num_frames: int, height: int, width: int,
                 reps: int = 1, chunk: int = 32, preupload: bool = True,
                 stream_rep: bool = False, extra_cfg: dict = None,
                 device=None):
    """Run the chunked scan over one course ``reps`` times (best frames/s
    kept), then one streamed rep if asked; returns (best_fps, per-course
    metrics dict). ``extra_cfg``: ``VOConfig`` overrides.

    The kernels' build and load stay out of the timed region
    (``run_sequence_scan`` warms up on the first chunk before timing),
    matching how the reference's 60-80 frames/s CUDA figure is quoted.
    """
    from visual_odom_tpu_torch import resolve_device
    from visual_odom_tpu_torch.config import VOConfig
    from visual_odom_tpu_torch.runner.pipeline import run_sequence_scan

    dev = resolve_device(device)
    frames, gt, intr = render_course(name, num_frames, height, width)
    cfg = VOConfig.for_image(height, width, **(extra_cfg or {}))

    best_fps = 0.0
    stream_fps = None
    stream_stats = None
    fetched = None
    poses = None
    for _ in range(reps):
        poses, fetched, wall, processed = run_sequence_scan(
            frames, cfg, intr, chunk=chunk, preupload=preupload, device=dev)
        fps = processed / wall
        best_fps = max(best_fps, fps)
    if stream_rep:
        # One streamed rep: uploads ride background threads inside the
        # timed region (the production path); stats_out attributes the
        # number.
        stream_stats = {}
        _, _, swall, sproc = run_sequence_scan(
            frames, cfg, intr, chunk=chunk, preupload=False,
            upload_threads=4, stats_out=stream_stats, device=dev)
        stream_fps = sproc / swall
    return best_fps, score_course(name, num_frames, poses, fetched, gt,
                                  frames, cfg, intr, best_fps, stream_fps,
                                  stream_stats, device=dev)


def bench_lk(n_points: int, height: int, width: int, iters: int = 20,
             frames=None, device=None):
    """Circular-matching throughput on the pipeline's own workload:
    tracked feature pairs per second (4 LK legs per feature = 1 circular
    match) over the FAST-detected, bucketed corners of L(t0) of frames 10
    and 11 of ``straight``, tracked through the stereo quad
    L0->R0->R1->L1->L0. ``n_points`` is the padded feature capacity, as in
    the JAX bench; throughput counts the real bucketed features. Returns
    (matches/s, survivors).

    On the card a quad is one ``lk_quad_kernel`` launch
    (``ops.lk_cuda.lk_circular_quad``), and one leg of
    ``ops.lk.lk_track_pyramid`` (the level kernel) is held to its plain
    version on CPU copies of the same content: statuses agree on more than
    80 % of the slots, agreed tracks within 0.05 px. On the CPU a quad is
    four chained ``lk_track_pyramid`` legs. ``frames`` shorter than the
    pair (a ``--frames`` under 12) are replaced by a 12-frame ``straight``.
    """
    import torch

    from visual_odom_tpu_torch import resolve_device
    from visual_odom_tpu_torch.config import VOConfig
    from visual_odom_tpu_torch.frontend.bucketing import detect_and_bucket
    from visual_odom_tpu_torch.frontend.featureset import empty_feature_state
    from visual_odom_tpu_torch.ops.lk import (
        LKImage,
        LKParams,
        lk_track_pyramid,
        prepare_lk_image,
    )

    dev = resolve_device(device)
    on_card = dev.type == "cuda"

    if frames is None or len(frames) <= _LK_PAIR[1]:
        frames, _, _ = render_course("straight", _LK_PAIR[1] + 1, height,
                                     width)
    (l0, r0), (l1, r1) = frames[_LK_PAIR[0]], frames[_LK_PAIR[1]]
    params = LKParams()
    cfg = VOConfig.for_image(height, width)

    def plane(im):
        return torch.as_tensor(im.astype(np.float32), device=dev)

    prep = [prepare_lk_image(plane(im), params) for im in (l0, r0, r1, l1)]
    a, b = prep[0], prep[3]  # temporal pair for the one-leg parity check

    # The pipeline's real feature set: FAST + bucketing on L(t0).
    bucketed = detect_and_bucket(
        plane(l0), empty_feature_state(cfg.padded_features, device=dev), cfg)
    pts = bucketed.points
    valid = bucketed.valid
    n_real = int(valid.sum())

    if on_card:
        from visual_odom_tpu_torch.ops.lk_cuda import lk_circular_quad

        def quad(p):
            _, _, _, ret, ok = lk_circular_quad(
                prep[0], prep[1], prep[2], prep[3], p, valid, params)
            return ret, ok
    else:
        def quad(p):
            p1, s1 = lk_track_pyramid(prep[0], prep[1], p, valid, params)
            p2, s2 = lk_track_pyramid(prep[1], prep[2], p1, valid, params)
            p3, s3 = lk_track_pyramid(prep[2], prep[3], p2, valid, params)
            p4, s4 = lk_track_pyramid(prep[3], prep[0], p3, valid, params)
            return p4, s1 & s2 & s3 & s4

    # Warm up (kernel load + one full quad) and check that the tracks
    # converged and closed the circle: timing early-exit failures is not a
    # benchmark. On real content a minority of corners (near-field ground
    # with ~100+ px flow, self-similar texture) legitimately fail, exactly
    # the tracks the pipeline's closure check rejects and replenishes, so a
    # survivor is LK status AND sub-pixel round-trip closure, with a 70 %
    # floor.
    w0, wstat = quad(pts)
    w0, wstat, pts_h = w0.cpu().numpy(), wstat.cpu().numpy(), pts.cpu().numpy()
    closure_px = np.abs(w0 - pts_h).max(axis=1)
    good = wstat & (closure_px < 1.0)
    survivors = int(good.sum())
    if survivors < int(0.7 * n_real):
        raise AssertionError(
            f"bench_lk: only {survivors}/{n_real} tracks closed the circle")

    if on_card:
        # One-leg kernel-vs-plain parity on this same real content.
        pp, ps = lk_track_pyramid(a, b, pts, valid, params)
        cpu = [LKImage(tuple(p.cpu() for p in im.pyramid), im.shapes, im.pad)
               for im in (a, b)]
        xp, xs = lk_track_pyramid(*cpu, pts.cpu(), valid.cpu(), params)
        agree = ps.cpu().numpy() & xs.numpy()
        if not agree.mean() > 0.8:
            raise AssertionError("kernel/plain status agreement collapsed")
        dmax = float(np.abs(pp.cpu().numpy() - xp.numpy())[agree].max())
        if not dmax < 0.05:
            raise AssertionError(
                f"kernel/plain one-leg divergence {dmax:.4f} px")

    t0 = time.perf_counter()
    for _ in range(iters):
        p4, s4 = quad(pts)
    p4.cpu()  # one fetch waits for every queued quad
    wall = time.perf_counter() - t0
    # One circular match = 4 legs over the real bucketed features.
    return n_real * iters / wall, survivors


def _card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    from visual_odom_tpu_torch import resolve_device

    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--frames", type=int, default=0)
    ap.add_argument("--height", type=int, default=376)
    ap.add_argument("--width", type=int, default=1241)
    ap.add_argument("--courses", default="straight,turning,stress,long,loop",
                    help="comma-separated gauntlet courses to run "
                         "(long/loop use their own frame counts, "
                         "see COURSE_FRAMES)")
    ap.add_argument("--chunk", type=int, default=32,
                    help="scan chunk size (frames uploaded per copy). "
                         "Default 32: every gauntlet course's step count "
                         "(160/704/1024) is an exact multiple")
    ap.add_argument("--lk-seed-skip-levels", type=int, default=None,
                    help="VOConfig.lk_seed_skip_levels override (0 is a "
                         "valid override: reference all-levels behavior)")
    ap.add_argument("--device", default="cuda",
                    help="where VO steps: cuda (default; cuda:N for one "
                         "card) or cpu (the plain PyTorch path)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    if dev.type == "cuda":
        print(f"[bench] card: {_card_line()}", file=sys.stderr, flush=True)
    extra_cfg = {}
    if args.lk_seed_skip_levels is not None:
        extra_cfg["lk_seed_skip_levels"] = args.lk_seed_skip_levels
    num_frames = args.frames or (65 if args.quick else 161)
    if args.quick and args.courses == ap.get_default("courses"):
        # quick mode keeps the 3-course gauntlet; the km-scale endurance
        # courses belong to the full bench.
        args.courses = "straight,turning,stress"
    courses = [c for c in args.courses.split(",") if c]

    t0 = time.time()
    fps = 0.0
    per_course = {}
    for i, name in enumerate(courses):
        reps = (2 if not args.quick else 1) if i == 0 else 1
        n_frames_c = COURSE_FRAMES.get(name, num_frames) \
            if not args.frames else num_frames
        c_fps, metrics = bench_course(name, n_frames_c, args.height,
                                      args.width, reps=reps,
                                      chunk=args.chunk,
                                      stream_rep=(i == 0 and not args.quick),
                                      extra_cfg=extra_cfg, device=dev)
        per_course[name] = metrics
        print(f"[bench] {name}: {json.dumps(metrics)}", file=sys.stderr,
              flush=True)
        if i == 0:
            fps = c_fps  # headline = first (straight) course

    # Fast mode (lk_seed_skip_levels=2): green on the value-noise gauntlet
    # but not texture-robust (it fails the periodic checker family), so it
    # ships as an opt-in; the bench reports its headline-course number
    # beside, accuracy-gated on its own run.
    fast_fps = None
    fast_ok = None
    if courses and "straight" in courses[:1] and not args.quick \
            and "lk_seed_skip_levels" not in extra_cfg:
        fast_fps, fast_m = bench_course(
            "straight", num_frames, args.height, args.width,
            reps=1, chunk=args.chunk,
            extra_cfg={**extra_cfg, "lk_seed_skip_levels": 2}, device=dev)
        fast_ok = fast_m["ok"]
        print(f"[bench] straight fast-mode(skip=2): "
              f"{json.dumps(fast_m)}", file=sys.stderr, flush=True)

    # bench_lk is a fixed-content kernel-throughput metric: always the
    # straight course (its 0.7 survivor floor is calibrated there; the
    # endurance courses' 1.25 m/frame near-field flow legitimately fails
    # more near-ground tracks).
    frames0, _, _ = render_course("straight", num_frames, args.height,
                                  args.width)
    lk_pairs, lk_survivors = bench_lk(512, args.height, args.width,
                                      iters=5 if args.quick else 20,
                                      frames=frames0, device=dev)

    accuracy_ok = all(m["ok"] for m in per_course.values())
    # vs_baseline is the headline: frames/s against the reference's 80,
    # but ZERO when ANY gauntlet course breaks: a fast wrong answer scores
    # nothing.
    vs = fps / 80.0 if accuracy_ok else 0.0
    head = per_course.get(courses[0], {})
    result = {
        "metric": "vo_fps_per_chip",
        "value": round(fps, 2),
        "unit": "frames/s",
        "vs_baseline": round(vs, 3),
        "lk_circular_matches_per_s": round(lk_pairs, 1),
        "lk_survivors": lk_survivors,
        "image": f"{args.width}x{args.height}",
        "frames": num_frames,
        "bench_wall_s": round(time.time() - t0, 1),
        "accuracy_ok": accuracy_ok,
        "accept_ratio": head.get("accept_ratio"),
        "ate_rmse_m": head.get("ate_rmse_m"),
        "courses": per_course,
    }
    if fast_fps is not None:
        result["fps_fast_mode_skip2"] = round(fast_fps, 2)
        result["fast_mode_ok"] = fast_ok
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
