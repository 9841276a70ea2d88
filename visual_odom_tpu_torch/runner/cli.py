"""Command-line interface of the PyTorch/CUDA port.

Port of ``visual_odom_tpu/runner/cli.py``: the same subcommands, flags and
defaults. It extends the reference's single positional-arg binary
(`./run <seq|rgbd> <calib.yaml> [gt_poses.txt]`, src/main.cpp:37-58) into
subcommands; `run` keeps argument-for-argument compatibility with the
reference invocation.

    python -m visual_odom_tpu_torch.runner.cli run <sequence_dir|synthetic|rgbd> <calib.yaml> [gt_poses.txt] [options]
    python -m visual_odom_tpu_torch.runner.cli run-batch <seq_dir>... --calibration c.yaml --out-dir out/
    python -m visual_odom_tpu_torch.runner.cli eval --gt gt.txt --result poses.txt
    python -m visual_odom_tpu_torch.runner.cli eval-all --gt-dir gt/ --result-dir res/ --out-dir out/
    python -m visual_odom_tpu_torch.runner.cli bench [--quick] [--frames N] [--height H] [--width W]

`run` and `run-batch` step VO on `--device` (default `cuda`; `cpu` runs
the plain PyTorch path and must be asked for): without a card and without
`--device cpu` they exit non-zero. A mesh (`run --ba-ring`'s "seq" ring,
`run-batch`'s (data, model) mesh) spans every visible card for `cuda` and
the one named device for `cuda:N` or `cpu`. `bench` runs the port's
benchmark harness (``python -m visual_odom_tpu_torch.bench``) on `--device`
in a subprocess and returns its exit code.

The devkit scorer the reference ships but never wires up
(src/evaluate/evaluate_odometry.cpp:471-497 — main commented out) is a
first-class subcommand here.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


#: (flag, VOConfig field, type) — every algorithm constant the reference
#: hard-codes (SURVEY.md section 5 config: "everything overridable via CLI").
_CONFIG_FLAGS = [
    ("detector", "detector", str),          # fast | shi-tomasi
    ("fast-threshold", "fast_threshold", int),
    ("shi-tomasi-quality", "shi_tomasi_quality", float),
    ("shi-tomasi-min-distance", "shi_tomasi_min_distance", float),
    ("bucket-rows", "bucket_rows", int),
    ("features-per-bucket", "features_per_bucket", int),
    ("age-threshold", "age_threshold", int),
    ("replenish-below", "replenish_below", int),
    ("lk-window", "lk_window", int),
    ("lk-levels", "lk_levels", int),
    ("lk-iters", "lk_max_iters", int),
    ("lk-eps", "lk_eps", float),
    ("lk-min-eig", "lk_min_eig_threshold", float),
    ("lk-seed-skip-levels", "lk_seed_skip_levels", int),
    ("lk-skip-mode", "lk_skip_mode", str),          # fixed | adaptive
    ("lk-fast-skip-levels", "lk_fast_skip_levels", int),
    ("lk-probe-px", "lk_probe_px", float),
    ("lk-probe-frac", "lk_probe_disagree_frac", float),
    ("circle-threshold", "circle_threshold", float),
    ("ransac-iters", "ransac_iterations", int),
    ("ransac-reproj", "ransac_reproj_threshold", float),
    ("ransac-confidence", "ransac_confidence", float),
    ("max-rotation", "max_rotation_rad", float),
    ("min-scale", "min_scale", float),
    ("max-scale", "max_scale", float),
    ("min-accept-inliers", "min_accept_inliers", int),
    ("lk-backend", "lk_backend", str),
]

def add_config_flags(parser) -> None:
    """Expose every reference algorithm constant as a CLI override."""
    g = parser.add_argument_group(
        "algorithm constants (defaults = reference values)")
    for flag, field, typ in _CONFIG_FLAGS:
        g.add_argument(f"--{flag}", dest=field, type=typ, default=None)
    g.add_argument("--mono-rotation", dest="mono_rotation",
                   action="store_true", default=None,
                   help="rotation from the 8-point essential path "
                        "(reference src/visualOdometry.h:42)")


def add_device_flag(parser) -> None:
    parser.add_argument("--device", default="cuda",
                        help="where VO steps: cuda (default; cuda:N for one "
                             "card) or cpu (the plain PyTorch path)")


def _mesh_devices(device: str) -> list:
    """The devices a command's mesh spans: every visible card for "cuda",
    the one named device for "cuda:N" or "cpu"."""
    import torch

    from visual_odom_tpu_torch.parallel.mesh import visible_devices

    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return visible_devices()
    return [dev]


def _ring_solver(args):
    """``--ba-ring [K]``: the sequence-parallel ring solver over a "seq"
    mesh of min(K, available) devices (all of them without K), exact
    (auto-halo from the observed track spans; ``ba_solve`` when the mesh
    cannot afford the halo or has one device). None without the flag."""
    if not args.ba_ring:
        return None
    from visual_odom_tpu_torch.parallel.mesh import make_mesh
    from visual_odom_tpu_torch.parallel.ring_ba import make_ring_window_solver

    devs = _mesh_devices(args.device)
    n_dev = min(args.ba_ring, len(devs)) if args.ba_ring > 0 else len(devs)
    return make_ring_window_solver(make_mesh({"seq": n_dev}, devs[:n_dev]))


def config_from_args(args, h: int, w: int):
    from visual_odom_tpu_torch.config import VOConfig

    overrides = {}
    for _, field, _typ in _CONFIG_FLAGS:
        v = getattr(args, field, None)
        if v is not None:
            overrides[field] = v
    if getattr(args, "mono_rotation", None):
        overrides["mono_rotation"] = True
    return VOConfig.for_image(h, w, **overrides)


def _cmd_run(args) -> int:
    from visual_odom_tpu_torch.config import load_calibration
    from visual_odom_tpu_torch.eval.kitti_eval import evaluate_sequence
    from visual_odom_tpu_torch.eval.plot import render_trajectory, save_png
    from visual_odom_tpu_torch.io.kitti import save_poses_kitti
    from visual_odom_tpu_torch.runner.pipeline import run_sequence

    intr = load_calibration(args.calibration)
    seq = None  # the random-access sequence (KITTI dir or synthetic)

    if args.sequence == "synthetic":
        from visual_odom_tpu_torch.io.synthetic import SyntheticStereoSequence

        if not intr.height:
            print("synthetic mode needs Camera.width/height in the calib file")
            return 1
        seq = SyntheticStereoSequence(intr, num_frames=args.max_frames or 50)
        frames = iter(seq)
        gt = seq.poses
        h, w = intr.height, intr.width
    elif args.sequence == "rgbd":
        # Live capture path (reference src/main.cpp:58,101-106). Requires
        # camera hardware; fails fast otherwise.
        from visual_odom_tpu_torch.io.camera import V4L2StereoCamera

        cam = V4L2StereoCamera()
        frames = iter(lambda: cam.get_lr_frames(), None)
        gt = None
        # Frame dims come from the calibration file (the reference reads
        # rgbd.yaml's Camera.width/height keys nowhere and hard-codes
        # 640x480, src/rgbd_standalone.cpp:74-76; here the YAML is
        # authoritative, falling back to the reference's constants).
        h = intr.height or 480
        w = intr.width or 640
    else:
        from visual_odom_tpu_torch.io.kitti import KittiSequence, load_poses

        seq = KittiSequence(args.sequence)
        left0, _ = seq.frame(0)
        h, w = left0.shape

        # Stream through the native prefetcher (decode overlaps device
        # compute); without the native runtime it reads frames in turn.
        frames = seq.iter_prefetched(max_frames=args.max_frames)
        gt = load_poses(args.ground_truth) if args.ground_truth else None

    cfg = config_from_args(args, h, w)
    if args.chunk:
        # Chunked-scan fast path (outputs fetched after the last chunk);
        # with --checkpoint it snapshots at chunk boundaries and resumes
        # (run_sequence_scan_resumable). Per-frame host features (metrics
        # JSONL, track overlays) need the interactive runner.
        if args.tracks_dir or args.metrics:
            print("--chunk is the no-host-sync fast path; it cannot emit "
                  "per-frame metrics/tracks — drop --chunk or those flags")
            return 1
        from visual_odom_tpu_torch.runner.pipeline import (
            run_sequence_scan,
            run_sequence_scan_resumable,
        )

        collect = bool(args.ba_window)
        snaps = None
        if args.checkpoint:
            if seq is None:
                print("--checkpoint needs a random-access sequence "
                      "(KITTI dir or synthetic)")
                return 1
            out = run_sequence_scan_resumable(
                seq, cfg, intr,
                checkpoint_path=args.checkpoint,
                checkpoint_every=args.checkpoint_every,
                chunk=args.chunk,
                max_frames=args.max_frames,
                verbose=not args.quiet,
                upload_threads=args.upload_threads,
                collect_tracks=collect,
                device=args.device,
            )
        else:
            out = run_sequence_scan(
                frames, cfg, intr, chunk=args.chunk,
                collect_tracks=collect,
                upload_threads=args.upload_threads, device=args.device)
        if collect:
            poses, fetched, wall, processed, snaps = out
        else:
            poses, fetched, wall, processed = out
        if args.ba_window:
            # The scan's per-frame TrackSnapshots feed windowed-BA
            # smoothing directly (checkpointed as trk_* keys on the
            # resumable path).
            from visual_odom_tpu_torch.ba.window import smooth_trajectory_ba

            poses = smooth_trajectory_ba(snaps, poses[: len(snaps) + 1],
                                         intr, window=args.ba_window,
                                         solver=_ring_solver(args),
                                         max_landmarks=args.ba_landmarks,
                                         min_track_len=args.ba_min_track_len,
                                         huber_delta=args.ba_huber,
                                         device=args.device)
        if not args.quiet and processed:
            print(f"{processed} frames in {wall:.2f}s "
                  f"({processed / wall:.1f} FPS)")
        if args.loop_close:
            poses = _apply_loop_close(args, poses, seq, cfg, intr)
        if args.output:
            save_poses_kitti(args.output, poses)
        if args.trajectory_png:
            save_png(args.trajectory_png, render_trajectory(poses, gt))
        if gt is not None:
            n = min(len(gt), len(poses))
            print(json.dumps(evaluate_sequence(np.asarray(gt)[:n],
                                               poses[:n]), indent=2))
        return 0
    if args.checkpoint:
        from visual_odom_tpu_torch.runner.pipeline import (
            run_sequence_resumable,
        )

        if seq is None:
            print("--checkpoint needs a random-access sequence "
                  "(KITTI dir or synthetic)")
            return 1
        poses, results = run_sequence_resumable(
            seq,
            cfg,
            intr,
            checkpoint_path=args.checkpoint,
            checkpoint_every=args.checkpoint_every,
            max_frames=args.max_frames,
            metrics_path=args.metrics,
            poses_path=args.output,
            verbose=not args.quiet,
            device=args.device,
        )
    else:
        live = None
        if args.live:
            from visual_odom_tpu_torch.eval.plot import LiveDisplay

            try:
                live = LiveDisplay(poses_gt=gt)
            except RuntimeError as e:
                print(e)
                return 1
        out = run_sequence(
            frames,
            cfg,
            intr,
            metrics_path=args.metrics,
            poses_path=args.output,
            verbose=not args.quiet,
            tracks_dir=args.tracks_dir,
            tracks_every=args.tracks_every,
            collect_tracks=bool(args.ba_window),
            live=live,
            device=args.device,
        )
        if args.ba_window:
            from visual_odom_tpu_torch.ba.window import smooth_trajectory_ba

            poses, results, snaps = out
            poses = smooth_trajectory_ba(snaps, poses, intr,
                                         window=args.ba_window,
                                         solver=_ring_solver(args),
                                         max_landmarks=args.ba_landmarks,
                                         min_track_len=args.ba_min_track_len,
                                         huber_delta=args.ba_huber,
                                         device=args.device)
            if args.output:
                save_poses_kitti(args.output, poses)
        else:
            poses, results = out

    if args.loop_close:
        poses = _apply_loop_close(args, poses, seq, cfg, intr)
    if args.trajectory_png:
        save_png(args.trajectory_png, render_trajectory(poses, gt))
    if gt is not None:
        score = evaluate_sequence(np.asarray(gt), poses)
        print(json.dumps(score, indent=2))
    return 0


def _apply_loop_close(args, poses, seq, cfg, intr):
    """Pose-graph loop closure over a finished run (run --loop-close):
    needs random-access frames to measure the loop edges."""
    from visual_odom_tpu_torch.runner.loopclosure import close_loops

    if seq is None:
        print("--loop-close needs a random-access sequence "
              "(KITTI dir or synthetic); skipping")
        return poses
    new_poses, info = close_loops(np.asarray(poses), seq.frame, cfg, intr,
                                  device=args.device)
    if not args.quiet:
        print(f"loop closure: {len(info.candidates)} candidates, "
              f"{len(info.edges)} edges accepted "
              f"{[(a, b) for (a, b, _) in info.edges]}")
    if args.output and info.edges:
        from visual_odom_tpu_torch.io.kitti import save_poses_kitti

        save_poses_kitti(args.output, new_poses)
    return new_poses if info.edges else poses


def _cmd_eval(args) -> int:
    from visual_odom_tpu_torch.eval.kitti_eval import (
        calc_sequence_errors,
        evaluate_sequence,
    )
    from visual_odom_tpu_torch.io.kitti import load_poses

    gt = load_poses(args.gt)
    res = load_poses(args.result)
    if len(gt) != len(res) and not args.allow_partial:
        print(f"pose count mismatch: gt={len(gt)} result={len(res)} "
              "(pass --allow-partial to score the overlap)")
        return 2
    n = min(len(gt), len(res))
    score = evaluate_sequence(gt[:n], res[:n])
    print(json.dumps(score, indent=2))
    if args.errors_out:
        from visual_odom_tpu_torch.eval.devkit import save_sequence_errors

        save_sequence_errors(calc_sequence_errors(gt[:n], res[:n]),
                             args.errors_out)
    if args.artifacts_dir:
        from visual_odom_tpu_torch.eval.devkit import eval_sequence_artifacts

        eval_sequence_artifacts(gt[:n], res[:n], args.artifacts_dir,
                                seq_name=args.seq_name)
    return 0


def _cmd_eval_all(args) -> int:
    from visual_odom_tpu_torch.eval.devkit import eval_all
    from visual_odom_tpu_torch.utils.notify import Notifier

    results = eval_all(
        args.gt_dir, args.result_dir, args.out_dir,
        sequences=args.sequences or None,
        notifier=Notifier(email=args.email or ""),
        plots=not args.no_plots,
    )
    with open(f"{args.out_dir}/summary.json", "w") as f:
        json.dump(results, f, indent=2)
    return 0 if results else 1


class _Limited:
    """Random-access max-frames view (keeps streaming lazy)."""

    def __init__(self, seq, n):
        self._seq = seq
        self._n = min(len(seq), n) if n else len(seq)

    def __len__(self):
        return self._n

    def frame(self, i):
        return self._seq.frame(i)


def _cmd_run_batch(args) -> int:
    """Lockstep run of several sequences (BASELINE.json eval config 5) over
    a (data, model) mesh."""
    import os

    from visual_odom_tpu_torch.config import load_calibration
    from visual_odom_tpu_torch.eval.kitti_eval import evaluate_sequence
    from visual_odom_tpu_torch.io.kitti import (
        KittiSequence,
        load_poses,
        save_poses_kitti,
    )
    from visual_odom_tpu_torch.parallel.batch_eval import run_sequences_batched
    from visual_odom_tpu_torch.parallel.mesh import data_model_mesh

    try:
        mesh = data_model_mesh(data=args.data_parallel or None,
                               devices=_mesh_devices(args.device))
    except ValueError as e:
        print(f"run-batch: {e}", file=sys.stderr)
        return 2

    intr = load_calibration(args.calibration)
    seqs, names = [], []
    for d in args.sequences:
        # Sequences stream frame-by-frame through the batched runner's
        # reader thread: a full KITTI sequence is several GB decoded and
        # must never materialize in RAM.
        seqs.append(_Limited(KittiSequence(d), args.max_frames))
        names.append(os.path.basename(os.path.normpath(d)))
    h, w = seqs[0].frame(0)[0].shape
    cfg = config_from_args(args, h, w)
    poses_list, stats, wall = run_sequences_batched(
        seqs, cfg, intr, chunk=args.chunk,
        checkpoint_path=args.checkpoint or "",
        checkpoint_every=args.checkpoint_every, mesh=mesh)
    total_frames = sum(len(s) for s in seqs)
    print(f"{total_frames} frames / {len(seqs)} sequences in {wall:.1f}s "
          f"({total_frames / wall:.1f} frames/s aggregate)")
    os.makedirs(args.out_dir, exist_ok=True)
    summary = {}
    for name, poses in zip(names, poses_list):
        save_poses_kitti(os.path.join(args.out_dir, f"{name}.txt"), poses)
        if args.gt_dir:
            gt_path = os.path.join(args.gt_dir, f"{name}.txt")
            if os.path.exists(gt_path):
                gt = load_poses(gt_path)
                n = min(len(gt), len(poses))
                summary[name] = evaluate_sequence(gt[:n], poses[:n])
    if summary:
        print(json.dumps(summary, indent=2))
    return 0


def _cmd_bench(args) -> int:
    import subprocess

    cmd = [sys.executable, "-m", "visual_odom_tpu_torch.bench"]
    if args.quick:
        cmd.append("--quick")
    if args.frames:
        cmd += ["--frames", str(args.frames)]
    if args.height:
        cmd += ["--height", str(args.height)]
    if args.width:
        cmd += ["--width", str(args.width)]
    cmd += ["--device", args.device]
    return subprocess.call(cmd)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="vo", description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

    pr = sub.add_parser("run", help="run visual odometry over a sequence")
    pr.add_argument("sequence", help="KITTI sequence dir, 'synthetic', or 'rgbd'")
    pr.add_argument("calibration", help="OpenCV-YAML calibration file")
    pr.add_argument("ground_truth", nargs="?", help="KITTI GT pose file")
    pr.add_argument("--output", "-o", help="write KITTI-format poses here")
    pr.add_argument("--metrics", help="write JSONL per-frame metrics here")
    pr.add_argument("--trajectory-png", help="write bird's-eye trajectory PNG")
    pr.add_argument("--max-frames", type=int, default=0)
    pr.add_argument("--chunk", type=int, default=0,
                    help="frames per upload chunk (0 = interactive "
                         "per-frame runner; > 0 = chunked-scan fast path)")
    pr.add_argument("--checkpoint",
                    help="checkpoint file; resumes from it when present "
                         "(with --chunk: chunk-boundary snapshots on the "
                         "fast path)")
    pr.add_argument("--checkpoint-every", type=int, default=100,
                    help="snapshot interval in frames (rounded up to a "
                         "chunk multiple on the fast path)")
    pr.add_argument("--upload-threads", type=int, default=4,
                    help="concurrent decode+upload threads feeding the "
                         "fast path")
    pr.add_argument("--live", action="store_true",
                    help="interactive trajectory + tracking windows "
                         "(needs a display server; reference "
                         "src/utils.cpp:19-48 imshow behavior)")
    pr.add_argument("--tracks-dir",
                    help="write displayTracking-style overlay PNGs here")
    pr.add_argument("--tracks-every", type=int, default=50)
    pr.add_argument("--ba-window", type=int, default=0,
                    help="smooth the trajectory with windowed bundle "
                         "adjustment over N-frame windows (0 = off; "
                         "short courses: 8; km-scale: 16 with "
                         "--ba-min-track-len 4 --ba-huber 1.0 — "
                         "SOAK_r05.json ba_tune_rows)")
    pr.add_argument("--ba-landmarks", type=int, default=256,
                    help="landmark capacity per BA window")
    pr.add_argument("--ba-min-track-len", type=int, default=3,
                    help="min frames a track must span to enter BA")
    pr.add_argument("--ba-huber", type=float, default=1.5,
                    help="Huber delta (px) for the BA robust loss")
    pr.add_argument("--ba-ring", type=int, nargs="?", const=-1, default=0,
                    help="shard each BA window's solve over a device ring "
                         "(optionally: number of devices; default all). "
                         "Exact: auto-halo with unsharded fallback.")
    pr.add_argument("--loop-close", action="store_true",
                    help="after the run: detect revisits in the estimate, "
                         "measure loop edges with real VO steps, solve the "
                         "keyframe pose graph and redistribute the drift "
                         "(runner/loopclosure.py; needs random-access "
                         "frames)")
    pr.add_argument("--quiet", action="store_true")
    add_device_flag(pr)
    add_config_flags(pr)
    pr.set_defaults(fn=_cmd_run)

    prb = sub.add_parser(
        "run-batch",
        help="run several sequences in lockstep over a device mesh (DP)")
    prb.add_argument("sequences", nargs="+", help="KITTI sequence dirs")
    prb.add_argument("--calibration", required=True)
    prb.add_argument("--out-dir", required=True)
    prb.add_argument("--gt-dir", help="score each sequence against GT here")
    prb.add_argument("--data-parallel", type=int, default=0,
                     help="data-axis size (default: all devices)")
    prb.add_argument("--max-frames", type=int, default=0)
    prb.add_argument("--chunk", type=int, default=16,
                     help="frames per upload chunk (0 = step per frame)")
    prb.add_argument("--checkpoint",
                     help="restartable batch eval: one atomic snapshot "
                          "covering all lockstep sequences, chunk-boundary "
                          "aligned; resumes from it when present")
    prb.add_argument("--checkpoint-every", type=int, default=256,
                     help="batched snapshot interval in frames (rounded "
                          "up to a chunk multiple)")
    add_device_flag(prb)
    add_config_flags(prb)
    prb.set_defaults(fn=_cmd_run_batch)

    pe = sub.add_parser("eval", help="KITTI devkit scoring")
    pe.add_argument("--gt", required=True)
    pe.add_argument("--result", required=True)
    pe.add_argument("--errors-out", help="devkit-format per-segment errors")
    pe.add_argument("--artifacts-dir",
                    help="write full devkit artifacts (errors/plots/stats)")
    pe.add_argument("--seq-name", default="00",
                    help="sequence name for artifact files")
    pe.add_argument("--allow-partial", action="store_true")
    pe.set_defaults(fn=_cmd_eval)

    pa = sub.add_parser(
        "eval-all",
        help="devkit eval() over a results directory (seqs scored vs GT)")
    pa.add_argument("--gt-dir", required=True)
    pa.add_argument("--result-dir", required=True)
    pa.add_argument("--out-dir", required=True)
    pa.add_argument("--sequences", nargs="*",
                    help="sequence names (default: every <seq>.txt found)")
    pa.add_argument("--email", help="notify via sendmail when available")
    pa.add_argument("--no-plots", action="store_true")
    pa.set_defaults(fn=_cmd_eval_all)

    pb = sub.add_parser("bench", help="run the benchmark harness")
    pb.add_argument("--quick", action="store_true")
    pb.add_argument("--frames", type=int, default=0)
    pb.add_argument("--height", type=int, default=0)
    pb.add_argument("--width", type=int, default=0)
    add_device_flag(pb)
    pb.set_defaults(fn=_cmd_bench)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if getattr(args, "device", None) is not None:
        from visual_odom_tpu_torch import resolve_device

        try:
            resolve_device(args.device)
        except RuntimeError as e:
            print(f"vo {args.cmd}: {e} (here: --device cpu)",
                  file=sys.stderr)
            return 1
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
