#!/usr/bin/env python3
"""The port's back end on the bench's full-length courses, on one GPU.

    python3 scripts/backend_courses.py --course long   # 1,025 frames
    python3 scripts/backend_courses.py --course loop   # 705 frames

Renders the course at 1241x376 (the bench's camera, bench.py), runs
``run_sequence_scan(collect_tracks=True)`` on the card, then windowed BA
(``smooth_trajectory_ba``) with the km-scale config (window 16, 384
landmarks, min-track 5, Huber 0.8; SOAK_r05.json "ba") and with the CLI's
short-course defaults (8 / 256 / 3 / 1.5), and on the loop course
``close_loops`` called as bench.py:220-222 calls it. Prints one JSON line
with the bench's ATE (positions, no alignment) of the chain and of each
refinement, the loop closure before and after, and the card's name and
power limit; with ``--out DIR`` the same line also goes to
``DIR/backend_<course>.json``. With ``--save-tracks DIR`` the scan's
per-frame track snapshots (stacked, frame i+1's at row i) go to
``DIR/tracks_<course>.npz`` and the chained poses with the ground truth to
``DIR/poses_<course>.npz``, so both packages' windowed BA can be run on the
same tracks on the CPU (``python tests/test_torch_ba_trace.py
DIR/tracks_loop.npz DIR/poses_loop.npz``). With ``--from-tracks DIR`` it
renders and scans nothing: it reads those two files and smooths them with
the short-course config on the card and on the CPU, window by window, and
prints the first window whose solved poses differ by more than 5e-4 with
its observations per pose, and the frames where the two smoothed
trajectories lie farthest apart.
The JAX package's CPU reference for the same courses:
``PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_ba.py loop 704``
(or ``long 1024``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

#: bench.py COURSE_FRAMES
FRAMES = {"long": 1025, "loop": 705}


def card_vs_cpu_windows(src: str, course: str, dev, tol: float = 5e-4):
    """The short-course BA config on saved tracks, on the card and on the
    CPU, each window's problem and solution recorded through the
    ``solver=`` hook."""
    import torch

    import chip_smoke as cs
    from visual_odom_tpu_torch.ba.schur import ba_solve
    from visual_odom_tpu_torch.ba.window import smooth_trajectory_ba
    from visual_odom_tpu_torch.config import CameraIntrinsics
    from visual_odom_tpu_torch.runner.pipeline import TrackSnapshot

    with np.load(os.path.join(src, f"tracks_{course}.npz")) as z:
        st = {k: z[k] for k in TrackSnapshot._fields}
    snaps = [TrackSnapshot(*(st[k][i] for k in TrackSnapshot._fields))
             for i in range(len(st["valid"]))]
    with np.load(os.path.join(src, f"poses_{course}.npz")) as z:
        poses, gt = z["poses"], z["gt"]
        intr = CameraIntrinsics(**{k: z[k].item() for k in (
            "fx", "fy", "cx", "cy", "bf", "width", "height")})
    kw = {k: v for k, v in cs.BA_SHORT.items()
          if k not in ("iterations", "huber_delta")}
    runs = {}
    for d in (dev, torch.device("cpu")):
        rec = []

        def solver(p, rec=rec):
            out = ba_solve(p, iterations=cs.BA_SHORT["iterations"],
                           huber_delta=cs.BA_SHORT["huber_delta"])
            rec.append((p.mask.cpu().numpy(), out.poses.cpu().numpy()))
            return out

        t = time.perf_counter()
        sm = smooth_trajectory_ba(snaps, poses, intr, solver=solver,
                                  device=d, **kw)
        runs[d.type] = (sm, rec, time.perf_counter() - t)
    res = {"course": course, "frames": len(poses), "card": cs.card_line(),
           "ate_chain_m": cs.ate_and_budget(poses, gt)[0]}
    for k, (sm, rec, secs) in runs.items():
        res[f"ate_ba_{k}_m"] = cs.ate_and_budget(sm, gt)[0]
        res[f"ba_{k}_s"] = secs
    (cd, crec, _), (cc, prec, _) = runs["cuda"], runs["cpu"]
    gap = np.abs(cd[:, :3, 3] - cc[:, :3, 3]).max(axis=1)
    worst = np.argsort(gap)[::-1][:6]
    res["farthest_frames"] = [[int(f), float(gap[f])] for f in worst]
    err = np.linalg.norm(cd[:len(gt), :3, 3] - gt[:, :3, 3], axis=1)
    res["card_worst_frames_vs_gt"] = [[int(f), float(err[f])]
                                      for f in np.argsort(err)[::-1][:6]]
    for i, ((mc, pc), (mp, pp)) in enumerate(zip(crec, prec)):
        d = np.abs(pc - pp).max(axis=1)
        if d.max() > tol:
            res["first_differing_window"] = {
                "index": i, "obs_per_pose": mc.sum(axis=1).tolist(),
                "same_problem": bool(np.array_equal(mc, mp)),
                "diff_per_pose": d.tolist()}
            break
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--course", choices=sorted(FRAMES), required=True)
    ap.add_argument("--out", help="directory for backend_<course>.json")
    ap.add_argument("--save-tracks", metavar="DIR",
                    help="directory for tracks_<course>.npz and "
                         "poses_<course>.npz")
    ap.add_argument("--from-tracks", metavar="DIR",
                    help="smooth DIR's saved tracks on the card and on the "
                         "CPU, window by window")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("backend_courses: needs a CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from visual_odom_tpu_torch.ba.window import smooth_trajectory_ba
    from visual_odom_tpu_torch.config import VOConfig
    from visual_odom_tpu_torch.io.synthetic import SyntheticStereoSequence
    from visual_odom_tpu_torch.runner import loopclosure, pipeline

    dev = torch.device("cuda", 0)
    if args.from_tracks:
        line = json.dumps(card_vs_cpu_windows(args.from_tracks, args.course,
                                              dev))
        print(line)
        if args.out:
            os.makedirs(args.out, exist_ok=True)
            with open(os.path.join(args.out,
                                   f"ba_windows_{args.course}.json"), "w") as f:
                f.write(line + "\n")
        return 0
    n = FRAMES[args.course]
    t = time.perf_counter()
    frames, gt = cs.render_courses([(args.course, "value", n)], cs.H,
                                   cs.W)[(args.course, "value")]
    res = {"course": args.course, "frames": n, "image": f"{cs.W}x{cs.H}",
           "card": cs.card_line(), "render_s": time.perf_counter() - t}
    config = VOConfig.for_image(cs.H, cs.W)
    intr = cs.kitti_intrinsics(cs.H, cs.W)

    poses, fetched, wall, steps, snaps = pipeline.run_sequence_scan(
        frames, config, intr, chunk=cs.CHUNK, collect_tracks=True,
        device=dev)
    if args.save_tracks:
        os.makedirs(args.save_tracks, exist_ok=True)
        np.savez_compressed(
            os.path.join(args.save_tracks, f"tracks_{args.course}.npz"),
            **{k: np.stack([getattr(s, k) for s in snaps])
               for k in pipeline.TrackSnapshot._fields})
        np.savez_compressed(
            os.path.join(args.save_tracks, f"poses_{args.course}.npz"),
            poses=poses, gt=gt, accept=fetched.accept,
            **{k: getattr(intr, k) for k in ("fx", "fy", "cx", "cy", "bf",
                                             "width", "height")})
    ate, budget = cs.ate_and_budget(poses, gt)
    res.update(steps=steps, scan_s=wall, fps=steps / wall,
               accept=float(np.mean(fetched.accept)), ate_chain_m=ate,
               ate_budget_m=budget)
    for name, kw in (("ba_km", cs.BA_KM), ("ba", cs.BA_SHORT)):
        t = time.perf_counter()
        smoothed = smooth_trajectory_ba(snaps, poses, intr, device=dev, **kw)
        res[f"ate_{name}_m"] = cs.ate_and_budget(smoothed, gt)[0]
        res[f"{name}_s"] = time.perf_counter() - t
    if args.course == "loop":
        lf = SyntheticStereoSequence._loop_schedule(n)[2]
        t = time.perf_counter()
        pg, info = loopclosure.close_loops(poses, lambda i: frames[i], config,
                                           intr, gt_loop_pair=(0, lf),
                                           device=dev)
        res.update(loop_frame=lf, loop_s=time.perf_counter() - t,
                   candidates=len(info.candidates), loop_edges=info.edges,
                   closure_before_m=info.closure_before_m,
                   closure_after_m=info.closure_after_m,
                   closure_gt_m=float(np.linalg.norm(gt[lf, :3, 3]
                                                     - gt[0, :3, 3])),
                   ate_pg_m=cs.ate_and_budget(pg, gt)[0])
    line = json.dumps(res)
    print(line)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, f"backend_{args.course}.json"),
                  "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
