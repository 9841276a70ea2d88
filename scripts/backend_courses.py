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
``DIR/backend_<course>.json``.
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--course", choices=sorted(FRAMES), required=True)
    ap.add_argument("--out", help="directory for backend_<course>.json")
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
