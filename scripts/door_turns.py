#!/usr/bin/env python3
"""The port's front doors timed side by side, in turns, on one GPU.

    python3 scripts/door_turns.py [--steps 64] [--rounds 4] [--out DIR]

Renders the "straight" course at 1241x376 (the bench's camera) and runs
each door over it in turns, ``--rounds`` times, reversing the order every
round (A B C ... C B A ...), so that the host's drift within a call falls
on every door alike:

- ``scan``: ``run_sequence_scan`` (chunk 32, one upload thread);
- ``scan_preupload``, ``scan_threads_4``: the bench's two variants
  (bench.py:126-138);
- ``visual_odometry``: ``VisualOdometry.process_frame`` frame by frame (one
  fetch a frame), timed around the loop;
- ``buffered``: ``run_sequence_buffered(preupload=True)``, and
  ``buffered_streamed`` (``preupload=False``).

Every run must give the first scan's poses bit for bit. Prints one JSON
line per door (ms per frame of each run and their median; each round's
difference from that round's scan, its median, and the rounds the door
beat the scan) and the card's name and power limit; with ``--out DIR``
the lines also go to ``DIR/door_turns.json``. Exits non-zero without a
card.
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

DOORS = ("scan", "scan_preupload", "scan_threads_4", "visual_odometry",
         "buffered", "buffered_streamed")


def run_door(door, frames, config, intr, dev) -> tuple:
    """(wall seconds, poses) of one door over ``frames``."""
    import torch

    from visual_odom_tpu_torch.runner import pipeline

    if door.startswith("scan"):
        kw = {"scan_preupload": dict(preupload=True),
              "scan_threads_4": dict(upload_threads=4)}.get(door, {})
        poses, _, wall, _ = pipeline.run_sequence_scan(
            frames, config, intr, chunk=32, warmup=False, device=dev, **kw)
        return wall, poses
    if door.startswith("buffered"):
        poses, _, wall = pipeline.run_sequence_buffered(
            frames, config, intr, preupload=door == "buffered", device=dev)
        return wall, poses
    vo = pipeline.VisualOdometry(config, intr, device=dev)
    vo.initialize(*frames[0])
    torch.cuda.synchronize(dev)
    t = time.perf_counter()
    poses = [np.eye(4)] + [vo.process_frame(l, r).pose for l, r in frames[1:]]
    return time.perf_counter() - t, np.stack(poses)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=64)
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("door_turns: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from visual_odom_tpu_torch.config import VOConfig

    dev = torch.device("cuda", 0)
    card = cs.card_line()
    t = time.perf_counter()
    frames, _ = cs.render_courses([("straight", "value", args.steps + 1)],
                                  cs.H, cs.W)[("straight", "value")]
    render_s = time.perf_counter() - t
    config = VOConfig.for_image(cs.H, cs.W)
    intr = cs.kitti_intrinsics(cs.H, cs.W)
    # first use: kernel build and load, library initialisation
    _, ref = run_door("scan", frames, config, intr, dev)

    walls = {d: [] for d in DOORS}
    for k in range(args.rounds):
        for door in (DOORS if k % 2 == 0 else DOORS[::-1]):
            wall, poses = run_door(door, frames, config, intr, dev)
            if not np.array_equal(poses, ref):
                raise AssertionError(f"{door}: poses differ from the scan's")
            walls[door].append(wall)
    n = len(frames) - 1
    lines = []
    for door, ws in walls.items():
        ms = [1e3 * w / n for w in ws]
        # paired with the scan of the same round, so the host's drift
        # between rounds cancels
        diff = [1e3 * (w - s) / n for w, s in zip(ws, walls["scan"])]
        lines.append({"door": door, "steps": n, "rounds": args.rounds,
                      "ms_per_frame": ms,
                      "median_ms_per_frame": float(np.median(ms)),
                      "minus_scan_ms": diff,
                      "median_minus_scan_ms": float(np.median(diff)),
                      "rounds_faster_than_scan": sum(d < 0 for d in diff),
                      "poses_vs_scan": True, "card": card})
        print("door_turns", json.dumps(lines[-1]))
    print(json.dumps({"render_s": render_s, "card": card}))
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "door_turns.json"), "w") as f:
            json.dump(lines, f, indent=1)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
