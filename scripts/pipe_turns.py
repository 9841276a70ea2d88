#!/usr/bin/env python3
"""The pipelined runner against the in-memory scan, in turns, on one GPU.

    python3 scripts/pipe_turns.py [--steps 64] [--rounds 10] [--out DIR]

Renders the "straight" course at 1241x376 (the bench's camera) and runs,
``--rounds`` times, reversing the order every round (A B B A ...), so that
the host's drift within a call falls on both alike:

- ``scan``: ``run_sequence_scan`` (chunk 32, one upload thread, no
  warm-up), the frames in memory;
- ``pipe``: ``run_sequence_pipelined`` on the same frames with both stages
  on this card, each on a CUDA stream of its own.

Every run must give the first scan's poses bit for bit. Prints one JSON
line per variant (ms per frame of each run and their median; the host CPU
seconds the process spent per frame, all threads; each round's difference
from that round's ``scan`` run, its median, and the rounds the variant was
slower) and the card's name and power limit; with ``--out DIR`` the lines
also go to ``DIR/pipe_turns.json``. Exits non-zero without a card.
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

VARIANTS = ("scan", "pipe")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=64)
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("pipe_turns: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from visual_odom_tpu_torch.config import VOConfig
    from visual_odom_tpu_torch.parallel.pipe import run_sequence_pipelined
    from visual_odom_tpu_torch.runner import pipeline

    dev = torch.device("cuda", 0)
    card = cs.card_line()
    key = ("straight", "value")
    frames = cs.render_courses([key + (args.steps + 1,)], cs.H, cs.W)[key][0]
    config = VOConfig.for_image(cs.H, cs.W)
    intr = cs.kitti_intrinsics(cs.H, cs.W)

    def run(variant):
        cpu = time.process_time()
        if variant == "scan":
            poses, _, wall, _ = pipeline.run_sequence_scan(
                frames, config, intr, chunk=32, warmup=False, device=dev)
        else:
            poses, _, wall = run_sequence_pipelined(frames, config, intr,
                                                    devices=[dev, dev])
        return wall, time.process_time() - cpu, poses

    # first use: kernel build and load, library initialisation
    _, _, ref = run("scan")
    run("pipe")
    n = len(frames) - 1
    runs = {v: [] for v in VARIANTS}
    for k in range(args.rounds):
        for v in (VARIANTS if k % 2 == 0 else VARIANTS[::-1]):
            wall, cpu, poses = run(v)
            if not np.array_equal(poses, ref):
                raise AssertionError(f"{v}: poses differ from the scan's")
            runs[v].append((wall, cpu))
    lines = []
    for v, rs in runs.items():
        ms = [1e3 * w / n for w, _ in rs]
        # paired with the scan run of the same round, so the host's drift
        # between rounds cancels
        diff = [1e3 * (w - s) / n for (w, _), (s, _) in zip(rs, runs["scan"])]
        lines.append({
            "variant": v, "steps": n, "rounds": args.rounds,
            "ms_per_frame": ms, "median_ms_per_frame": float(np.median(ms)),
            "host_cpu_ms_per_frame": [1e3 * c / n for _, c in rs],
            "median_host_cpu_ms_per_frame": float(np.median(
                [1e3 * c / n for _, c in rs])),
            "minus_scan_ms": diff,
            "median_minus_scan_ms": float(np.median(diff)),
            "rounds_slower_than_scan": sum(d > 0 for d in diff),
            "poses_vs_scan": True, "card": card})
        print("pipe_turns", json.dumps(lines[-1]))
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "pipe_turns.json"), "w") as f:
            json.dump({"variants": lines, "cpus": os.cpu_count(),
                       "card": card}, f, indent=1)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
