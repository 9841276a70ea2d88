#!/usr/bin/env python3
"""A KITTI PNG stream against the in-memory scan, in turns, on one GPU.

    python3 scripts/kitti_turns.py [--steps 64] [--rounds 10] [--out DIR]

Renders the "straight" course at 1241x376 (the bench's camera), writes it
as a KITTI directory of PNGs (``chip_smoke.write_kitti``'s writer) and
runs ``run_sequence_scan`` (chunk 32) over it in turns, ``--rounds``
times, reversing the order every round (A B C C B A ...), so that the
host's drift within a call falls on every variant alike:

- ``memory``: the rendered frames, one upload thread;
- ``png_1``, ``png_4``: ``KittiSequence.iter_prefetched(n_threads=4)``
  (the native decoder; ``cv2`` and ``PIL`` hidden) with 1 and 4 upload
  threads.

Every run must give the first in-memory scan's poses bit for bit. Also
times the native decoder alone on the course's left images, on one thread
(µs per image) and through the prefetcher (its images per second). Prints
one JSON line per variant (ms per frame of each run and their median; the
host CPU seconds the process spent per frame, all threads; each round's
difference from that round's ``memory`` run, its median, and the rounds
the variant was slower) and the card's name and power limit; with
``--out DIR`` the lines also go to ``DIR/kitti_turns.json``. Exits
non-zero without a card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

VARIANTS = ("memory", "png_1", "png_4")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=64)
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("kitti_turns: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from visual_odom_tpu_torch.config import VOConfig
    from visual_odom_tpu_torch.io import native
    from visual_odom_tpu_torch.io.kitti import KittiSequence
    from visual_odom_tpu_torch.runner import pipeline

    dev = torch.device("cuda", 0)
    card = cs.card_line()
    key = ("straight", "value")
    courses = cs.render_courses([key + (args.steps + 1,)], cs.H, cs.W)
    frames = courses[key][0]
    config = VOConfig.for_image(cs.H, cs.W)
    intr = cs.kitti_intrinsics(cs.H, cs.W)
    native.build_library()

    def scan(variant, seq):
        src = (frames if variant == "memory"
               else seq.iter_prefetched(n_threads=4))
        cpu = time.process_time()
        poses, _, wall, n = pipeline.run_sequence_scan(
            src, config, intr, chunk=32, warmup=False,
            upload_threads=4 if variant == "png_4" else 1, device=dev)
        return wall, time.process_time() - cpu, n, poses

    with tempfile.TemporaryDirectory() as root, cs.image_packages_hidden():
        dirs, size = cs.write_kitti(courses, (key,), root)
        seq = KittiSequence(dirs[key])
        left = [os.path.join(seq.left_dir, f"{i:06d}.png")
                for i in range(len(seq))]
        t = time.perf_counter()
        for p in left:
            native.decode_png_gray(p)
        decode_us = 1e6 * (time.perf_counter() - t) / len(left)
        t = time.perf_counter()
        n_pref = sum(2 for _ in seq.iter_prefetched(n_threads=4))
        prefetch_rate = n_pref / (time.perf_counter() - t)
        # first use: kernel build and load, library initialisation
        _, _, n, ref = scan("memory", seq)
        runs = {v: [] for v in VARIANTS}
        for k in range(args.rounds):
            for v in (VARIANTS if k % 2 == 0 else VARIANTS[::-1]):
                wall, cpu, m, poses = scan(v, seq)
                if not (m == n and np.array_equal(poses, ref)):
                    raise AssertionError(f"{v}: poses differ from memory's")
                runs[v].append((wall, cpu))
    lines = []
    for v, rs in runs.items():
        ms = [1e3 * w / n for w, _ in rs]
        # paired with the memory run of the same round, so the host's
        # drift between rounds cancels
        diff = [1e3 * (w - m) / n for (w, _), (m, _) in zip(rs, runs["memory"])]
        lines.append({
            "variant": v, "steps": n, "rounds": args.rounds,
            "ms_per_frame": ms, "median_ms_per_frame": float(np.median(ms)),
            "host_cpu_ms_per_frame": [1e3 * c / n for _, c in rs],
            "median_host_cpu_ms_per_frame": float(np.median(
                [1e3 * c / n for _, c in rs])),
            "minus_memory_ms": diff,
            "median_minus_memory_ms": float(np.median(diff)),
            "rounds_slower_than_memory": sum(d > 0 for d in diff),
            "poses_vs_memory": True, "card": card})
        print("kitti_turns", json.dumps(lines[-1]))
    summary = {"decode_us_per_image": decode_us,
               "prefetch_images_per_s": prefetch_rate,
               "png_mb": size / 1e6, "cpus": os.cpu_count(), "card": card}
    print(json.dumps(summary))
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "kitti_turns.json"), "w") as f:
            json.dump({"variants": lines, **summary}, f, indent=1)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
