#!/usr/bin/env python3
"""Time the multi-device paths on several cards: one process driving every
card against one rank per card over NCCL, on the same cards.

    python3 scripts/rank_times.py [--cards 2 4] [--reps 5] [--out DIR]

For each card count n it times, first from one process over a mesh of the
first n cards and then from n ranks, one per card:

- ``sharded_ba``: one GN iteration of ``sharded_ba_solve`` over n landmark
  shards, at the sizes of ``chip_smoke.SHARDED_BA_PROBLEMS``;
- ``ring``: one round of ``ring_ba_solve`` over n windows of
  ``chip_smoke``'s ring problem (``RING_CG_ITERS`` CG iterations);
- ``mesh_step``: ``run_sequences_batched`` of ``chip_smoke``'s four batched
  courses at 1241x376 for ``MESH_STEPS`` steps on a (2, n/2) mesh, ms per
  step (the runner's wall over its loop).

A time is the median over ``--reps`` calls of the host's wall from the call
to the end of the work on every card it used (each rank: a barrier, the
call, its card's synchronize; the slowest rank's time counts). Prints one
JSON line per (n, part, form), the card line, and writes them to
``DIR/rank_times.json``. Needs n cards for each n; run from the root of a
checkout.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402


def _ops(devices, cards, frames):
    """{part: fn()} over a mesh of ``devices`` (devices or ranks)."""
    from visual_odom_tpu_torch.ba import problem
    from visual_odom_tpu_torch.config import VOConfig
    from visual_odom_tpu_torch.parallel.batch_eval import run_sequences_batched
    from visual_odom_tpu_torch.parallel.mesh import make_mesh
    from visual_odom_tpu_torch.parallel.ring_ba import ring_ba_solve
    from visual_odom_tpu_torch.parallel.sharded_ba import sharded_ba_solve

    n = len(devices)
    dev = cards[0]
    ops = {}
    for w, lm in cs.SHARDED_BA_PROBLEMS:
        p = problem.synthetic_ba_problem(num_poses=w, num_landmarks=lm,
                                         seed=7, obs_window=None if w <= 8
                                         else 2, device=dev)[0]
        mesh = make_mesh({"data": 1, "model": n}, devices)
        ops[f"sharded_ba_W{w}_L{lm}"] = (
            lambda p=p, mesh=mesh: sharded_ba_solve(p, mesh, iterations=1))
    ring = cs._ring_problem(dev)
    seq = make_mesh({"seq": n}, devices)
    ops["ring"] = lambda: ring_ba_solve(ring, seq, halo=cs.RING_HALO,
                                        rounds=1, cg_iters=cs.RING_CG_ITERS)
    config = VOConfig.for_image(cs.H, cs.W)
    intr = cs.kitti_intrinsics(cs.H, cs.W)
    seqs = [[(f[0], f[1]) for f in c] for c in frames]
    grid = make_mesh({"data": 2, "model": n // 2}, devices)
    # the runner's own wall over its loop, per step
    ops["mesh_step"] = lambda: 1e3 * run_sequences_batched(
        seqs, config, intr, chunk=cs.MESH_CHUNK, mesh=grid)[2] / cs.MESH_STEPS
    return ops


def _time(fn, cards, reps, barrier=None) -> list:
    """Walls (ms) of ``reps`` calls after one warm call: the call and the
    end of the work on ``cards``, or the ms the call returns."""
    import torch

    out = []
    for i in range(reps + 1):
        if barrier:
            barrier()
        for d in cards:
            torch.cuda.synchronize(d)
        t = time.perf_counter()
        r = fn()
        for d in cards:
            torch.cuda.synchronize(d)
        ms = 1e3 * (time.perf_counter() - t)
        if isinstance(r, float):
            ms = r
        if i:
            out.append(ms)
    return out


def rank_main(world, rank, port, where, reps) -> int:
    import torch
    import torch.distributed as dist

    from visual_odom_tpu_torch.parallel.mesh import (initialize_distributed,
                                                     visible_devices)

    dev = torch.device("cuda", rank)
    initialize_distributed(f"127.0.0.1:{port}", world, rank, device=dev)
    frames = np.load(os.path.join(where, "frames.npy"))
    ops = _ops(visible_devices(), [dev], frames)
    times = {k: _time(fn, [dev], reps, barrier=dist.barrier)
             for k, fn in ops.items()}
    with open(os.path.join(where, f"times-{world}-{rank}.json"), "w") as f:
        json.dump(times, f)
    dist.destroy_process_group()
    return 0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cards", type=int, nargs="+", default=[2, 4])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--out", default=".")
    ap.add_argument("--rank", nargs=4, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.rank:
        world, rank, port, where = args.rank
        return rank_main(int(world), int(rank), int(port), where, args.reps)
    import socket

    import torch

    if torch.cuda.device_count() < max(args.cards):
        print(f"rank_times: needs {max(args.cards)} cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    card = cs.card_line()
    lines = []
    with tempfile.TemporaryDirectory() as where:
        courses = cs.render_courses(
            [(k[0], k[1], cs.MESH_STEPS + 1) for k in cs.BATCH_COURSES],
            cs.H, cs.W)
        frames = np.stack([np.stack([np.stack(f) for f in courses[k][0]])
                           for k in cs.BATCH_COURSES])
        np.save(os.path.join(where, "frames.npy"), frames)
        for n in args.cards:
            cards = [torch.device("cuda", i) for i in range(n)]
            one = {k: _time(fn, cards, args.reps)
                   for k, fn in _ops(cards, cards, frames).items()}
            with socket.socket() as s:
                s.bind(("127.0.0.1", 0))
                port = s.getsockname()[1]
            procs = [subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--reps",
                 str(args.reps), "--rank", str(n), str(r), str(port), where])
                for r in range(n)]
            try:
                for p in procs:
                    p.wait(timeout=900)
            finally:
                for p in procs:
                    if p.poll() is None:
                        p.kill()
                        p.wait()
            if any(p.returncode for p in procs):
                raise RuntimeError(f"ranks of {n} cards failed: "
                                   f"{[p.returncode for p in procs]}")
            ranks = [json.load(open(os.path.join(
                where, f"times-{n}-{r}.json"))) for r in range(n)]
            for part, t_one in one.items():
                slowest = np.max([r[part] for r in ranks], axis=0)
                for form, ts in (("one_process", t_one),
                                 ("rank_per_card", slowest.tolist())):
                    line = dict(cards=n, part=part, form=form,
                                ms_median=float(np.median(ts)), ms=ts,
                                card=f"{n} x {card}")
                    lines.append(line)
                    print("rank_times", json.dumps(line), flush=True)
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "rank_times.json"), "w") as f:
        json.dump(lines, f, indent=1)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
