#!/usr/bin/env python3
"""Probe NCCL ranks replaying CUDA graphs in a world of more than one rank,
which ``parallel.collectives.graph_place`` keeps eager by rule.

    python3 scripts/nccl_graph_probe.py [--world 2] [--limit 90]

Builds the LK kernels, then spawns ``--world`` ranks, rank r on card r,
each running ``tests/torch_dist_worker.py``'s ``card_graph`` scenario (the
mesh step and scan on both LK routes and the three solvers, eager and then
by default) with the world-size rule lifted, so that every rank captures
and replays its graphs with its NCCL collectives inside them. Each rank
logs each capture's warm-up, capture and end. After ``--limit`` seconds
what is left is killed; prints each rank's exit code and the tail of its
log, whose last line names the body a stuck rank was in or past. Needs
``--world`` cards; run from the root of a checkout.
"""

from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))


def rank_main(argv) -> int:
    """One rank: ``torch_dist_worker.main`` on ``argv`` with NCCL ranks of
    a larger world let through ``graph_place``."""
    from visual_odom_tpu_torch.parallel import collectives

    rule = collectives.graph_place

    def lifted(axis):
        dev, why = rule(axis)
        return (dev, None) if why and "world of" in why else (dev, why)

    collectives.graph_place = lifted
    import torch_dist_worker

    sys.argv = [torch_dist_worker.__file__] + argv
    return torch_dist_worker.main()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--world", type=int, default=2)
    ap.add_argument("--limit", type=float, default=90.0)
    ap.add_argument("--rank", nargs=5, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.rank:
        return rank_main(args.rank)
    import torch

    if torch.cuda.device_count() < args.world:
        print(f"nccl_graph_probe: needs {args.world} cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    from visual_odom_tpu_torch.ops import lk_cuda

    lk_cuda._library()          # built here once, so that no rank builds it
    where = tempfile.mkdtemp()
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=ROOT)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        coordinator = f"127.0.0.1:{s.getsockname()[1]}"
    logs = [os.path.join(where, f"rank{r}.log") for r in range(args.world)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--rank", "card_graph",
         coordinator, str(args.world), str(r), where], env=env,
        stdout=open(logs[r], "w"), stderr=subprocess.STDOUT)
        for r in range(args.world)]
    t = time.monotonic()
    while (time.monotonic() - t < args.limit
           and any(p.poll() is None for p in procs)):
        time.sleep(1)
    for p in procs:
        if p.poll() is None:
            p.kill()
    print("exit codes", [p.wait() for p in procs],
          f"after {time.monotonic() - t:.1f} s")
    for r, log in enumerate(logs):
        text = open(log).read()
        print(f"--- rank {r}")
        print(text[-3500:])
    return 0 if all(p.returncode == 0 for p in procs) else 1


if __name__ == "__main__":
    sys.exit(main())
