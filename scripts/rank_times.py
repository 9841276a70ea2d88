#!/usr/bin/env python3
"""Time the multi-device paths on several cards: one process driving every
card against one rank per card over NCCL, on the same cards.

    python3 scripts/rank_times.py [--cards 2 4] [--reps 5] [--mesh]
                                  [--out DIR]

For each card count n it times, first from one process over a mesh of the
first n cards and then from n ranks, one per card:

- ``sharded_ba``: one GN iteration of ``sharded_ba_solve`` over n landmark
  shards, at the sizes of ``chip_smoke.SHARDED_BA_PROBLEMS``;
- ``ring``: one round of ``ring_ba_solve`` over n windows of
  ``chip_smoke``'s ring problem (``RING_CG_ITERS`` CG iterations);
- ``mesh_step``: ``run_sequences_batched`` of ``chip_smoke``'s four batched
  courses at 1241x376 for ``MESH_STEPS`` steps on a (2, n/2) mesh, ms per
  step (the runner's wall over its loop); with two cards also
  ``mesh_step_1x2``, the same on a (1, 2) mesh;
- ``posegraph``: one GN iteration of ``sharded_posegraph_solve`` of a
  64-keyframe circle, its edges split over n cards.

A time is the median over ``--reps`` calls of the host's wall from the call
to the end of the work on every card it used (each rank: a barrier, the
call, its card's synchronize; the slowest rank's time counts). Prints one
JSON line per (n, part, form), the card line, and writes them to
``DIR/rank_times.json``. Needs n cards for each n; run from the root of a
checkout.

With ``--mesh`` every part is timed graphed (the default on a card:
``utils.cudagraph`` replays wherever the dispatch rule allows) against
eager (``dispatch(False)``) in ``--reps`` paired rounds (graph eager,
eager graph, ...) after one warm call each way, in both forms, and
``sharded_ba`` runs ``chip_smoke.SHARDED_BA_ITERS`` iterations a call and
``ring`` ``chip_smoke.RING_GRAPH_ROUNDS`` rounds and ``posegraph`` 10
iterations (ms per iteration or round). From one process the (2, 1) mesh
of 2 cards replays each row's graph on its own card, and a row or a
solver axis across cards replays each card's graphs in turn, with the
copies between cards between them (``utils.cudagraph._Recording``); in
the rank-per-card form every NCCL rank replays its own graphs, its
collectives inside them. Lines carry ``mode`` ("graph" or "eager") and go
to ``DIR/rank_times_mesh.json``.
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


def _ops(devices, cards, frames, mesh_mode=False):
    """{part: fn()} over a mesh of ``devices`` (devices or ranks); with
    ``mesh_mode`` the solvers run several iterations (rounds) a call and
    return ms per iteration (round)."""
    from visual_odom_tpu_torch.ba import posegraph, problem
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
        iters = cs.SHARDED_BA_ITERS if mesh_mode else 1
        ops[f"sharded_ba_W{w}_L{lm}"] = _per(
            lambda p=p, mesh=mesh, iters=iters: sharded_ba_solve(
                p, mesh, iterations=iters), iters, cards)
    ring = cs._ring_problem(dev)
    seq = make_mesh({"seq": n}, devices)
    rounds = cs.RING_GRAPH_ROUNDS if mesh_mode else 1
    ops["ring"] = _per(lambda: ring_ba_solve(
        ring, seq, halo=cs.RING_HALO, rounds=rounds,
        cg_iters=cs.RING_CG_ITERS), rounds, cards)
    config = VOConfig.for_image(cs.H, cs.W)
    intr = cs.kitti_intrinsics(cs.H, cs.W)
    seqs = [[(f[0], f[1]) for f in c] for c in frames]
    grids = {"mesh_step": (2, n // 2)}
    if n == 2:
        grids["mesh_step_1x2"] = (1, 2)
    for name, (rows, cols) in grids.items():
        grid = make_mesh({"data": rows, "model": cols}, devices)
        # the runner's own wall over its loop, per step
        ops[name] = lambda grid=grid: 1e3 * run_sequences_batched(
            seqs, config, intr, chunk=cs.MESH_CHUNK,
            mesh=grid)[2] / cs.MESH_STEPS
    graph = posegraph.build_keyframe_graph(*cs._circle_chain(), device=dev)
    edges = make_mesh({"model": n}, devices)
    iters = 10 if mesh_mode else 1
    ops["posegraph"] = _per(lambda: posegraph.sharded_posegraph_solve(
        graph, edges, iterations=iters), iters, cards)
    return ops


def _per(fn, per, cards):
    """``fn`` timed whole, as ms per ``per`` (iterations, rounds): a call
    returns its own ms (the work on ``cards`` included)."""
    if per == 1:
        return fn

    def timed():
        import torch

        t = time.perf_counter()
        fn()
        for d in cards:
            torch.cuda.synchronize(d)
        return 1e3 * (time.perf_counter() - t) / per

    return timed


def _paired(fn, cards, reps, barrier=None) -> dict:
    """{"graph": [ms...], "eager": [ms...]}: one warm call each way, then
    ``reps`` paired rounds (graph eager, eager graph, ...); graphed is the
    default on a card, eager ``utils.cudagraph.dispatch(False)``."""
    import contextlib

    from visual_odom_tpu_torch.utils.cudagraph import dispatch

    def mode(graphed):
        return contextlib.nullcontext() if graphed else dispatch(False)

    for graphed in (True, False):
        with mode(graphed):
            _time(fn, cards, 0, barrier)
    out = {"graph": [], "eager": []}
    for k in range(reps):
        for graphed in ((True, False) if k % 2 == 0 else (False, True)):
            with mode(graphed):
                out["graph" if graphed else "eager"] += _time(
                    fn, cards, 1, barrier, warm=False)
    return out


def _time(fn, cards, reps, barrier=None, warm=True) -> list:
    """Walls (ms) of ``reps`` calls after one warm call: the call and the
    end of the work on ``cards``, or the ms the call returns."""
    import torch

    out = []
    for i in range(reps + int(warm)):
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
        if i or not warm:
            out.append(ms)
    return out


def rank_main(world, rank, port, where, reps, mesh_mode=False) -> int:
    import torch
    import torch.distributed as dist

    from visual_odom_tpu_torch.parallel.mesh import (initialize_distributed,
                                                     visible_devices)

    dev = torch.device("cuda", rank)
    initialize_distributed(f"127.0.0.1:{port}", world, rank, device=dev)
    frames = np.load(os.path.join(where, "frames.npy"))
    ops = _ops(visible_devices(), [dev], frames, mesh_mode)
    clock = _paired if mesh_mode else _time
    times = {k: clock(fn, [dev], reps, barrier=dist.barrier)
             for k, fn in ops.items()}
    with open(os.path.join(where, f"times-{world}-{rank}.json"), "w") as f:
        json.dump(times, f)
    dist.destroy_process_group()
    return 0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cards", type=int, nargs="+", default=[2, 4])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--mesh", action="store_true")
    ap.add_argument("--out", default=".")
    ap.add_argument("--rank", nargs=4, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.rank:
        world, rank, port, where = args.rank
        return rank_main(int(world), int(rank), int(port), where, args.reps,
                         args.mesh)
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
            clock = _paired if args.mesh else _time
            one = {k: clock(fn, cards, args.reps)
                   for k, fn in _ops(cards, cards, frames, args.mesh).items()}
            with socket.socket() as s:
                s.bind(("127.0.0.1", 0))
                port = s.getsockname()[1]
            procs = [subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--reps",
                 str(args.reps), "--rank", str(n), str(r), str(port), where]
                + (["--mesh"] if args.mesh else [])) for r in range(n)]
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
                modes = ({m: (t_one[m], np.max([r[part][m] for r in ranks],
                                               axis=0).tolist())
                          for m in ("graph", "eager")} if args.mesh else
                         {None: (t_one, np.max([r[part] for r in ranks],
                                               axis=0).tolist())})
                for m, (t1, slowest) in modes.items():
                    for form, ts in (("one_process", t1),
                                     ("rank_per_card", slowest)):
                        line = dict(cards=n, part=part, form=form,
                                    **({"mode": m} if m else {}),
                                    ms_median=float(np.median(ts)), ms=ts,
                                    card=f"{n} x {card}")
                        lines.append(line)
                        print("rank_times", json.dumps(line), flush=True)
    os.makedirs(args.out, exist_ok=True)
    name = "rank_times_mesh.json" if args.mesh else "rank_times.json"
    with open(os.path.join(args.out, name), "w") as f:
        json.dump(lines, f, indent=1)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
