#!/usr/bin/env python3
"""The scan family's step replayed from its CUDA graph against the eager
step, in turns, on one GPU.

    python3 scripts/graph_turns.py [--steps 64] [--mono-steps 32]
                                   [--batch-steps 16] [--rounds 10]
                                   [--doors | --mesh] [--cases NAME ...]
                                   [--out DIR]

Renders the "straight" course at 1241x376 (the bench's camera) and the
batched path's other courses (checker texture, "turning", "stress"), and
runs each case ``--rounds`` times graphed and eager, reversing the order
every round (graph eager, eager graph, ...), so that the host's drift
within a call falls on both alike:

- ``quad``: ``run_sequence_scan`` (chunk 32, one upload thread, no
  warm-up) over ``--steps`` steps of "straight", the default step;
- ``mono``: the same with ``mono_rotation=True`` over ``--mono-steps``;
- ``b1``, ``b4``, ``b11``: ``run_sequences_batched`` (one chunk of
  ``--batch-steps``, its upload outside the wall) over the four courses
  tiled to B sequences.

With ``--doors`` the cases are the per-frame doors and the back end's
solve instead, graphed (``utils.cudagraph.dispatch(True)``, the default on
a card) against eager (``dispatch(False)``):

- ``vo``: ``run_sequence`` (``VisualOdometry``, one fetch a frame) over
  ``--steps`` steps of "straight";
- ``buffered``: ``run_sequence_buffered`` (every frame on the card first)
  over the same steps;
- ``pipe``: ``run_sequence_pipelined`` with both stages on this card;
- ``ba``: ``ba_solve`` of the first BA window (window 8, 256 landmarks,
  Huber 1.5, 8 iterations: the command line's short-course settings) of
  a ``collect_tracks`` scan of "straight", per GN iteration.

With ``--mesh`` the cases are the multi-device paths of one process,
graphed against eager the same way:

- ``mesh_2x1_card``, ``mesh_2x2_card``: ``run_sequences_batched`` (one
  chunk of ``--batch-steps``) of the four batched courses (B = 4) on a
  (2, 1) and a (2, 2) mesh of this card named 2 and 4 times, per step;
- with two cards or more, ``mesh_2x1_across`` and ``mesh_1x2_across``:
  the same on a (2, 1) and a (1, 2) mesh of cards 0 and 1 (rows of one
  card each replay their own graph; a row across the two cards replays
  each card's graphs in turn, ``utils.cudagraph._Recording``); with four,
  ``mesh_2x2_across`` on cards 0-3;
- ``sharded_ba``: ``sharded_ba_solve`` over this card named
  ``chip_smoke.MODEL_SHARDS`` times (``chip_smoke.SHARDED_BA_PROBLEMS[0]``,
  ``SHARDED_BA_ITERS`` iterations), per GN iteration; ``ring``:
  ``ring_ba_solve`` of ``chip_smoke``'s ring problem over
  ``RING_WINDOWS`` windows of this card (``RING_GRAPH_ROUNDS`` rounds of
  ``RING_CG_ITERS`` CG iterations), per round; ``posegraph``:
  ``sharded_posegraph_solve`` of a 64-keyframe circle, per GN iteration;
- over distinct cards: ``sharded_ba_across_2`` (with two cards or more)
  and ``sharded_ba_across_4``, ``ring_across_4`` and
  ``posegraph_across_4`` (with four): the same solves, one shard, window
  or edge slice per card.

``--cases`` runs only the cases whose names contain one of the given
strings (``--mesh --cases across``: the cases over distinct cards). The
multi-card times of one rank per card are ``scripts/rank_times.py
--mesh``'s. Their profiles cover one door run over 4 frames (the state's
first pyramids included), one mesh run of 4 steps, or one solve. Scan-family graphed runs
replay the step's graph (the default on a card); eager
ones run inside ``chip_smoke.scans(False)``
(``make_scan_step_fn(_graph=False)``). Every run must give its case's
first run's poses bit for bit. Each case's graph is captured before the
rounds. Then each case's step is profiled
(torch.profiler, 4 frames of one chunk, graphed and eager): device ms a
frame (or a batched step), device ops, the LK kernels seen inside the
replays, and the host's CUDA runtime calls per frame. Prints one JSON line
per case (ms per frame of each run and their median, the host CPU ms per
frame, frames/s (aggregate for B sequences), each round's graph-minus-eager
difference and the rounds the graph won, device ms and busy share: device
ms over the median wall) and the card's name and power limit; with
``--out DIR`` the lines also go to ``DIR/graph_turns.json`` (or, with
``--doors``, ``DIR/graph_turns_doors.json``; with ``--mesh``,
``DIR/graph_turns_mesh.json``). Exits non-zero without a card.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

PROFILE_FRAMES = 4


def profile_scan(frames, config, intr, dev, graphed):
    """Device ms, device ops and LK kernels per frame (per batched step for
    (B, H, W) frames) over PROFILE_FRAMES frames of one scan chunk, and
    the host's CUDA runtime calls per frame; the chunk before it, outside
    the profile, captures the graph where it is not yet captured."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from visual_odom_tpu_torch.parallel import batch
    from visual_odom_tpu_torch.runner import pipeline

    if frames[0][0].ndim == 3:
        state = batch.batched_init_state(config, *frames[0], device=dev)
    else:
        state = pipeline.init_vo_state(config, intr, *frames[0], device=dev)
    scan = pipeline.make_scan_step_fn(config, intr, device=dev,
                                      _graph=graphed)
    lefts, rights = (torch.from_numpy(np.stack(
        [f[k] for f in frames[1:PROFILE_FRAMES + 2]])).to(dev)
        for k in (0, 1))
    state, _ = scan(state, lefts[:1], rights[:1])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        scan(state, lefts[1:], rights[1:])
        torch.cuda.synchronize()
    rows = cs.device_rows(prof)
    n = PROFILE_FRAMES
    return {"device_ms": sum(r[0] for r in rows) / 1e3 / n,
            "device_ops": sum(r[2] for r in rows) / n,
            "lk_kernels": sum(c for _, k, c in rows
                              if "lk_quad_kernel" in k
                              or "lk_level_kernel" in k) / n,
            "host_runtime_calls": cs.host_calls(prof, n)}


def profile_run(run, per):
    """Device ms, device ops and LK kernels per step of one ``run()``
    (``per`` steps) under torch.profiler, and the host's CUDA runtime calls
    per step; a first ``run()`` outside the profile captures its graphs."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    rows = cs.device_rows(prof)
    return {"device_ms": sum(r[0] for r in rows) / 1e3 / per,
            "device_ops": sum(r[2] for r in rows) / per,
            "lk_kernels": sum(c for _, k, c in rows
                              if "lk_quad_kernel" in k
                              or "lk_level_kernel" in k) / per,
            "host_runtime_calls": cs.host_calls(prof, per)}


def door_cases(args, straight, config, intr, dev):
    """``--doors``: {case: (run(graphed) -> (wall, steps, result),
    profile(graphed) -> profile_run's dict, batch)}."""
    import torch

    import chip_smoke as cs
    from visual_odom_tpu_torch.ba import schur, window
    from visual_odom_tpu_torch.parallel import pipe
    from visual_odom_tpu_torch.runner import pipeline
    from visual_odom_tpu_torch.utils.cudagraph import dispatch

    frames = straight[:args.steps + 1]
    small = straight[:PROFILE_FRAMES + 1]

    def vo(fr):
        torch.cuda.synchronize()
        t = time.perf_counter()
        poses, _ = pipeline.run_sequence(fr, config, intr, device=dev)
        return time.perf_counter() - t, len(fr) - 1, poses

    def buffered(fr):
        poses, _, wall = pipeline.run_sequence_buffered(fr, config, intr,
                                                        device=dev)
        return wall, len(fr) - 1, poses

    def piped(fr):
        poses, _, wall = pipe.run_sequence_pipelined(fr, config, intr,
                                                     devices=[dev, dev])
        return wall, len(fr) - 1, poses

    kw = cs.BA_SHORT
    with dispatch(True):
        _, _, _, _, snaps = pipeline.run_sequence_scan(
            straight[:kw["window"] + 1], config, intr, chunk=32,
            warmup=False, collect_tracks=True, device=dev)
        poses = pipeline.run_sequence_scan(
            straight[:kw["window"] + 1], config, intr, chunk=32,
            warmup=False, device=dev)[0]
    problem = window.build_window_problem(
        window.window_tracks(snaps, range(kw["window"])), poses[:kw["window"]],
        intr, max_landmarks=kw["max_landmarks"],
        min_track_len=kw["min_track_len"], device=dev)

    def ba(_):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = schur.ba_solve(problem, iterations=kw["iterations"],
                             huber_delta=kw["huber_delta"])
        torch.cuda.synchronize()
        return (time.perf_counter() - t, kw["iterations"],
                torch.cat([out.poses.reshape(-1),
                           out.landmarks.reshape(-1)]).cpu().numpy())

    def case(fn, per):
        def run(graphed):
            with dispatch(graphed):
                return fn(frames)

        def prof(graphed):
            with dispatch(graphed):
                return profile_run(lambda: fn(small), per)

        return run, prof, 1

    return {"vo": case(vo, PROFILE_FRAMES),
            "buffered": case(buffered, PROFILE_FRAMES),
            "pipe": case(piped, PROFILE_FRAMES),
            "ba": case(ba, kw["iterations"])}


def mesh_cases(args, full, config, intr, dev):
    """``--mesh``: {case: (run(graphed) -> (wall, steps, result),
    profile(graphed) -> profile_run's dict, batch)}."""
    import torch

    import chip_smoke as cs
    from visual_odom_tpu_torch.ba import posegraph, problem
    from visual_odom_tpu_torch.parallel.batch_eval import run_sequences_batched
    from visual_odom_tpu_torch.parallel.mesh import make_mesh
    from visual_odom_tpu_torch.parallel.ring_ba import ring_ba_solve
    from visual_odom_tpu_torch.parallel.sharded_ba import sharded_ba_solve
    from visual_odom_tpu_torch.utils.cudagraph import dispatch

    seqs = [f[:args.batch_steps + 1] for f in full]
    small = [f[:PROFILE_FRAMES + 1] for f in full]

    def mesh_run(mesh):
        def fn(sq):
            poses, _, wall = run_sequences_batched(
                sq, config, intr, chunk=len(sq[0]) - 1, mesh=mesh)
            return wall, len(sq[0]) - 1, np.stack(poses)
        return fn

    def timed(solve, per):
        def fn(_):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = solve()
            torch.cuda.synchronize()
            arrays = [getattr(out, k).reshape(-1) for k in out._fields
                      if k in ("poses", "landmarks", "nodes")]
            return (time.perf_counter() - t, per,
                    torch.cat(arrays).cpu().numpy())
        return fn

    def mode(graphed):
        """Graphed: the default on a card (graphs wherever the dispatch
        rule allows them); else eager."""
        return contextlib.nullcontext() if graphed else dispatch(False)

    def case(fn, frames, per, B):
        def run(graphed):
            with mode(graphed):
                return fn(frames)

        def prof(graphed):
            with mode(graphed):
                return profile_run(lambda: fn(small if B > 1 else frames),
                                   per)

        return run, prof, B

    grids = {"mesh_2x1_card": ((2, 1), [dev] * 2),
             "mesh_2x2_card": ((2, 2), [dev] * 4)}
    n = torch.cuda.device_count()
    cards = [torch.device("cuda", i) for i in range(n)]
    if n >= 2:
        grids["mesh_2x1_across"] = ((2, 1), cards[:2])
        grids["mesh_1x2_across"] = ((1, 2), cards[:2])
    if n >= 4:
        grids["mesh_2x2_across"] = ((2, 2), cards[:4])
    cases = {name: case(mesh_run(make_mesh(
        {"data": shape[0], "model": shape[1]}, devs)), seqs, PROFILE_FRAMES,
        len(seqs)) for name, (shape, devs) in grids.items()}
    w, lm = cs.SHARDED_BA_PROBLEMS[0]
    p = problem.synthetic_ba_problem(num_poses=w, num_landmarks=lm, seed=7,
                                     obs_window=None, device=dev)[0]
    shards = make_mesh({"data": 1, "model": cs.MODEL_SHARDS},
                       [dev] * cs.MODEL_SHARDS)
    cases["sharded_ba"] = case(timed(lambda: sharded_ba_solve(
        p, shards, iterations=cs.SHARDED_BA_ITERS), cs.SHARDED_BA_ITERS),
        None, cs.SHARDED_BA_ITERS, 1)
    ring = cs._ring_problem(dev)
    seq = make_mesh({"seq": cs.RING_WINDOWS}, [dev] * cs.RING_WINDOWS)
    cases["ring"] = case(timed(lambda: ring_ba_solve(
        ring, seq, halo=cs.RING_HALO, rounds=cs.RING_GRAPH_ROUNDS,
        cg_iters=cs.RING_CG_ITERS), cs.RING_GRAPH_ROUNDS), None,
        cs.RING_GRAPH_ROUNDS, 1)
    graph = posegraph.build_keyframe_graph(*cs._circle_chain(), device=dev)
    cases["posegraph"] = case(timed(lambda: posegraph.sharded_posegraph_solve(
        graph, shards), 10), None, 10, 1)
    # the solvers over distinct cards
    for k in (2, 4) if n >= 4 else (2,) if n >= 2 else ():
        line = make_mesh({"data": 1, "model": k}, cards[:k])
        cases[f"sharded_ba_across_{k}"] = case(timed(
            lambda line=line: sharded_ba_solve(
                p, line, iterations=cs.SHARDED_BA_ITERS),
            cs.SHARDED_BA_ITERS), None, cs.SHARDED_BA_ITERS, 1)
    if n >= cs.RING_WINDOWS:
        seq = make_mesh({"seq": cs.RING_WINDOWS}, cards[:cs.RING_WINDOWS])
        cases[f"ring_across_{cs.RING_WINDOWS}"] = case(timed(
            lambda: ring_ba_solve(ring, seq, halo=cs.RING_HALO,
                                  rounds=cs.RING_GRAPH_ROUNDS,
                                  cg_iters=cs.RING_CG_ITERS),
            cs.RING_GRAPH_ROUNDS), None, cs.RING_GRAPH_ROUNDS, 1)
    if n >= cs.MODEL_SHARDS:
        edges = make_mesh({"data": 1, "model": cs.MODEL_SHARDS},
                          cards[:cs.MODEL_SHARDS])
        cases[f"posegraph_across_{cs.MODEL_SHARDS}"] = case(timed(
            lambda: posegraph.sharded_posegraph_solve(graph, edges), 10),
            None, 10, 1)
    return cases


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=64)
    ap.add_argument("--mono-steps", type=int, default=32)
    ap.add_argument("--batch-steps", type=int, default=16)
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--doors", action="store_true")
    ap.add_argument("--mesh", action="store_true")
    ap.add_argument("--cases", nargs="+", default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("graph_turns: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from visual_odom_tpu_torch.config import VOConfig
    from visual_odom_tpu_torch.parallel.batch_eval import run_sequences_batched
    from visual_odom_tpu_torch.runner import pipeline

    dev = torch.device("cuda", 0)
    card = cs.card_line()
    n_straight = max(args.steps, args.mono_steps, args.batch_steps) + 1
    keys = cs.BATCH_COURSES[:1] if args.doors else cs.BATCH_COURSES
    courses = cs.render_courses(
        [k + ((n_straight if k == ("straight", "value")
               else args.batch_steps + 1),) for k in keys], cs.H, cs.W)
    full = [courses[k][0] for k in keys]
    config = VOConfig.for_image(cs.H, cs.W)
    mconfig = VOConfig.for_image(cs.H, cs.W, mono_rotation=True)
    intr = cs.kitti_intrinsics(cs.H, cs.W)

    def single(cfg, steps):
        frames = full[0][:steps + 1]

        def run(graphed):
            with cs.scans(graphed):
                poses, _, wall, n = pipeline.run_sequence_scan(
                    frames, cfg, intr, chunk=32, warmup=False, device=dev)
            return wall, n, poses

        return run, frames, cfg, 1

    def batched(B):
        seqs = [full[b % len(full)][:args.batch_steps + 1] for b in range(B)]

        def run(graphed):
            with cs.scans(graphed):
                poses, _, wall = run_sequences_batched(
                    seqs, config, intr, chunk=args.batch_steps, device=dev)
            return wall, args.batch_steps, np.stack(poses)

        return run, cs.stacked_frames(seqs, PROFILE_FRAMES + 2), config, B

    def scan_case(run, frames, cfg, B):
        return run, lambda g: profile_scan(frames, cfg, intr, dev, g), B

    if args.doors:
        cases = door_cases(args, full[0], config, intr, dev)
    elif args.mesh:
        cases = mesh_cases(args, full, config, intr, dev)
    else:
        cases = {"quad": scan_case(*single(config, args.steps)),
                 "mono": scan_case(*single(mconfig, args.mono_steps)),
                 **{f"b{B}": scan_case(*batched(B)) for B in (1, 4, 11)}}
    if args.cases:
        cases = {k: v for k, v in cases.items()
                 if any(c in k for c in args.cases)}
    lines = []
    for name, (run, profiler, B) in cases.items():
        refs = [run(g)[2] for g in (True, False)]   # capture, first use
        if not np.array_equal(refs[0], refs[1]):
            raise AssertionError(f"{name}: graphed and eager poses differ")
        runs = {True: [], False: []}
        for k in range(args.rounds):
            for g in ((True, False) if k % 2 == 0 else (False, True)):
                cpu = time.process_time()
                wall, n, poses = run(g)
                runs[g].append((1e3 * wall / n,
                                1e3 * (time.process_time() - cpu) / n))
                if not np.array_equal(poses, refs[0]):
                    raise AssertionError(f"{name}: a graphed={g} run's "
                                         f"poses differ")
        prof = {g: profiler(g) for g in (True, False)}
        line = {"case": name, "batch": B, "steps": n, "rounds": args.rounds,
                "card": card}
        for g, tag in ((True, "graph"), (False, "eager")):
            ms = [m for m, _ in runs[g]]
            med = float(np.median(ms))
            line[tag] = {
                "ms_per_frame": ms, "median_ms_per_frame": med,
                "frames_per_s": 1e3 * B / med,
                "median_host_cpu_ms_per_frame": float(np.median(
                    [c for _, c in runs[g]])),
                "device_ms_per_frame": prof[g]["device_ms"],
                "device_ops_per_frame": prof[g]["device_ops"],
                "device_busy_share": prof[g]["device_ms"] / med,
                "lk_kernels_per_frame": prof[g]["lk_kernels"],
                "host_runtime_calls_per_frame":
                    prof[g]["host_runtime_calls"]}
        diff = [g - e for (g, _), (e, _) in zip(runs[True], runs[False])]
        line.update(graph_minus_eager_ms=diff,
                    median_graph_minus_eager_ms=float(np.median(diff)),
                    rounds_graph_faster=sum(d < 0 for d in diff),
                    poses_graph_vs_eager=True)
        print("graph_turns", json.dumps(line), flush=True)
        lines.append(line)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        name = ("graph_turns_doors.json" if args.doors else
                "graph_turns_mesh.json" if args.mesh else "graph_turns.json")
        with open(os.path.join(args.out, name), "w") as f:
            json.dump({"cases": lines, "cpus": os.cpu_count(),
                       "card": card}, f, indent=1)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
